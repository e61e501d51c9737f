"""The train and eval steps of the composed model, in PyTorch.

The semantics of the JAX package's ``make_train_step`` / ``make_eval_step``
for batches of waveforms: STFT features, the model with ``train=True``,
the composite loss on ``final`` under the per-item frame mask, gradients,
clip by global norm, Adam. The optimizer is written out over the model's
named parameters, as optax's ``chain(clip_by_global_norm(c), adam(lr))``
computes it, so its state maps one to one onto the JAX checkpoint
(count, mu, nu). Parameters are updated in place. The train step runs the
model in training mode, where batch norms normalise with the batch's
statistics and move their running ones (the buffers that the checkpoint
writes as ``batch_stats``); the eval step reads them in evaluation mode.

``train.compute_dtype = "bfloat16"`` is the JAX package's mixed
precision: the features are made in float32 and cast to bf16, the float32
parameters are cast to bf16 inside the differentiated function, all in
one launch (so their gradients come back through the cast in float32),
every model output is cast to float32 before the mask and the loss, and
clipping and Adam run in float32 on float32 state. The batch norms' running statistics stay
float32 buffers, as flax keeps ``batch_stats``. The eval step runs in
float32, as the JAX package's does.

Inside a ``torch.distributed`` process group (of any size) the train step
is one rank's part of a data-parallel step over the global batch, the
rows of every rank together, with the JAX package's semantics under a
mesh. Each rank all-reduces the loss mask's frame count first and
divides its loss by the global count, so its loss is its share of the
global batch's (a mean of the ranks' means would weigh the frames of a
rank with fewer of them more). One all-reduce (sum) of a flat float32
buffer then gathers the gradients and the losses before clipping and
Adam: clipping sees the global norm, every rank applies the same update,
and the returned losses are the global batch's. Batch norms take the
global batch's statistics (``nn/norms.py``). The wav step first pads its
rows to the longest of the global batch, as one process's collation
would. The model is not wrapped in ``DistributedDataParallel``, whose
gradient is the mean of the ranks' means and whose forward broadcasts
buffers.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from eabnet_tpu_torch.config import ExperimentConfig
from eabnet_tpu_torch.dsp import prepare_data
from eabnet_tpu_torch.losses import eabnet_with_postnet_loss, frame_mask
from eabnet_tpu_torch.models import build_model
from eabnet_tpu_torch.models.eabnet import from_reference_layout
from eabnet_tpu_torch.parallel.mesh import all_reduced, in_group
from eabnet_tpu_torch.utils.quantize import flat_views

B1, B2, EPS = 0.9, 0.999, 1e-8  # optax.adam's defaults (eps_root = 0)
_COUNT_MAX = 2 ** 31 - 1         # optax's int32 count saturates here


@dataclass
class AdamState:
    """optax ``ScaleByAdamState``: the step count and both moments, keyed
    by parameter name, in the module's layout."""

    count: int
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


@dataclass
class TrainState:
    step: int
    model: nn.Module
    opt_state: AdamState


def adam_init(model: nn.Module) -> AdamState:
    zeros = {n: torch.zeros_like(p) for n, p in model.named_parameters()}
    return AdamState(0, zeros, {n: torch.zeros_like(p)
                                for n, p in model.named_parameters()})


def create_train_state(cfg: ExperimentConfig, device="cuda",
                       seed: Optional[int] = None) -> TrainState:
    """A freshly initialised model on ``device`` (the JAX package's
    initialisers drawn under ``torch.manual_seed(seed)``, default
    ``cfg.train.seed``, without touching the caller's random state) and a
    fresh optimizer."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(cfg.train.seed if seed is None else seed)
        model = build_model(cfg.model)
    model.to(device)
    return TrainState(0, model, adam_init(model))


def clip_by_global_norm(grads: Dict[str, torch.Tensor], max_norm: float
                        ) -> Dict[str, torch.Tensor]:
    """optax's rule: g unchanged if ||g|| < max_norm, else g / ||g|| *
    max_norm (no epsilon, unlike ``torch.nn.utils.clip_grad_norm_``)."""
    flat = torch.cat([g.reshape(-1) for g in grads.values()])
    norm = torch.sqrt(torch.sum(flat * flat))
    if norm < max_norm:
        return grads
    scaled = torch._foreach_mul(torch._foreach_div(list(grads.values()),
                                                   norm), max_norm)
    return dict(zip(grads, scaled))


def adam_update(grads: Dict[str, torch.Tensor], state: AdamState, lr: float
                ) -> Dict[str, torch.Tensor]:
    """One optax Adam step, in float32 as optax takes it, elementwise
    over all parameters at once (``torch._foreach_*``); updates ``state``
    in place and returns the updates (to be added to the parameters)."""
    count = min(state.count + 1, _COUNT_MAX)
    names = list(grads)
    g = [grads[n] for n in names]
    c = torch.tensor(float(count), dtype=torch.float32)
    bc1 = (1 - torch.tensor(B1, dtype=torch.float32) ** c).item()
    bc2 = (1 - torch.tensor(B2, dtype=torch.float32) ** c).item()
    mu = torch._foreach_add(torch._foreach_mul(g, 1 - B1),
                            torch._foreach_mul([state.mu[n] for n in names],
                                               B1))
    nu = torch._foreach_add(torch._foreach_mul(torch._foreach_mul(g, g),
                                               1 - B2),
                            torch._foreach_mul([state.nu[n] for n in names],
                                               B2))
    den = torch._foreach_sqrt(torch._foreach_div(nu, bc2))
    torch._foreach_add_(den, EPS)
    upd = torch._foreach_div(torch._foreach_div(mu, bc1), den)
    torch._foreach_mul_(upd, -lr)
    state.mu, state.nu = dict(zip(names, mu)), dict(zip(names, nu))
    state.count = count
    return dict(zip(names, upd))


def _dequant(wav: torch.Tensor) -> torch.Tensor:
    """int16 transport batches -> float on the device (x / 32768, as
    ``read_wav`` converts)."""
    if wav.dtype == torch.int16:
        return wav.to(torch.float32) / 32768.0
    return wav


def _valid_frames(n_samples: torch.Tensor, total_frames: int,
                  cfg: ExperimentConfig, total_samples: int) -> torch.Tensor:
    """(B,) true sample counts -> (B,) loss-mask frame counts: items at the
    batch's full length keep every frame; shorter ones only frames whose
    analysis window lies inside their samples."""
    n = n_samples.to(torch.int64)
    hop, win = cfg.stft.hop_samples, cfg.stft.win_samples
    full = 1 + torch.div(n, hop, rounding_mode="floor")
    supported = 1 + torch.div(torch.clamp(n - win, min=0), hop,
                              rounding_mode="floor")
    frames = torch.where(n >= total_samples, full, supported)
    return torch.clamp(frames, max=total_frames)


_COMPUTE = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _float32(tree):
    """Every tensor of a nest of dicts, lists and tuples cast to float32."""
    if isinstance(tree, dict):
        return {k: _float32(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_float32(v) for v in tree)
    return tree.float()


def _cast_parameters(model: nn.Module, dtype: torch.dtype) -> dict:
    """{name: the parameter in dtype}, all cast in one launch: the float32
    parameters joined into one flat tensor, cast, and cut into views. The
    join and the cut are recorded by autograd, so each parameter's
    gradient comes back through the cast in float32."""
    params = dict(model.named_parameters())
    flat = torch.cat([p.reshape(-1) for p in params.values()]).to(dtype)
    return dict(zip(params, flat_views(
        flat, [tuple(p.shape) for p in params.values()])))


def global_frames(local: torch.Tensor) -> torch.Tensor:
    """The valid frames of the global batch: the sum over the group's
    ranks of each rank's count ``local``."""
    return all_reduced(local.float())


def _pad_to_global(noisy_wav, target_wav, n_samples):
    """A rank's rows zero-padded to the longest rows of the global batch
    (its length all-reduced by max), with their true lengths: the rows a
    single process would have cut from the collated global batch."""
    n = noisy_wav.shape[-1]
    if n_samples is None:
        n_samples = torch.full((noisy_wav.shape[0],), n, dtype=torch.int32)
    pad = int(all_reduced(torch.tensor([n]), dist.ReduceOp.MAX)) - n
    if pad:
        noisy_wav = F.pad(noisy_wav, (0, pad))
        target_wav = F.pad(target_wav, (0, pad))
    return noisy_wav, target_wav, n_samples


def _all_reduce_step(grads: Dict[str, torch.Tensor],
                     losses: Dict[str, torch.Tensor]):
    """The gradients and the losses summed over the group's ranks, in one
    all-reduce of one flat float32 buffer."""
    names, keys = list(grads), list(losses)
    flat = torch.cat([grads[n].reshape(-1) for n in names]
                     + [torch.stack([losses[k].detach() for k in keys])])
    views = flat_views(all_reduced(flat),
                       [tuple(grads[n].shape) for n in names]
                       + [(len(keys),)])
    return dict(zip(names, views)), dict(zip(keys, views[-1].unbind()))


def _forward_losses(model, cfg, noisy_wav, target_wav, n_samples,
                    compute=torch.float32, reduce_frames=None):
    """-> (losses, model output); ``reduce_frames`` maps the batch's count
    of valid frames to the count the losses divide by."""
    noisy_wav, target_wav = _dequant(noisy_wav), _dequant(target_wav)
    if n_samples is None:
        n_samples = torch.full((noisy_wav.shape[0],), noisy_wav.shape[-1],
                               dtype=torch.int32, device=noisy_wav.device)
    noisy_stft, target_stft = prepare_data(noisy_wav, target_wav, cfg.stft)
    t = noisy_stft.shape[1]
    mask = frame_mask(_valid_frames(n_samples.to(noisy_wav.device), t, cfg,
                                    noisy_wav.shape[-1]), t)
    frames = None if reduce_frames is None else reduce_frames(mask.sum())
    if compute == torch.float32:
        out = model(noisy_stft)
    else:  # mixed precision: the casts are inside what autograd records
        out = _float32(torch.func.functional_call(
            model, _cast_parameters(model, compute),
            (noisy_stft.to(compute),)))
    losses = eabnet_with_postnet_loss(
        out, from_reference_layout(target_stft), mask, frames)
    return losses, out


def make_train_step(cfg: ExperimentConfig, batch_kind: str = "wav",
                    scene_dims: Optional[Dict[str, int]] = None
                    ) -> Callable:
    """-> ``train_step(state, noisy_wav (B, M, N), target_wav (B, N),
    n_samples (B,) or None) -> (state, {eabnet, postnet, final})``, the
    losses as 0-d tensors before the update. Under
    ``cfg.model.freeze_eabnet`` the gradients and the updates of the
    ``eabnet`` parameters are zeroed; their Adam moments still decay.
    ``cfg.train.compute_dtype`` picks float32 or bf16 mixed precision
    (module doc).

    ``batch_kind`` "parts" takes ``train_step(state, batch)``, a collated
    parts dict on the device (``data/device_mix.py``); "scene" takes
    ``train_step(state, batch, corpus_speech, corpus_noise)``, a collated
    scene dict and the resident int16 corpus (``data/scene_mix.py``, with
    ``scene_dims``). Both mix the batch in float32 without gradients and
    then take the wav step on it, as the JAX package's fused steps do.
    Made inside a process group, the step is that rank's part of a
    data-parallel step (module doc)."""
    if batch_kind == "scene" and scene_dims is None:
        raise ValueError("batch_kind='scene' needs scene_dims")
    if batch_kind not in ("wav", "parts", "scene"):
        raise ValueError(f"unknown batch_kind {batch_kind!r}")
    frozen = "eabnet." if cfg.model.freeze_eabnet else None
    compute = _COMPUTE[cfg.train.compute_dtype]
    parallel = in_group()

    def rows_step(state: TrainState, noisy_wav, target_wav, n_samples):
        model = state.model
        model.train()
        params = dict(model.named_parameters())
        for p in params.values():
            p.grad = None
        with torch.enable_grad():
            losses, _ = _forward_losses(
                model, cfg, noisy_wav, target_wav, n_samples, compute,
                global_frames if parallel else None)
            losses["final"].backward()
        grads = {n: (torch.zeros_like(p) if p.grad is None
                     or (frozen and n.startswith(frozen)) else p.grad)
                 for n, p in params.items()}
        if parallel:
            grads, losses = _all_reduce_step(grads, losses)
        grads = clip_by_global_norm(grads, cfg.train.grad_clip)
        updates = adam_update(grads, state.opt_state, cfg.train.lr)
        with torch.no_grad():
            live = [n for n in params if not (frozen and n.startswith(frozen))]
            torch._foreach_add_([params[n] for n in live],
                                [updates[n] for n in live])
            for p in params.values():
                p.grad = None
        state.step += 1
        return state, {k: v.detach() for k, v in losses.items()}

    def train_step(state: TrainState, noisy_wav, target_wav,
                   n_samples=None):
        if parallel:
            noisy_wav, target_wav, n_samples = _pad_to_global(
                noisy_wav, target_wav, n_samples)
        return rows_step(state, noisy_wav, target_wav, n_samples)

    if batch_kind == "parts":
        from eabnet_tpu_torch.data.device_mix import mix_parts

        def parts_step(state: TrainState, batch):
            with torch.no_grad():
                noisy, target = mix_parts(batch, batch["sources"].shape[-1])
            return rows_step(state, noisy, target, batch["lengths"])

        return parts_step
    if batch_kind == "scene":
        from eabnet_tpu_torch.data.scene_mix import mix_scene

        def scene_step(state: TrainState, batch, corpus_speech,
                       corpus_noise):
            with torch.no_grad():
                noisy, target = mix_scene(batch, corpus_speech,
                                          corpus_noise, scene_dims)
            return rows_step(state, noisy, target, batch["lengths"])

        return scene_step
    return train_step


def make_eval_step(cfg: ExperimentConfig) -> Callable:
    """-> ``eval_step(state, noisy_wav, target_wav, n_samples=None) ->
    (losses, esti (B, T, F, 2))`` without gradients."""

    @torch.no_grad()
    def eval_step(state: TrainState, noisy_wav, target_wav,
                  n_samples=None):
        state.model.eval()
        losses, out = _forward_losses(state.model, cfg, noisy_wav,
                                      target_wav, n_samples)
        return losses, out["esti"]

    return eval_step

