"""The train and eval steps of the composed model, in PyTorch.

The semantics of the JAX package's ``make_train_step`` / ``make_eval_step``
for batches of waveforms: STFT features, the model with ``train=True``,
the composite loss on ``final`` under the per-item frame mask, gradients,
clip by global norm, Adam. The optimizer is written out over the model's
named parameters, as optax's ``chain(clip_by_global_norm(c), adam(lr))``
computes it, so its state maps one to one onto the JAX checkpoint
(count, mu, nu). Parameters are updated in place.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch
from torch import nn

from eabnet_tpu_torch.config import ExperimentConfig
from eabnet_tpu_torch.dsp import prepare_data
from eabnet_tpu_torch.losses import eabnet_with_postnet_loss, frame_mask
from eabnet_tpu_torch.models import build_model
from eabnet_tpu_torch.models.eabnet import from_reference_layout

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
    """A freshly initialised model on ``device`` (PyTorch's initialisers
    under ``torch.manual_seed(seed)``, default ``cfg.train.seed``, without
    touching the caller's random state) and a fresh optimizer."""
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


def _forward_losses(model, cfg, noisy_wav, target_wav, n_samples):
    noisy_wav, target_wav = _dequant(noisy_wav), _dequant(target_wav)
    if n_samples is None:
        n_samples = torch.full((noisy_wav.shape[0],), noisy_wav.shape[-1],
                               dtype=torch.int32, device=noisy_wav.device)
    noisy_stft, target_stft = prepare_data(noisy_wav, target_wav, cfg.stft)
    out = model(noisy_stft)
    t = noisy_stft.shape[1]
    mask = frame_mask(_valid_frames(n_samples.to(noisy_wav.device), t, cfg,
                                    noisy_wav.shape[-1]), t)
    losses = eabnet_with_postnet_loss(
        out, from_reference_layout(target_stft), mask)
    return losses, out


def make_train_step(cfg: ExperimentConfig) -> Callable:
    """-> ``train_step(state, noisy_wav (B, M, N), target_wav (B, N),
    n_samples (B,) or None) -> (state, {eabnet, postnet, final})``, the
    losses as 0-d tensors before the update. Under
    ``cfg.model.freeze_eabnet`` the gradients and the updates of the
    ``eabnet`` parameters are zeroed; their Adam moments still decay."""
    frozen = "eabnet." if cfg.model.freeze_eabnet else None

    def train_step(state: TrainState, noisy_wav, target_wav,
                   n_samples=None):
        model = state.model
        model.train()
        params = dict(model.named_parameters())
        for p in params.values():
            p.grad = None
        with torch.enable_grad():
            losses, _ = _forward_losses(model, cfg, noisy_wav, target_wav,
                                        n_samples)
            losses["final"].backward()
        grads = {n: (torch.zeros_like(p) if p.grad is None
                     or (frozen and n.startswith(frozen)) else p.grad)
                 for n, p in params.items()}
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

