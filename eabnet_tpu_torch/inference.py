"""Offline enhancement with a shipped model, in PyTorch.

``load_enhancer(exp_root)`` reads ``config.json`` and the newest
``<iter>.params`` of an experiment directory written by the JAX package
(or ``args.pickle`` and the newest ``<iter>.pth`` of a reference one) and
returns an ``Enhancer``: 9-mic wav in, enhanced wav out, with either
shipped model (``release/composed_9mic``, IN; ``release/eabnet_9mic_cln``,
cLN). The model runs on ``device`` (default ``"cuda"``); on a CUDA device
the LSTM head and the causal IN TCN groups go through the hand-written
kernels, on ``"cpu"`` through their plain versions. Like the JAX
package's, the Enhancer applies params only, so batch-norm models are not
served.

``compute_dtype`` is the JAX package's: ``"float32"``; ``"bfloat16"``, the
whole model in bf16 (the kernels' bf16 variants on the card); or
``"int8w"``, weights-only int8 (``utils/quantize.py``) kept packed on the
device and dequantized to bf16 inside each call. The STFT front end and
the iSTFT run in float32 in every mode.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np
import torch
from torch.func import functional_call

from eabnet_tpu_torch.checkpoint import latest_checkpoint, load_params
from eabnet_tpu_torch.config import ExperimentConfig
from eabnet_tpu_torch.dsp import prepare_data, stft_to_wav
from eabnet_tpu_torch.models import build_model
from eabnet_tpu_torch.models.eabnet import to_reference_layout
from eabnet_tpu_torch.utils.audio_io import read_wav, resample, write_wav
from eabnet_tpu_torch.utils.precision import float32_products
from eabnet_tpu_torch.utils.quantize import (PackedWeights, pack_for_module,
                                             quantize_weights_int8)
from eabnet_tpu_torch.weights import load_jax_params

COMPUTE_DTYPES = ("float32", "bfloat16", "int8w")


class Enhancer:
    """wav (M, N) -> enhanced wav (N,).

    Inputs are zero-padded up to a length bucket (``bucket_seconds``), with
    a guaranteed zero tail of n_fft/2 + 1 samples first unless ``pad_mode``
    is ``"reference"``, as the JAX package's Enhancer does. ``output``
    picks the stage: ``"esti"`` (beamformer + post-filter) or ``"esti0"``
    (beamformer alone). ``compute_dtype``: see the module doc; in
    ``"int8w"`` the model's own parameters live on the meta device and the
    packed ones (``self.packed``) on ``device``.
    """

    def __init__(self, cfg: ExperimentConfig, params: dict,
                 bucket_seconds: float = 1.0, output: str = "esti",
                 compute_dtype: str = "float32", mesh=None,
                 shard_freq: bool = False, pad_mode: str = "tail",
                 device: str = "cuda"):
        if output not in ("esti", "esti0"):
            raise ValueError(f"output must be 'esti' or 'esti0', "
                             f"got {output!r}")
        if pad_mode not in ("tail", "reference"):
            raise ValueError(f"pad_mode must be 'tail' or 'reference', "
                             f"got {pad_mode!r}")
        if compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(f"compute_dtype must be one of {COMPUTE_DTYPES}, "
                             f"got {compute_dtype!r}")
        if mesh is not None or shard_freq:
            raise NotImplementedError(
                "mesh / shard_freq: multi-card serving is a later slice of "
                "the port")
        if "BN" in (cfg.model.eabnet.norm_type, cfg.model.gagnet.norm_type):
            raise NotImplementedError(
                "norm_type='BN': the Enhancer applies params only, as the "
                "JAX package's does, and has no running statistics to serve "
                "a batch-norm model with")
        self.cfg = cfg
        self.output = output
        self.pad_mode = pad_mode
        self.device = torch.device(device)
        self.bucket = max(1, int(bucket_seconds * cfg.stft.sr))
        self.compute_dtype = compute_dtype
        self.dtype = (torch.float32 if compute_dtype == "float32"
                      else torch.bfloat16)
        self.packed = None
        if compute_dtype == "int8w":
            self.model = build_model(cfg.model).to("meta").eval()
            self.packed = PackedWeights(pack_for_module(
                self.model, quantize_weights_int8(params)), self.device)
        else:
            self.model = load_jax_params(build_model(cfg.model), params)
            self.model.to(self.device, self.dtype).eval()

    def param_bytes(self) -> int:
        """Bytes of the parameters resident on ``device``: the model's in
        float32 and bfloat16, the packed values and scales in int8w."""
        if self.packed is not None:
            return self.packed.nbytes()
        return sum(p.nbytes for p in self.model.parameters())

    @torch.no_grad()
    def enhance_tensor(self, batch: torch.Tensor) -> torch.Tensor:
        """(B, M, N) padded waveforms on ``self.device`` -> (B, N), with
        float32 products on the card (``float32_products``)."""
        with float32_products(batch.device):
            return self._enhance(batch)

    def _enhance(self, batch: torch.Tensor) -> torch.Tensor:
        noisy_stft, _ = prepare_data(batch, None, self.cfg.stft)
        noisy_stft = noisy_stft.to(self.dtype)
        if self.packed is not None:
            # no parameter is tied, so the tied-weight search is skipped
            out = functional_call(self.model, self.packed.dequantize(
                self.dtype), (noisy_stft,), tie_weights=False)
        else:
            out = self.model(noisy_stft)
        esti = out[self.output].float()
        return stft_to_wav(to_reference_layout(esti), self.cfg.stft)

    def __call__(self, noisy: np.ndarray,
                 mic_permutation: Optional[list] = None) -> np.ndarray:
        return self.enhance_batch([noisy], mic_permutation)[0]

    def enhance_batch(self, wavs, mic_permutation: Optional[list] = None
                      ) -> List[np.ndarray]:
        """Enhance a list of (M, N_i) wavs as one batch; each output is
        trimmed back to its item's length."""
        if not wavs:
            return []
        mics = {w.shape[0] for w in wavs}
        if len(mics) != 1:
            raise ValueError(
                f"all items in a batch must share a mic count, got {mics}")
        if mic_permutation is not None:
            idx = np.asarray(mic_permutation)
            (m,) = mics
            if idx.ndim != 1 or idx.size == 0 or idx.min() < 0 \
                    or idx.max() >= m:
                raise ValueError(f"mic_permutation {mic_permutation} out of "
                                 f"range for {m}-mic input")
            wavs = [w[idx] for w in wavs]
        lengths = [w.shape[-1] for w in wavs]
        tail = 0 if self.pad_mode == "reference" \
            else self.cfg.stft.fft_num // 2 + 1
        padded = -(-(max(lengths) + tail) // self.bucket) * self.bucket
        batch = np.stack([np.pad(w, ((0, 0), (0, padded - w.shape[-1])))
                          for w in wavs]).astype(np.float32)
        out = self.enhance_tensor(torch.from_numpy(batch).to(self.device))
        out = out.cpu().numpy()
        return [out[i][:n] for i, n in enumerate(lengths)]

    def _read(self, path: str) -> np.ndarray:
        sr, noisy = read_wav(path)
        if noisy.ndim == 1:
            noisy = noisy[None]
        if sr != self.cfg.stft.sr:
            noisy = resample(noisy, sr, self.cfg.stft.sr)
        return noisy

    def enhance_files(self, in_paths, out_paths,
                      mic_permutation: Optional[list] = None,
                      batch_size: int = 1) -> None:
        """Enhance many files in batches of ``batch_size``."""
        if len(in_paths) != len(out_paths):
            raise ValueError("in_paths and out_paths must align")
        for lo in range(0, len(in_paths), batch_size):
            outs = self.enhance_batch(
                [self._read(p) for p in in_paths[lo:lo + batch_size]],
                mic_permutation)
            for path, wav in zip(out_paths[lo:lo + batch_size], outs):
                write_wav(path, self.cfg.stft.sr, wav, dtype="float")

    def enhance_file(self, in_path: str, out_path: str,
                     mic_permutation: Optional[list] = None) -> None:
        self.enhance_files([in_path], [out_path], mic_permutation)


def load_enhancer(exp_root: str, checkpoint: Optional[str] = None,
                  output: str = "esti", compute_dtype: str = "float32",
                  mesh=None, shard_freq: bool = False,
                  device: str = "cuda") -> Enhancer:
    """Build an Enhancer from an experiment directory, the JAX package's
    (``config.json`` and the newest checkpoint) or a reference one
    (``args.pickle`` and the newest ``<iter>.pth``,
    ``utils/convert_args.py``), or from an explicit checkpoint path."""
    if os.path.exists(os.path.join(exp_root, "config.json")):
        cfg = ExperimentConfig.load(os.path.join(exp_root, "config.json"))
    elif os.path.exists(os.path.join(exp_root, "args.pickle")):
        from eabnet_tpu_torch.utils.convert_args import \
            load_reference_experiment

        cfg = load_reference_experiment(exp_root)
    else:
        raise FileNotFoundError(
            f"no config.json or args.pickle under {exp_root}")
    ckpt_dir = cfg.train.checkpoint_dir
    if not os.path.isabs(ckpt_dir):
        ckpt_dir = os.path.join(exp_root, os.path.basename(ckpt_dir))
    ckpt = checkpoint or latest_checkpoint(ckpt_dir) \
        or latest_checkpoint(exp_root)
    if ckpt is None:
        raise FileNotFoundError(f"no checkpoint found under {exp_root}")
    return Enhancer(cfg, load_params(ckpt, cfg.model), output=output,
                    compute_dtype=compute_dtype, mesh=mesh,
                    shard_freq=shard_freq, device=device)
