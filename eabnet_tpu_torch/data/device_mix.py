"""Room propagation of online synthesis on the device, the port's own copy
of the JAX package's ``data/device_mix.py``.

Host workers make the *parts* of an item, the dry scaled sources and their
RIRs (``synthesize_item_parts``, numpy, the same draws as
``synthesize_item``); the device does the FFT convolutions for the whole
batch at once (``mix_parts``, torch):

    noisy[b,m] = irfft( sum_s rfft(src[b,s]) * rfft(rir[b,s,m]) )
    clean[b]   = irfft( rfft(src[b,0]) * rfft(h_direct[b]) )

at one power-of-two FFT length that covers the linear convolution. The
fused ``parts`` train step calls ``mix_parts`` on the batch's device;
``device_mix_batch`` is the loader-level mode, which mixes on the loader's
device and returns numpy arrays. torch is imported only by the device half,
so the loader's workers never load it.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from eabnet_tpu_torch.data.rir import direct_path_rir
from eabnet_tpu_torch.data.rir_native import resolve_rir_fn as _resolve_rir_fn


def _fft_length(n: int) -> int:
    """The smallest power of two >= n (the JAX package's FFT length)."""
    nfft = 1
    while nfft < n:
        nfft *= 2
    return nfft


def mix_parts(batch, n: int):
    """Room propagation of a collated parts batch on the batch's device.

    ``batch`` (torch tensors): sources (B, S, n) float32 or int16, rirs
    (B, S, M, L) float32 or int16, h_direct (B, L) float32, and with the
    int16 transport the per-signal scales src_scale (B, S) and rir_scale
    (B, S, M) (``collate_parts(quantize=True)``). -> (noisy (B, M, n),
    clean (B, n)), float32."""
    import torch

    sources = batch["sources"]
    rirs = batch["rirs"]
    if sources.dtype == torch.int16:
        sources = sources.to(torch.float32) * (
            batch["src_scale"][:, :, None] / 32767.0)
    if rirs.dtype == torch.int16:
        rirs = rirs.to(torch.float32) * (
            batch["rir_scale"][:, :, :, None] / 32767.0)
    nfft = _fft_length(n + rirs.shape[-1] - 1)
    s_f = torch.fft.rfft(sources, nfft, dim=-1)               # (B, S, F)
    h_f = torch.fft.rfft(rirs, nfft, dim=-1)                  # (B, S, M, F)
    acc = (s_f[:, :, None] * h_f).sum(dim=1)                  # (B, M, F)
    noisy = torch.fft.irfft(acc, nfft, dim=-1)[..., :n]
    d_f = torch.fft.rfft(batch["h_direct"], nfft, dim=-1)     # (B, F)
    clean = torch.fft.irfft(s_f[:, 0] * d_f, nfft, dim=-1)[..., :n]
    return noisy.to(torch.float32), clean.to(torch.float32)


def synthesize_item_parts(
    opt: Dict,
    clip_seconds: Optional[float],
    speech_path: str,
    noise_paths: Sequence[str],
    seed: int,
    rir_backend: str = "auto",
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host half of online synthesis: everything but the convolutions.

    Returns (sources (S, n) dry scaled signals, the speech first, rirs
    (S, M, L), h_direct (L2,)) for one scene, with ``synthesize_item``'s
    draws in its order, so the same seed gives the same scene and RIRs."""
    from eabnet_tpu_torch.data.datasets import (_read_noise_names,
                                                load_and_crop)
    from eabnet_tpu_torch.data.mixer import mix_at_snr
    from eabnet_tpu_torch.data.scenes import sample_scene

    rng = np.random.default_rng(seed)
    fs = int(opt["audio"]["fs"])

    names = _read_noise_names(opt, noise_paths, rng)
    scene = sample_scene(opt, rng, n_noises_override=len(names))
    scene.noise_names = [os.path.basename(p) for p in names]
    scene.speech_name = os.path.basename(speech_path)

    clean = load_and_crop(speech_path, fs, clip_seconds, rng)
    noises = [
        load_and_crop(p, fs, clip_seconds if clip_seconds else
                      len(clean) / fs, rng)
        for p in names
    ]
    clean_dry, noises_dry = mix_at_snr(
        clean, noises, scene.snrs_db, scene.dbfs, fs
    )

    rir_fn = _resolve_rir_fn(rir_backend)
    p_mics = np.asarray(scene.p_mics, np.float64)
    srcs = [(scene.p_target, clean_dry)] + [
        (p, s) for p, s in zip(scene.p_noises, noises_dry)
    ]
    rirs = [
        rir_fn(scene.room_dim, p_src, p_mics, scene.e_absorption,
               scene.max_order, fs, method=scene.rir_method,
               rt60=scene.rt60, rng=rng)
        for p_src, _ in srcs
    ]
    h_direct = direct_path_rir(scene.p_target, p_mics[scene.ref_mic], fs)
    sources = np.stack([s for _, s in srcs]).astype(np.float32)
    l_max = max(h.shape[1] for h in rirs)
    rir_arr = np.zeros((len(rirs), p_mics.shape[0], l_max), np.float32)
    for i, h in enumerate(rirs):
        rir_arr[i, :, : h.shape[1]] = h
    return sources, rir_arr, h_direct.astype(np.float32)


def collate_parts(
    parts: Sequence[Tuple[np.ndarray, np.ndarray, np.ndarray]],
    s_max: int = 6,
    rir_bucket: int = 4000,
    rir_pad: int = 0,
    quantize: bool = False,
) -> Dict[str, np.ndarray]:
    """Collate per-item parts into the fixed-shape batch ``mix_parts``
    takes: sources padded to ``s_max``, RIRs zero-padded to a multiple of
    ``rir_bucket`` samples, or to exactly ``rir_pad`` when given (one shape
    for a whole run). ``quantize`` ships sources and RIRs as int16 with
    per-source / per-(source, mic) float scales."""
    b = len(parts)
    n = max(p[0].shape[1] for p in parts)
    m = parts[0][1].shape[1]
    l_rir = max(max(p[1].shape[2] for p in parts),
                max(p[2].shape[0] for p in parts))
    if rir_pad:
        if l_rir > rir_pad:
            raise ValueError(
                f"rir_pad={rir_pad} shorter than a rendered RIR ({l_rir} "
                "samples); raise rir_pad (it must cover 1.25*rt60_max "
                "plus the max propagation delay)")
        l_rir = rir_pad
    else:
        l_rir = ((l_rir + rir_bucket - 1) // rir_bucket) * rir_bucket

    sources = np.zeros((b, s_max, n), np.float32)
    rirs = np.zeros((b, s_max, m, l_rir), np.float32)
    h_direct = np.zeros((b, l_rir), np.float32)
    for i, (src, rr, hd) in enumerate(parts):
        s = min(src.shape[0], s_max)
        sources[i, :s, : src.shape[1]] = src[:s]
        rirs[i, :s, :, : rr.shape[2]] = rr[:s]
        h_direct[i, : hd.shape[0]] = hd
    batch = {"h_direct": h_direct,
             "lengths": np.full((b,), n, np.int32)}
    if not quantize:
        batch["sources"] = sources
        batch["rirs"] = rirs
        return batch
    src_scale = np.abs(sources).max(axis=-1)            # (B,S)
    rir_scale = np.abs(rirs).max(axis=-1)               # (B,S,M)
    with np.errstate(divide="ignore", invalid="ignore"):
        sq = np.where(src_scale[:, :, None] > 0,
                      sources / src_scale[:, :, None], 0.0)
        rq = np.where(rir_scale[:, :, :, None] > 0,
                      rirs / rir_scale[:, :, :, None], 0.0)
    batch["sources"] = np.round(sq * 32767.0).astype(np.int16)
    batch["src_scale"] = src_scale.astype(np.float32)
    batch["rirs"] = np.round(rq * 32767.0).astype(np.int16)
    batch["rir_scale"] = rir_scale.astype(np.float32)
    return batch


def batch_to_device(batch: Dict[str, np.ndarray], device,
                    host_keys=("tail_seeds",)):
    """A collated numpy batch dict -> torch tensors on ``device``; the keys
    in ``host_keys`` stay numpy arrays on the host."""
    import torch

    return {k: v if k in host_keys else torch.from_numpy(v).to(device)
            for k, v in batch.items()}


def device_mix_batch(
    parts: Sequence[Tuple[np.ndarray, np.ndarray, np.ndarray]],
    s_max: int = 6,
    rir_bucket: int = 4000,
    device="cuda",
) -> Tuple[np.ndarray, np.ndarray]:
    """Collate per-item parts and propagate the batch on ``device`` (the
    loader-level mode) -> (noisy (B, M, n), clean (B, n)) numpy float32."""
    import torch

    batch = batch_to_device(
        collate_parts(parts, s_max=s_max, rir_bucket=rir_bucket), device)
    with torch.no_grad():
        noisy, clean = mix_parts(batch, batch["sources"].shape[-1])
    return noisy.cpu().numpy(), clean.cpu().numpy()
