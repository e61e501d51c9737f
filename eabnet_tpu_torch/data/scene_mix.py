"""Scene-parameter online synthesis: ship room acoustics, not audio (the
port's own copy of the JAX package's ``data/scene_mix.py``).

A training scene is described by a few KB of parameters, and the
speech/noise corpus is small enough to stay in device memory. Host workers
do the cheap host work (numpy, the same draws in the same order as
``synthesize_item``, so the same seed gives the same rooms, crops and
gains): scene sampling, gains, the image-source (delay, amplitude) lists
(M, K=63 per source), the exact late-field energy histogram and a tail
seed per source. The train step rebuilds the RIRs and mixes on the device
(torch) against the resident int16 corpus:

- early RIR: Hann-windowed-sinc fractional-delay filters placed at the
  image delays (``rir.py::ism_early_rir``'s construction), written as a
  sum over the images per output sample, so it has no atomics and gives
  the same bits on every run;
- late field: per-bin unit-energy Gaussian carriers times the histogram
  amplitudes (``rir.py::histogram_tail``), each (item, source) carrier
  drawn by a ``torch.Generator`` on the device seeded with its
  ``tail_seeds`` entry. The carrier sample differs from the host's and
  from the JAX package's (each draws its own); the per-bin energy is
  exact, so the distribution is the host's;
- mix: one batched rFFT convolution; the clean target is the direct path
  at the reference mic.

The JAX package's docstring claims ~2.6 MB of scene parameters a step
against ~28 MB of float32 audio at batch 16 (``chip_smoke.py``'s online
phase measures both). torch is imported only by the device half.
"""

from __future__ import annotations

import math
import os
from typing import Dict, List, Sequence

import numpy as np

from eabnet_tpu_torch.data.rir import (FDL, HIST_BIN_S, SPEED_OF_SOUND,
                                       ism_energy_histogram,
                                       ism_image_params, resolve_rir_method)
from eabnet_tpu_torch.data.device_mix import _fft_length

__all__ = [
    "scene_static_dims",
    "synthesize_item_scene",
    "collate_scenes",
    "load_corpus_int16",
    "scene_early_rirs",
    "scene_tails",
    "mix_scene",
]


def _ceil64(x: float) -> int:
    return int(math.ceil(x / 64.0)) * 64


def scene_static_dims(opt: Dict, clip_seconds: float) -> Dict[str, int]:
    """Static shapes implied by a settings JSON — one jit signature per
    (settings, clip) pair, so a whole run compiles the train step once.

    Keys: n (clip samples), s_max (1 speech + max noises), k_images
    (order-3 image count, geometry-independent), n_bins (late-field
    histogram bins at the rt60 ceiling), spb (samples per bin),
    early_pad (dense early-RIR buffer), l_direct (direct-path buffer),
    l_rir (full reconstructed RIR length).
    """
    from eabnet_tpu_torch.data.rir import _image_sources

    fs = int(opt["audio"]["fs"])
    c = SPEED_OF_SOUND
    n = int(round(fs * clip_seconds))
    s_max = 1 + int(opt["noise"]["n"][1])
    k_images = int(
        _image_sources(np.zeros(3), np.ones(3), 3)[0].shape[0]
    )
    rt60_hi = float(opt["room"]["rt60"][1])
    t_max = min(max(1.25 * rt60_hi, HIST_BIN_S), 2.0)
    n_bins = int(math.ceil(t_max / HIST_BIN_S))
    true_spb = HIST_BIN_S * fs
    if abs(true_spb - round(true_spb)) > 1e-9:
        raise ValueError(
            f"scene mode needs integral samples per histogram bin; "
            f"fs={fs} gives {true_spb}")
    spb = int(round(true_spb))
    # order-3 image coords span [-5L, 5L] per axis (|2 r L ± src| with
    # |r| <= 2, src in [0, L]); a mic sits in [0, L], so the worst
    # image-to-mic distance is ||6 * room_max|| (collate_scenes validates
    # per batch, so an envelope violation fails loudly instead of
    # silently clipping far images)
    hi = np.asarray(opt["room"]["max_dim"], np.float64)
    d_img = float(np.linalg.norm(6.0 * hi))
    early_pad = _ceil64(d_img * fs / c + FDL)
    d_direct = float(opt["target"]["dist_to_mic_array"][1]) + 2.0
    l_direct = _ceil64(d_direct * fs / c + FDL)
    return dict(
        n=n, s_max=s_max, k_images=k_images, n_bins=n_bins, spb=spb,
        early_pad=early_pad, l_direct=l_direct,
        l_rir=max(early_pad, n_bins * spb),
    )


def synthesize_item_scene(
    opt: Dict,
    clip_seconds: float,
    speech_path: str,
    noise_paths: Sequence[str],
    seed: int,
    speech_index: int = 0,
    rir_backend: str = "auto",  # accepted for item_args compatibility
) -> Dict:
    """Host half of scene-mode synthesis for one item.

    Consumes its RNG stream in exactly ``synthesize_item``'s order
    (noise draw -> scene -> crops), so the same (seed, epoch, index)
    produces the same scene in every data mode. Returns a dict of small
    numpy arrays plus the corpus indices; no audio leaves the host.
    """
    from eabnet_tpu_torch.data.datasets import load_and_crop
    from eabnet_tpu_torch.data.mixer import snr_gains
    from eabnet_tpu_torch.data.scenes import sample_scene

    rng = np.random.default_rng(seed)
    fs = int(opt["audio"]["fs"])
    n = int(round(fs * clip_seconds))

    # same draws as datasets._read_noise_names, but keep the indices
    lo, hi = opt["noise"]["n"]
    k = int(rng.integers(lo, hi + 1))
    noise_idx = rng.integers(0, len(noise_paths), size=k).astype(np.int64)
    names = [noise_paths[int(i)] for i in noise_idx]

    scene = sample_scene(opt, rng, n_noises_override=len(names))
    scene.noise_names = [os.path.basename(p) for p in names]
    scene.speech_name = os.path.basename(speech_path)

    clean, sp_start = load_and_crop(speech_path, fs, clip_seconds, rng,
                                    return_start=True)
    no_starts = []
    noises = []
    for p in names:
        x, st = load_and_crop(p, fs, clip_seconds, rng, return_start=True)
        noises.append(x)
        no_starts.append(st)
    if len(clean) != n or any(len(x) != n for x in noises):
        raise ValueError(
            "scene mode requires corpus files at the target sample rate "
            "(crops must map 1:1 onto the device-resident corpus)")

    g_clean, g_noises = snr_gains(
        clean, noises, scene.snrs_db, scene.dbfs, fs
    )

    ism_order, air, hybrid_hist = resolve_rir_method(
        scene.rir_method, scene.max_order, scene.rt60, None)
    if not hybrid_hist:
        raise ValueError(
            f"scene mode implements the 'hybrid' RIR method (got "
            f"{scene.rir_method!r} with rt60={scene.rt60}); use "
            "device_mix='parts' for other methods")

    p_mics = np.asarray(scene.p_mics, np.float64)
    srcs = [np.asarray(scene.p_target, np.float64)] + [
        np.asarray(p, np.float64) for p in scene.p_noises
    ]
    t_max = min(max(1.25 * float(scene.rt60), HIST_BIN_S), 2.0)
    delays, amps, hist_amp = [], [], []
    for p_src in srcs:
        d, a = ism_image_params(
            scene.room_dim, p_src, p_mics, scene.e_absorption, ism_order,
            fs, air_absorption=air,
        )
        delays.append(d.astype(np.float32))
        amps.append(a.astype(np.float32))
        h = ism_energy_histogram(
            scene.room_dim, p_src, p_mics, scene.e_absorption, ism_order,
            t_max, air_absorption=air,
        )
        hist_amp.append(np.sqrt(np.maximum(h, 0.0)).astype(np.float32))

    d_ref = float(np.linalg.norm(
        np.asarray(scene.p_target, np.float64) - p_mics[scene.ref_mic]
    ))
    d_ref = max(d_ref, 1e-3)
    tail_seeds = rng.integers(
        0, 2**31 - 1, size=len(srcs)).astype(np.uint32)

    return dict(
        speech_index=int(speech_index),
        noise_index=noise_idx,
        speech_start=int(sp_start),
        noise_starts=np.asarray(no_starts, np.int64),
        gains=np.asarray([g_clean] + g_noises, np.float32),
        delays=np.stack(delays),      # (S, M, K) f32, samples
        amps=np.stack(amps),          # (S, M, K) f32
        hist_amp=np.stack(hist_amp),  # (S, M, NB_item) f32
        d_delay=np.float32(d_ref * fs / SPEED_OF_SOUND),
        d_amp=np.float32(1.0 / (4.0 * np.pi * d_ref)),
        tail_seeds=tail_seeds,        # (S,)
        n=n,
    )


def collate_scenes(items: Sequence[Dict], dims: Dict[str, int]
                   ) -> Dict[str, np.ndarray]:
    """Stack per-item scene dicts into the static-shaped batch
    ``mix_scene`` consumes (padding sources to ``s_max`` with zero
    amps/gains, histogram bins to ``n_bins``)."""
    b = len(items)
    s, k, nb = dims["s_max"], dims["k_images"], dims["n_bins"]
    m = items[0]["delays"].shape[1]
    out = dict(
        sp_idx=np.zeros((b,), np.int32),
        sp_off=np.zeros((b,), np.int32),
        no_idx=np.zeros((b, s - 1), np.int32),
        no_off=np.zeros((b, s - 1), np.int32),
        gains=np.zeros((b, s), np.float32),
        delays=np.zeros((b, s, m, k), np.float32),
        amps=np.zeros((b, s, m, k), np.float32),
        hist_amp=np.zeros((b, s, m, nb), np.float32),
        d_delay=np.zeros((b,), np.float32),
        d_amp=np.zeros((b,), np.float32),
        tail_seeds=np.zeros((b, s), np.uint32),
        lengths=np.full((b,), items[0]["n"], np.int32),
    )
    for i, it in enumerate(items):
        si = it["delays"].shape[0]
        if si > s:
            raise ValueError(f"item has {si} sources but s_max={s}")
        ki = it["delays"].shape[2]
        if ki > k:
            raise ValueError(f"item has {ki} images but k_images={k}")
        nbi = it["hist_amp"].shape[2]
        if nbi > nb:
            raise ValueError(f"item has {nbi} hist bins but n_bins={nb}")
        worst = float(it["delays"].max()) + FDL
        if "early_pad" in dims and worst > dims["early_pad"]:
            raise ValueError(
                f"an image delay ({worst:.0f} samples + filter) exceeds "
                f"early_pad={dims['early_pad']}; the scene fell outside "
                "the settings envelope scene_static_dims was built from")
        out["sp_idx"][i] = it["speech_index"]
        out["sp_off"][i] = it["speech_start"]
        nn = len(it["noise_index"])
        out["no_idx"][i, :nn] = it["noise_index"]
        out["no_off"][i, :nn] = it["noise_starts"]
        out["gains"][i, :si] = it["gains"]
        out["delays"][i, :si, :, :ki] = it["delays"]
        out["amps"][i, :si, :, :ki] = it["amps"]
        out["hist_amp"][i, :si, :, :nbi] = it["hist_amp"]
        out["d_delay"][i] = it["d_delay"]
        out["d_amp"][i] = it["d_amp"]
        out["tail_seeds"][i, :si] = it["tail_seeds"]
    return out


def load_corpus_int16(root: str, names: Sequence[str],
                      fs: int) -> np.ndarray:
    """Stack a wav list into one (n_files, L) int16 array for device
    residency.

    Files must be int16 PCM at ``fs`` (so the device dequantization
    x / 32768 reproduces ``read_wav``'s float conversion bit-exactly) and
    share one length (the staged corpus guarantees both; real corpora can
    be staged through ``cli.resample`` and ``cli.datagen --reuse-speech``).
    """
    from scipy.io import wavfile

    rows: List[np.ndarray] = []
    length = None
    for name in names:
        path = os.path.join(root, name)
        file_fs, data = wavfile.read(path)
        if data.dtype != np.int16:
            raise ValueError(
                f"scene-mode corpus must be int16 PCM: {path} is "
                f"{data.dtype}")
        if file_fs != fs:
            raise ValueError(
                f"scene-mode corpus must be at {fs} Hz: {path} is "
                f"{file_fs}")
        if data.ndim > 1:
            data = data[:, 0]
        if length is None:
            length = len(data)
        elif len(data) != length:
            raise ValueError(
                f"scene-mode corpus files must share one length: {path} "
                f"has {len(data)} vs {length}")
        rows.append(data)
    return np.stack(rows)


# --------------------------------------------------------------------------
# Device side (torch, on the device of the batch's tensors)
# --------------------------------------------------------------------------

IMAGE_CHUNK = 8  # images summed per pass of scene_early_rirs


def scene_early_rirs(delays, amps, early_pad: int):
    """(..., K) image delays (samples) and amplitudes -> (..., early_pad)
    dense early RIRs: each image's 81-tap Hann-windowed sinc placed at the
    integer part of its delay, taps before 0 or past ``early_pad``
    dropped, as ``rir.py::ism_early_rir`` builds it. Each output sample is
    a sum over the images (IMAGE_CHUNK at a time, in image order) of the
    tap that falls on it: no scatter, so the result has the same bits on
    every run. float32 (the host builds in float64)."""
    import torch

    lead = delays.shape[:-1]
    k = delays.shape[-1]
    delays = delays.reshape(-1, 1, k).to(torch.float32)
    amps = amps.reshape(-1, 1, k).to(torch.float32)
    base = torch.floor(delays)
    frac = delays - base
    t = torch.arange(early_pad, device=delays.device,
                     dtype=torch.float32)[None, :, None]
    out = torch.zeros((delays.shape[0], early_pad), dtype=torch.float32,
                      device=delays.device)
    for k0 in range(0, k, IMAGE_CHUNK):
        sl = slice(k0, k0 + IMAGE_CHUNK)
        off = t - base[..., sl]                         # tap index - FDL//2
        x = off - frac[..., sl]
        filt = torch.sinc(x) * (0.5 * (1.0 + torch.cos(2.0 * math.pi * x
                                                        / FDL)))
        filt = torch.where(off.abs() <= FDL // 2, filt * amps[..., sl],
                           torch.zeros((), device=x.device))
        out += filt.sum(dim=-1)
    return out.reshape(*lead, early_pad)


def scene_tails(hist_amp, tail_seeds, spb: int):
    """(B, S, M, NB) histogram amplitudes + (B, S) uint32 seeds (numpy, on
    the host) -> (B, S, M, NB*spb) late-field waveforms: per bin a
    Gaussian carrier normalised to unit energy, times the bin's amplitude.
    The carrier of (b, s) is drawn by a generator on hist_amp's device
    seeded with tail_seeds[b, s]."""
    import torch

    b, s, m, nb = hist_amp.shape
    seeds = np.asarray(tail_seeds).reshape(-1)
    g = torch.empty((b * s, m, nb, spb), dtype=torch.float32,
                    device=hist_amp.device)
    gen = torch.Generator(device=hist_amp.device)
    for i, seed in enumerate(seeds):
        gen.manual_seed(int(seed))
        g[i].normal_(generator=gen)
    g = g.reshape(b, s, m, nb, spb)
    norm = torch.clamp(torch.sqrt(torch.sum(g * g, dim=-1, keepdim=True)),
                       min=1e-12)
    tail = g / norm * hist_amp[..., None]
    return tail.reshape(b, s, m, nb * spb)


def _gather_crop(corpus, idx, off, n: int):
    """(N_files, L) int16 corpus + (R,) indices and offsets -> (R, n)
    float32 crops (x / 32768, as ``read_wav`` converts)."""
    import torch

    cols = off.to(torch.int64)[:, None] + torch.arange(
        n, device=corpus.device)[None, :]
    rows = idx.to(torch.int64)[:, None]
    return corpus[rows, cols].to(torch.float32) / 32768.0


def mix_scene(batch, corpus_speech, corpus_noise, dims: Dict[str, int]):
    """Rebuild every scene of a collated batch and propagate it on the
    corpus's device. ``batch``: the ``collate_scenes`` dict as torch
    tensors on that device, but ``tail_seeds`` as numpy on the host.
    -> (noisy (B, M, n), clean (B, n)) float32: the sum of each dry
    source convolved with its rebuilt hybrid RIR, and the speech's
    anechoic direct path at the reference mic."""
    import torch

    n = dims["n"]
    early_pad = dims["early_pad"]
    l_rir = dims["l_rir"]

    speech = _gather_crop(corpus_speech, batch["sp_idx"], batch["sp_off"],
                          n)                                   # (B, n)
    b = speech.shape[0]
    s1 = batch["no_idx"].shape[1]
    noise = _gather_crop(corpus_noise, batch["no_idx"].reshape(-1),
                         batch["no_off"].reshape(-1), n).reshape(b, s1, n)
    sources = torch.cat([speech[:, None], noise], dim=1)
    sources = sources * batch["gains"][:, :, None]             # (B, S, n)

    early = scene_early_rirs(batch["delays"], batch["amps"], early_pad)
    tail = scene_tails(batch["hist_amp"], batch["tail_seeds"], dims["spb"])
    m = early.shape[2]
    rirs = torch.zeros((b, sources.shape[1], m, l_rir), dtype=torch.float32,
                       device=sources.device)
    rirs[..., :early_pad] += early
    rirs[..., :tail.shape[-1]] += tail

    nfft = _fft_length(n + l_rir - 1)
    s_f = torch.fft.rfft(sources, nfft, dim=-1)                # (B, S, F)
    h_f = torch.fft.rfft(rirs, nfft, dim=-1)                   # (B, S, M, F)
    noisy = torch.fft.irfft((s_f[:, :, None] * h_f).sum(dim=1), nfft,
                            dim=-1)[..., :n]

    h_d = scene_early_rirs(batch["d_delay"][:, None, None],
                           batch["d_amp"][:, None, None],
                           dims["l_direct"])[:, 0]             # (B, Ld)
    nfft_d = _fft_length(n + dims["l_direct"] - 1)
    clean = torch.fft.irfft(
        torch.fft.rfft(sources[:, 0], nfft_d, dim=-1)
        * torch.fft.rfft(h_d, nfft_d, dim=-1), nfft_d, dim=-1)[..., :n]
    return noisy.to(torch.float32), clean.to(torch.float32)
