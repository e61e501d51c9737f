"""SNR mixing and level scaling (the port's own copy of the JAX package's
``data/mixer.py``).

Behavioral parity with the reference mixer (dataset/audio_util.py:6-46):
- noise RMS measured only over *active* 100 ms windows (energy-gated at
  -50 dBFS) so silence doesn't deflate the SNR;
- each noise is scaled to its target SNR against the clean RMS;
- the final mixture is scaled to a target dBFS, applied to clean and noises
  alike (so the clean/noisy pair stays consistent).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

EPS = np.finfo(np.float64).eps


def active_noise_rms(noise: np.ndarray, fs: int,
                     energy_thresh_db: float = -50.0,
                     window_ms: float = 100.0) -> float:
    """RMS over active (energy above threshold) windows only."""
    win = max(1, int(fs * window_ms / 1000.0))
    n = len(noise)
    n_full = (n // win) * win
    segs = noise[:n_full].reshape(-1, win)
    seg_rms = np.sqrt(np.mean(segs**2, axis=1))
    tail = noise[n_full:]
    rms_list = list(seg_rms)
    if len(tail):
        rms_list.append(float(np.sqrt(np.mean(tail**2))))
    rms_arr = np.asarray(rms_list)
    seg_lens = np.full(len(rms_arr), win, dtype=np.float64)
    if len(tail):
        seg_lens[-1] = len(tail)
    thresh = 10.0 ** (energy_thresh_db / 20.0)
    active = rms_arr > thresh
    if not active.any():
        return float(EPS)
    # energy-weighted rms over the active windows
    e = np.sum(rms_arr[active] ** 2 * seg_lens[active])
    return float(np.sqrt(e / np.sum(seg_lens[active])))


def snr_gains(
    clean: np.ndarray,
    noises: Sequence[np.ndarray],
    snrs_db: Sequence[float],
    mixed_dbfs: float,
    fs: int,
) -> Tuple[float, List[float]]:
    """The scalar gains :func:`mix_at_snr` applies to each RAW signal ->
    (g_clean, [g_noise...]).

    Factored out so the device-resident synthesis path (data/scene_mix.py)
    can ship gains instead of scaled waveforms: ``raw * gain`` on device
    reproduces ``mix_at_snr``'s outputs exactly (same float operations).
    """
    peak_c = np.max(np.abs(clean)) + EPS
    clean_n = clean / peak_c
    rms_clean = float(np.sqrt(np.mean(clean_n**2)))
    g_noises = []
    scaled = []
    for noise, snr in zip(noises, snrs_db):
        peak_n = np.max(np.abs(noise)) + EPS
        noise_n = noise / peak_n
        rms_n = active_noise_rms(noise_n, fs)
        scale = rms_clean / (10.0 ** (snr / 20.0)) / (rms_n + EPS)
        g_noises.append(scale / peak_n)
        scaled.append(noise_n * scale)
    mixture = clean_n.copy()
    for noise in scaled:
        mixture = mixture + noise
    rms_mix = float(np.sqrt(np.mean(mixture**2)))
    g = 10.0 ** (mixed_dbfs / 20.0) / (rms_mix + EPS)
    return float(g / peak_c), [float(gn * g) for gn in g_noises]


def mix_at_snr(
    clean: np.ndarray,
    noises: Sequence[np.ndarray],
    snrs_db: Sequence[float],
    mixed_dbfs: float,
    fs: int,
) -> Tuple[np.ndarray, List[np.ndarray]]:
    """Peak-normalize, scale each noise to its SNR vs the clean RMS, then
    scale everything so the mixture RMS hits ``mixed_dbfs``.

    Returns (scaled_clean, scaled_noises) — the *dry* signals, to be
    propagated through the room afterwards (matching the reference's order
    of operations, dataset/audio_util.py:69).
    """
    clean = clean / (np.max(np.abs(clean)) + EPS)
    noises = [x / (np.max(np.abs(x)) + EPS) for x in noises]
    rms_clean = float(np.sqrt(np.mean(clean**2)))
    scaled = []
    for noise, snr in zip(noises, snrs_db):
        rms_n = active_noise_rms(noise, fs)
        scale = rms_clean / (10.0 ** (snr / 20.0)) / (rms_n + EPS)
        scaled.append(noise * scale)
    mixture = clean.copy()
    for noise in scaled:
        mixture = mixture + noise
    rms_mix = float(np.sqrt(np.mean(mixture**2)))
    g = 10.0 ** (mixed_dbfs / 20.0) / (rms_mix + EPS)
    return clean * g, [x * g for x in scaled]
