"""Signal metrics: the SI-SDR family and statistics helpers.

Behavioral parity with the reference metrics library (metrics.py:14-125):
SI-SDR decomposition into target/noise/artifact components, energy ratios
(SI-SDR / SI-SIR / SI-SAR), plain SI-SDR, SNR, Butterworth high-pass, and
the mean/std/confidence-interval report helpers.

The port's own copy of the JAX package's ``eval/metrics.py`` (numpy and
scipy only); ``tests/test_torch_eval.py`` holds the two equal.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
from scipy.signal import butter, sosfilt


def si_sdr_components(
    s_hat: np.ndarray, s: np.ndarray, n: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Project the estimate onto target and noise subspaces; the remainder
    is artifact (reference: metrics.py:14-28)."""
    alpha_s = np.dot(s_hat, s) / (np.linalg.norm(s) ** 2)
    s_target = alpha_s * s
    alpha_n = np.dot(s_hat, n) / (np.linalg.norm(n) ** 2)
    e_noise = alpha_n * n
    e_art = s_hat - s_target - e_noise
    return s_target, e_noise, e_art


def energy_ratios(
    s_hat: np.ndarray, s: np.ndarray, n: np.ndarray
) -> Tuple[float, float, float]:
    """(si_sdr, si_sir, si_sar) in dB (reference: metrics.py:30-39)."""
    s_target, e_noise, e_art = si_sdr_components(s_hat, s, n)
    p_t = np.linalg.norm(s_target) ** 2
    si_sdr_v = 10 * np.log10(p_t / (np.linalg.norm(e_noise + e_art) ** 2))
    si_sir = 10 * np.log10(p_t / (np.linalg.norm(e_noise) ** 2))
    si_sar = 10 * np.log10(p_t / (np.linalg.norm(e_art) ** 2))
    return float(si_sdr_v), float(si_sir), float(si_sar)


def si_sdr(s: np.ndarray, s_hat: np.ndarray) -> float:
    """Scale-invariant SDR in dB (reference: metrics.py:71-75)."""
    alpha = np.dot(s_hat, s) / (np.linalg.norm(s) ** 2)
    return float(
        10
        * np.log10(
            np.linalg.norm(alpha * s) ** 2
            / np.linalg.norm(alpha * s - s_hat) ** 2
        )
    )


def snr_db(s: np.ndarray, n: np.ndarray) -> float:
    return float(10 * np.log10(np.mean(s**2) / np.mean(n**2)))


def hp_filter(signal: np.ndarray, cut_off: float = 80.0, order: int = 10,
              sr: int = 16000) -> np.ndarray:
    sos = butter(order, cut_off / sr * 2, "hp", output="sos")
    return sosfilt(sos, signal)


def seg_snr(ref: np.ndarray, est: np.ndarray, sr: int = 16000,
            frame_ms: float = 32.0, floor_db: float = -10.0,
            ceil_db: float = 35.0) -> float:
    """Segmental SNR in dB: per-frame SNR clamped to [-10, 35] dB and
    averaged over frames with signal energy."""
    n = int(sr * frame_ms / 1000.0)
    n_frames = len(ref) // n
    if n_frames == 0:
        return float("nan")
    r = ref[: n_frames * n].reshape(n_frames, n)
    e = est[: n_frames * n].reshape(n_frames, n)
    sig = np.sum(r**2, axis=1)
    err = np.sum((r - e) ** 2, axis=1)
    keep = sig > 1e-10
    if not keep.any():
        return float("nan")
    snr = 10 * np.log10(sig[keep] / (err[keep] + 1e-12))
    return float(np.mean(np.clip(snr, floor_db, ceil_db)))


def log_spectral_distance(ref: np.ndarray, est: np.ndarray,
                          n_fft: int = 512, hop: int = 256) -> float:
    """RMS log-spectral distance in dB over frames."""
    from scipy.signal import stft as sp_stft

    _, _, r = sp_stft(ref, nperseg=n_fft, noverlap=n_fft - hop)
    _, _, e = sp_stft(est, nperseg=n_fft, noverlap=n_fft - hop)
    pr = np.maximum(np.abs(r) ** 2, 1e-12)
    pe = np.maximum(np.abs(e) ** 2, 1e-12)
    d = 10.0 * (np.log10(pr) - np.log10(pe))
    return float(np.mean(np.sqrt(np.mean(d**2, axis=0))))


def pad_spec_to_multiple(spec: np.ndarray, multiple: int = 64,
                         axis: int = -1) -> np.ndarray:
    """Zero-pad the time axis to a frame-count multiple
    (reference: pad_spec, metrics.py:83-90)."""
    t = spec.shape[axis]
    num_pad = (-t) % multiple
    if num_pad == 0:
        return spec
    pad = [(0, 0)] * spec.ndim
    pad[axis if axis >= 0 else spec.ndim + axis] = (0, num_pad)
    return np.pad(spec, pad)


def mean_std(data: np.ndarray) -> Tuple[float, float]:
    data = np.asarray(data, float)
    data = data[~np.isnan(data)]
    return float(np.mean(data)), float(np.std(data))


def mean_conf_int(data: Sequence[float],
                  confidence: float = 0.95) -> Tuple[float, float]:
    import scipy.stats

    a = np.asarray(data, float)
    m, se = float(np.mean(a)), float(scipy.stats.sem(a))
    h = se * float(scipy.stats.t.ppf((1 + confidence) / 2.0, len(a) - 1))
    return m, h


class MetricAccumulator:
    """Per-metric value collector with mean±std / CI reporting
    (reference: Method, metrics.py:48-63)."""

    def __init__(self, metrics: Sequence[str]):
        self.metrics: Dict[str, List[float]] = {m: [] for m in metrics}

    def append(self, metric: str, value: float) -> None:
        self.metrics[metric].append(float(value))

    def update(self, values: Dict[str, float]) -> None:
        for k, v in values.items():
            if v is None:
                continue
            self.metrics.setdefault(k, []).append(float(v))

    def mean_std(self, metric: str) -> Tuple[float, float]:
        return mean_std(np.asarray(self.metrics[metric]))

    def mean_ci(self, metric: str) -> Tuple[float, float]:
        return mean_conf_int(self.metrics[metric])

    def report(self) -> Dict[str, Tuple[float, float]]:
        return {
            k: mean_std(np.asarray(v))
            for k, v in self.metrics.items()
            if len(v)
        }
