"""STOI / ESTOI speech-intelligibility metrics, implemented from the
published algorithms (Taal et al. 2011; Jensen & Taal 2016).

The environment has no pystoi (the reference depends on it,
test.py:83-84); this is a self-contained numpy implementation:

1. resample both signals to 10 kHz;
2. remove frames where the clean signal is >40 dB below its loudest frame
   (256-sample Hann frames, 50% overlap);
3. 512-point STFT -> 15 one-third-octave band envelopes (150 Hz base);
4. STOI: per 384 ms segment and band, scale + clip (-15 dB SDR bound) the
   degraded envelope, average the band-wise correlations;
   ESTOI: row- and column-normalize each segment, average the inner
   products (spectral correlation).

The port's own copy of the JAX package's ``eval/stoi.py`` (numpy and scipy
only); ``tests/test_torch_eval.py`` holds the two equal.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np

FS = 10000
N_FRAME = 256
NFFT = 512
NUM_BANDS = 15
MIN_FREQ = 150.0
N_SEG = 30          # frames per intermediate-intelligibility segment
BETA = -15.0        # lower SDR clip bound (dB)
DYN_RANGE = 40.0    # silent-frame energy range (dB)


@functools.lru_cache(maxsize=1)
def _third_octave_bands() -> np.ndarray:
    """(15, NFFT//2+1) boolean matrix selecting each band's FFT bins."""
    f = np.linspace(0, FS / 2, NFFT // 2 + 1)
    cf = MIN_FREQ * 2.0 ** (np.arange(NUM_BANDS) / 3.0)
    lo = cf * 2.0 ** (-1.0 / 6.0)
    hi = cf * 2.0 ** (1.0 / 6.0)
    obm = np.zeros((NUM_BANDS, len(f)))
    for j in range(NUM_BANDS):
        lo_i = int(np.argmin((f - lo[j]) ** 2))
        hi_i = int(np.argmin((f - hi[j]) ** 2))
        obm[j, lo_i:hi_i] = 1.0
    return obm


def _hann(n: int) -> np.ndarray:
    # periodic-symmetric Hann as in the STOI reference implementation
    return np.hanning(n + 2)[1:-1]


def _frames(x: np.ndarray) -> np.ndarray:
    hop = N_FRAME // 2
    n = 1 + (len(x) - N_FRAME) // hop
    if n <= 0:
        return np.zeros((0, N_FRAME))
    idx = np.arange(n)[:, None] * hop + np.arange(N_FRAME)[None, :]
    return x[idx]


def _remove_silent_frames(
    x: np.ndarray, y: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    w = _hann(N_FRAME)
    hop = N_FRAME // 2
    xf = _frames(x) * w
    yf = _frames(y) * w
    energies = 20 * np.log10(np.linalg.norm(xf, axis=1) + 1e-12)
    mask = energies > energies.max() - DYN_RANGE
    xf, yf = xf[mask], yf[mask]
    # overlap-add back
    n_out = len(xf) * hop + N_FRAME if len(xf) else 0
    xs = np.zeros(n_out)
    ys = np.zeros(n_out)
    for i in range(len(xf)):
        xs[i * hop : i * hop + N_FRAME] += xf[i]
        ys[i * hop : i * hop + N_FRAME] += yf[i]
    return xs, ys


def _band_envelopes(x: np.ndarray) -> np.ndarray:
    """(n_frames, N_FRAME) windowed frames -> (15, n_frames) envelopes."""
    w = _hann(N_FRAME)
    frames = _frames(x) * w
    spec = np.fft.rfft(frames, NFFT, axis=1)  # (T, F)
    power = np.abs(spec) ** 2
    obm = _third_octave_bands()
    return np.sqrt(obm @ power.T)  # (15, T)


def _resample_10k(x: np.ndarray, fs: int) -> np.ndarray:
    if fs == FS:
        return x
    from scipy.signal import resample_poly

    g = np.gcd(int(fs), FS)
    return resample_poly(x, FS // g, fs // g)


def stoi(x: np.ndarray, y: np.ndarray, fs_sig: int,
         extended: bool = False) -> float:
    """Short-time objective intelligibility of degraded ``y`` vs clean
    ``x`` in [~0, 1]. ``extended=True`` gives ESTOI."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    assert x.shape == y.shape, "inputs must be equal length"
    x = _resample_10k(x, fs_sig)
    y = _resample_10k(y, fs_sig)
    x, y = _remove_silent_frames(x, y)
    if len(x) < N_FRAME * (N_SEG // 2):
        return float("nan")

    xb = _band_envelopes(x)  # (15, T)
    yb = _band_envelopes(y)
    t = xb.shape[1]
    if t < N_SEG:
        return float("nan")

    if not extended:
        corrs = []
        for m in range(N_SEG, t + 1):
            xs = xb[:, m - N_SEG : m]  # (15, 30)
            ys = yb[:, m - N_SEG : m]
            alpha = np.sqrt(
                np.sum(xs**2, axis=1, keepdims=True)
                / (np.sum(ys**2, axis=1, keepdims=True) + 1e-12)
            )
            ys_c = np.minimum(
                ys * alpha, xs * (1 + 10.0 ** (-BETA / 20.0))
            )
            xn = xs - xs.mean(axis=1, keepdims=True)
            yn = ys_c - ys_c.mean(axis=1, keepdims=True)
            denom = (
                np.linalg.norm(xn, axis=1) * np.linalg.norm(yn, axis=1)
                + 1e-12
            )
            corrs.append(np.sum(xn * yn, axis=1) / denom)
        return float(np.mean(corrs))

    # ESTOI
    vals = []
    for m in range(N_SEG, t + 1):
        xs = xb[:, m - N_SEG : m]
        ys = yb[:, m - N_SEG : m]

        def row_col_normalize(seg):
            r = seg - seg.mean(axis=1, keepdims=True)
            r = r / (np.linalg.norm(r, axis=1, keepdims=True) + 1e-12)
            c = r - r.mean(axis=0, keepdims=True)
            c = c / (np.linalg.norm(c, axis=0, keepdims=True) + 1e-12)
            return c

        xn = row_col_normalize(xs)
        yn = row_col_normalize(ys)
        # average of the N unit-normalized column inner products
        vals.append(np.sum(xn * yn) / N_SEG)
    return float(np.mean(vals))
