"""Host-side wav I/O and resampling (scipy), the port's own copy."""

from __future__ import annotations

from typing import Tuple

import numpy as np
from scipy.io import wavfile
from scipy.signal import resample as _resample


def read_wav(path: str) -> Tuple[int, np.ndarray]:
    """Read a wav; returns (sr, float32 array in [-1, 1], shape (N,) or
    (channels, N))."""
    sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)
    if data.ndim == 2:  # scipy gives (N, channels)
        data = data.T
    return sr, data


def write_wav(path: str, sr: int, data: np.ndarray,
              dtype: str = "int16") -> None:
    """Write (N,) or (channels, N) float audio as int16 or float32."""
    data = np.asarray(data)
    if data.ndim == 2:
        data = data.T
    if dtype == "int16":
        data = (np.clip(data, -1.0, 1.0) * np.iinfo(np.int16).max).astype(
            np.int16)
    else:
        data = data.astype(np.float32)
    wavfile.write(path, sr, data)


def resample(audio: np.ndarray, sr_from: int, sr_to: int) -> np.ndarray:
    """Fourier resampling along the last axis."""
    if sr_from == sr_to:
        return audio
    n_out = int(round(audio.shape[-1] * sr_to / sr_from))
    return _resample(audio, n_out, axis=-1).astype(audio.dtype)
