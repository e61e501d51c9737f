"""Signal metrics used by the port's smoke run (own copy, numpy only)."""

from __future__ import annotations

import numpy as np


def si_sdr(s: np.ndarray, s_hat: np.ndarray) -> float:
    """Scale-invariant SDR of the estimate ``s_hat`` against ``s``, in dB."""
    alpha = np.dot(s_hat, s) / (np.linalg.norm(s) ** 2)
    return float(10 * np.log10(
        np.linalg.norm(alpha * s) ** 2
        / np.linalg.norm(alpha * s - s_hat) ** 2))
