"""PESQ (ITU-T P.862) gateway.

The reference repo wraps the `pesq` PyPI package around the ITU reference C
implementation (reference: metrics.py:10, test.py:81-82). This module
scores PESQ through the first available backend:

- ``itu``: the `pesq` PyPI package (bit-conformant ITU code) when
  importable — preferred automatically;
- ``first_party``: :mod:`eabnet_tpu_torch.eval.p862`, the complete P.862
  pipeline implemented in this framework (level + time alignment, Bark
  loudness model, asymmetric disturbance aggregation, MOS-LQO maps). Always
  available; see p862.py's docstring for its conformance caveat.

Scores are therefore never NaN. When both backends are importable the test
suite cross-checks them (the JAX package's tests/test_pesq.py). Set the
environment variable ``EABNET_PESQ_BACKEND`` to ``itu``/``first_party`` to
force one.

The port's own copy of the JAX package's ``eval/pesq.py``;
``tests/test_torch_eval.py`` holds the two equal.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from eabnet_tpu_torch.eval.p862 import pesq_p862


def _forced_backend() -> Optional[str]:
    b = os.environ.get("EABNET_PESQ_BACKEND", "").strip().lower()
    return b or None


def itu_pesq_available() -> bool:
    """True when the ITU-wrapped `pesq` PyPI package is importable."""
    try:
        import pesq as _  # noqa: F401

        return True
    except ImportError:
        return False


# kept for backward compatibility: PESQ itself is now always available
def pesq_available() -> bool:
    return True


def pesq_backend() -> str:
    """Name of the backend `pesq()` will use: 'itu' or 'first_party'."""
    forced = _forced_backend()
    if forced in ("itu", "first_party"):
        if forced == "itu" and not itu_pesq_available():
            raise RuntimeError(
                "EABNET_PESQ_BACKEND=itu but the `pesq` package is not"
                " importable"
            )
        return forced
    return "itu" if itu_pesq_available() else "first_party"


def pesq(sr: int, ref: np.ndarray, deg: np.ndarray,
         mode: str = "wb") -> float:
    """PESQ MOS-LQO (reference: metrics.py:101-108).

    mode 'wb' = P.862.2 wideband (fs must be 16000), 'nb' = narrowband
    P.862 with the P.862.1 mapping.
    """
    if pesq_backend() == "itu":
        from pesq import pesq as _itu_pesq

        return float(_itu_pesq(sr, np.asarray(ref), np.asarray(deg), mode))
    return float(pesq_p862(sr, ref, deg, mode))
