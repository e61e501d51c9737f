"""One frame at a time through the offline modules.

A model advances a stream by one frame when its offline ``forward`` runs
on that frame (time length 1) inside ``stepping(frame)``. The leaves that
look along time then read what they carry from the frames before and
leave what the next frame needs: the causal convs and transposed convs a
ring of past input frames, the cumulative layer norms their running sums,
the beamforming head's LSTM layers their (h, c). Every other module runs
as it does offline. ``streaming.py`` drives it.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Callable, Dict, Optional

import torch

State = Dict[str, torch.Tensor]

_CURRENT: contextvars.ContextVar = contextvars.ContextVar("frame",
                                                          default=None)


class Frame:
    """One step of a stream: the carried tensors it reads and the ones it
    leaves, keyed ``<module name>.<field>``. With ``state`` None it is a
    stream's first step, and each carried tensor takes its start value
    from ``start()`` (kept in ``self.start``)."""

    def __init__(self, names: Dict[torch.nn.Module, str],
                 state: Optional[State]):
        self.names, self.state, self.new, self.start = names, state, {}, {}

    def carried(self, module, field: str,
                start: Callable[[], torch.Tensor]) -> torch.Tensor:
        key = f"{self.names[module]}.{field}"
        if self.state is None:
            self.start[key] = start()
            return self.start[key]
        return self.state[key]

    def keep(self, module, field: str, value: torch.Tensor) -> None:
        self.new[f"{self.names[module]}.{field}"] = value

    def ring(self, module, x: torch.Tensor, span: int) -> torch.Tensor:
        """The window of ``module``'s last ``span`` input frames and ``x``
        along dim 2; zeros before a stream's first frame."""
        if span == 0:
            return x
        buf = self.carried(module, "ring", lambda: x.new_zeros(
            x.shape[:2] + (span,) + x.shape[3:]))
        window = torch.cat([buf, x], dim=2)
        self.keep(module, "ring", window[:, :, 1:])
        return window


def current() -> Optional[Frame]:
    """The frame being stepped, or None in an offline forward."""
    return _CURRENT.get()


@contextlib.contextmanager
def stepping(frame: Frame):
    """Run the offline forwards inside as one step of ``frame``."""
    token = _CURRENT.set(frame)
    try:
        yield
    finally:
        _CURRENT.reset(token)
