"""The traced window: torch.profiler over a run of calls or steps, and
what the per-layer metrics read from it.

One CUDA stream runs everything, so the device is busy during the union
of its kernel, copy and set intervals; the idle share is 1 - busy /
window. Launches are the host's launch calls in the profiler's runtime
events (``cudaLaunchKernel``, ``cuLaunchKernel``, the cooperative and
``Ex`` forms, ``cudaGraphLaunch``). Device time is grouped by kind of
kernel (``kernel_category``) for the breakdown, and each idle gap is
named by the innermost host event that covers its middle.
"""

from __future__ import annotations

import re
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

LAUNCH = re.compile(r"^cu(da)?(Launch|GraphLaunch)")
_CATEGORIES = (
    ("port lstm_bf", ("lstm_bf_fwd",)),
    ("port tcm_chain", ("tcm_chain_fwd",)),
    ("port lstm_bf bwd", ("lstm_bf_bwd", "lstm_bf_wgrad")),
    ("port tcm_chain bwd", ("tcm_chain_bwd", "tcm_chain_wgrad",
                            "tcm_chain_grad_sum")),
    ("memcpy/memset", ("memcpy", "memset")),
    ("optimizer foreach", ("multi_tensor_apply",)),
    ("conv (cuDNN)", ("conv", "cudnn", "xmma", "implicit", "dgrad",
                      "wgrad", "fprop", "winograd", "fft")),
    ("gemm", ("gemm", "cutlass", "sm90_", "ampere_", "cublas")),
    ("reduce", ("reduce", "norm", "welford")),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "cat", "copy",
                     "fill", "index", "pad", "where", "atan", "pow")),
)


def kernel_category(name: str) -> str:
    n = name.lower()
    for cat, keys in _CATEGORIES:
        if any(k in n for k in keys):
            return cat
    return "other"


@dataclass
class Trace:
    """Device events (name, start us, end us), the host's launch calls,
    host events (name, start us, end us) and the window's length."""

    window_s: float
    device: List[Tuple[str, float, float]] = field(default_factory=list)
    launches: int = 0
    host: List[Tuple[str, float, float]] = field(default_factory=list)

    def device_seconds(self, patterns: Sequence[str]) -> Optional[float]:
        """Summed device time of the events whose name holds one of
        ``patterns``; None when none does."""
        hits = [e - s for n, s, e in self.device
                if any(p in n for p in patterns)]
        return sum(hits) * 1e-6 if hits else None

    def busy_s(self) -> float:
        return sum(e - s for s, e in _merged(self.device)) * 1e-6


def _merged(events) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for _, s, e in sorted(events, key=lambda x: x[1]):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


class Window:
    """``with Window(on, device) as w:`` times the block, from a device
    sync on entry to one on exit, and profiles it when ``on``;
    ``w.seconds`` is its length and ``w.trace`` what was read, or None
    when the profiler recorded no device event."""

    def __init__(self, on: bool, device="cuda"):
        import torch

        self.on = on
        self.cuda = torch.device(device).type == "cuda"
        self.trace: Optional[Trace] = None
        self._prof = None

    def _sync(self):
        if self.cuda:
            import torch

            torch.cuda.synchronize()

    def __enter__(self):
        self._sync()
        if self.on:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if self.cuda:
                acts.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=acts)
            self._prof.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._sync()
        self.seconds = time.perf_counter() - self.t0
        if self._prof is not None:
            self._prof.__exit__(*exc)
            if exc[0] is None:
                self.trace = read_profile(self._prof, self.seconds)
        return False


def read_profile(prof, window_s: float) -> Optional[Trace]:
    from torch.autograd import DeviceType

    tr = Trace(window_s)
    for e in prof.events():
        rng = e.time_range
        if e.device_type == DeviceType.CUDA:
            tr.device.append((e.name, rng.start, rng.end))
        else:
            if LAUNCH.match(e.name):
                tr.launches += 1
            tr.host.append((e.name, rng.start, rng.end))
    return tr if tr.device else None


def by_category(tr: Trace) -> List[Tuple[str, float]]:
    """[(category, device seconds)], the largest first."""
    cats: Dict[str, float] = {}
    for n, s, e in tr.device:
        c = kernel_category(n)
        cats[c] = cats.get(c, 0.0) + (e - s) * 1e-6
    return sorted(cats.items(), key=lambda kv: -kv[1])


def idle_gaps(tr: Trace, min_us: float = 2.0) -> List[Tuple[str, float]]:
    """[(host event, idle device seconds)], the largest first: each gap
    between device intervals named by the innermost host event that
    covers its middle ("no host event" where none does: the host ran
    Python or numpy). Not its start: the host call that waited for the
    last device work (a copy back) covers the start of the gap after it."""
    busy = _merged(tr.device)
    if not tr.host:
        return []
    host = sorted(tr.host, key=lambda x: x[1])
    starts = np.array([h[1] for h in host])
    ends = np.array([h[2] for h in host])
    out: Dict[str, float] = {}
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        gap = s1 - e0
        if gap < min_us:
            continue
        t = e0 + 0.5 * gap
        name = "no host event"
        i = int(np.searchsorted(starts, t, side="right")) - 1
        for j in range(i, max(i - 256, -1), -1):
            if ends[j] > t:
                name = host[j][0]
                break
        out[name] = out.get(name, 0.0) + gap * 1e-6
    return sorted(out.items(), key=lambda kv: -kv[1])
