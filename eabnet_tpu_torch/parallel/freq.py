"""Frequency-axis model parallelism: one utterance's bins over the ranks
of a ``freq`` group, the port's counterpart of the JAX package's
``Enhancer(shard_freq=True)`` (GSPMD splits the network along F there;
here every op that looks across F is written out).

A forward that runs inside :func:`sharding` consults :func:`current`, as
the streaming leaves consult ``nn/stepping.py``, and there is one model
definition:

- **Partition.** Each width W of the network (161, 79, 39, 19, 9, 4 for
  the released models) is split into contiguous, near-even column ranges,
  the first ``W % N`` ranks one column wider (:func:`columns`). The ranges
  are a function of (W, N) alone, so a skip at one level and the
  decoder's input at that level agree. A width is **split** where every
  rank owns at least ``MIN_COLUMNS`` = 5 columns (``W // N >= 5``, the
  widest frequency kernel of the released models, so a halo comes from
  the neighbours alone); narrower levels are **replicated**: gathered
  once on the way down, computed whole on every rank, and sliced back to
  the owned columns where the width grows past the threshold on the way
  up. The bottleneck (width 4) is always replicated.
- **Convolutions along F** (``nn/blocks.py``): a stride-2 conv computes
  its owned output columns [a, b) from inputs [2a, 2b + k - 2), a
  transposed conv from inputs [ceil((a - k + 1) / 2), floor((b - 1) / 2)]
  (:meth:`FreqShard.conv_input`); the missing columns come from the
  ranks that own them (:meth:`FreqShard.fetch_columns`). Time stays
  causal as before.
- **Norms** (``nn/norms.py``): IN's mean and squared deviations, cLN's
  per-frame sums and sums of squares are all-reduced over the group
  (:meth:`FreqShard.sum_over_freq`), and counts use the global width.
- **Flat layers** (``models/gagnet.py``): ``_GatedIn`` is row-parallel
  over the rank's bins in both the real and the imaginary halves of the
  previous estimate, one all-reduce for its two Denses; the heads are
  column-parallel. The LSTM-BF head, ``beamform_sum`` and the cnn and
  miso heads need nothing: their lanes are the rank's bins.
- **Output**: :meth:`FreqShard.gather_freq` before the iSTFT.

Collectives run on the ``freq`` subgroup: NCCL on cards, gloo on the host
and for ranks that share one card (gloo's tensors are staged through the
host). Each is counted where it is issued, with its bytes, in ``counts``
by kind: ``halo`` (conv inputs), ``norm`` (norm sums), ``gather``
(replicated levels, the output, the data axis's rows) and ``row`` (the
row-parallel sums). :func:`zero_counts` resets them.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

MIN_COLUMNS = 5
KINDS = ("halo", "norm", "gather", "row")

counts = {k: {"calls": 0, "bytes": 0} for k in KINDS}

_CURRENT: contextvars.ContextVar = contextvars.ContextVar("freq_shard",
                                                          default=None)


def zero_counts() -> None:
    for c in counts.values():
        c["calls"] = c["bytes"] = 0


def _count(kind: str, nbytes: int) -> None:
    counts[kind]["calls"] += 1
    counts[kind]["bytes"] += int(nbytes)


def columns(w: int, n: int, f: int) -> Tuple[int, int]:
    """The columns [lo, hi) of width ``w`` that rank ``f`` of ``n`` owns
    where the width is split."""
    base, extra = divmod(w, n)
    lo = f * base + min(f, extra)
    return lo, lo + base + (f < extra)


class FreqShard:
    """This rank's place in its ``freq`` group: index ``index`` of
    ``size``, the group's global ranks ``peers`` in freq order, and the
    model's ``bins``. ``width`` is the global width of the frequency map in
    flight, set at each model's entry and by each conv along F."""

    def __init__(self, group, index: int, size: int, peers: Sequence[int],
                 bins: int):
        self.group, self.index, self.size = group, index, size
        self.peers, self.bins = list(peers), bins
        self.width = bins

    def split(self, w: int) -> bool:
        return w // self.size >= MIN_COLUMNS

    def owned(self, w: int) -> Tuple[int, int]:
        """This rank's columns of width ``w``: its range where ``w`` is
        split, all of them where it is replicated."""
        return columns(w, self.size, self.index) if self.split(w) else (0, w)

    def _check(self, x: torch.Tensor, w: int) -> None:
        lo, hi = self.owned(w)
        if x.shape[-1] != hi - lo:
            raise RuntimeError(
                f"freq shard {self.index} of {self.size}: a map of "
                f"{x.shape[-1]} columns where width {w} gives it {hi - lo}")

    def split_map(self, x: torch.Tensor) -> bool:
        """True where ``x`` (B, C, T, F) is this rank's share of a split
        frequency map, whose statistics then span the group."""
        if x.dim() != 4:
            return False
        self._check(x, self.width)
        return self.split(self.width)

    def _stage(self, x: torch.Tensor) -> torch.device:
        """Where the group's collectives take ``x``: the host under gloo."""
        return (torch.device("cpu") if dist.get_backend(self.group) == "gloo"
                else x.device)

    def fetch_columns(self, x: torch.Tensor, w: int,
                      need: Sequence[Tuple[int, int]],
                      kind: str = "halo") -> torch.Tensor:
        """Columns ``need[self.index]`` of the split width-``w`` map whose
        owned columns ``x`` holds on its last axis, from the ranks that own
        them. ``need[j]`` is what rank j asks for: every rank calls this
        with the same ``need`` and sends its part of each other rank's
        request, in one ``batch_isend_irecv``."""
        own_lo, own_hi = self.owned(w)
        lo, hi = need[self.index]
        pieces, ops, got = [], [], 0
        stage = self._stage(x) if self.size > 1 else x.device
        for j in range(self.size):
            j_lo, j_hi = columns(w, self.size, j)
            a, b = max(lo, j_lo), min(hi, j_hi)
            if j == self.index:
                if a < b:
                    pieces.append((a, x[..., a - own_lo:b - own_lo]))
                continue
            if a < b:
                buf = x.new_empty(x.shape[:-1] + (b - a,), device=stage)
                ops.append(dist.P2POp(dist.irecv, buf, self.peers[j],
                                      self.group))
                pieces.append((a, buf))
                got += buf.nbytes
            s, e = max(need[j][0], own_lo), min(need[j][1], own_hi)
            if s < e:
                ops.append(dist.P2POp(dist.isend, x[..., s - own_lo:
                                                    e - own_lo].to(
                    stage).contiguous(), self.peers[j], self.group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
            _count(kind, got)
        pieces.sort(key=lambda p: p[0])
        return torch.cat([p.to(x.device) for _, p in pieces], dim=-1)

    def conv_input(self, x: torch.Tensor, k: int, transposed: bool
                   ) -> Tuple[torch.Tensor, Optional[Tuple[int, int]]]:
        """The input columns that a stride-2 conv (or transposed conv) of
        frequency kernel ``k`` reads for this rank's output columns, and,
        for a transposed conv, the slice of its output to keep (None: keep
        all). Advances ``width`` to the output's."""
        w_in = self.width
        self._check(x, w_in)
        w_out = 2 * (w_in - 1) + k if transposed else (w_in - k) // 2 + 1
        self.width = w_out

        def reads(a, b):
            if transposed:
                return max(0, -(-(a - k + 1) // 2)), min(w_in, (b - 1) // 2
                                                         + 1)
            return 2 * a, 2 * b + k - 2

        if self.split(w_out):
            need = [reads(*columns(w_out, self.size, j))
                    for j in range(self.size)]
        else:
            need = [(0, w_in)] * self.size
        lo, hi = need[self.index]
        if self.split(w_in):
            x = self.fetch_columns(x, w_in, need, "halo" if self.split(w_out)
                                   else "gather")
        else:
            x = x[..., lo:hi]
        if not transposed or not self.split(w_out):
            return x, None
        a, b = columns(w_out, self.size, self.index)
        return x, (a - 2 * lo, b - 2 * lo)

    def whole(self, x: torch.Tensor) -> torch.Tensor:
        """The whole width of the map in flight on every rank."""
        self._check(x, self.width)
        if not self.split(self.width):
            return x
        return self.fetch_columns(x, self.width,
                                  [(0, self.width)] * self.size, "gather")

    def own(self, x: torch.Tensor) -> torch.Tensor:
        """A whole map of the width in flight cut to this rank's columns."""
        lo, hi = self.owned(self.width)
        return x[..., lo:hi]

    def sum_over_freq(self, x: torch.Tensor, kind: str) -> torch.Tensor:
        """``x`` summed over the group's ranks (a copy)."""
        if self.size == 1:
            return x
        y = x.to(self._stage(x), copy=True)
        dist.all_reduce(y, group=self.group)
        _count(kind, y.nbytes)
        return y.to(x.device)

    def gather_freq(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The rank's bins of ``x`` along ``dim`` -> every bin, on every
        rank of the group."""
        y = x.movedim(dim, -1)
        self._check(y, self.bins)
        y = self.fetch_columns(y, self.bins, [(0, self.bins)] * self.size,
                               "gather")
        return y.movedim(-1, dim)


def gather_rows(x: torch.Tensor, group, size: int) -> torch.Tensor:
    """Each rank's rows of ``x`` (equal shapes) concatenated in rank order
    of ``group`` (the ``data`` axis), on every rank."""
    if size == 1:
        return x
    stage = (torch.device("cpu") if dist.get_backend(group) == "gloo"
             else x.device)
    parts: List[torch.Tensor] = [torch.empty_like(x, device=stage)
                                 for _ in range(size)]
    dist.all_gather(parts, x.to(stage).contiguous(), group=group)
    _count("gather", x.nbytes * (size - 1))
    return torch.cat(parts).to(x.device)


def current() -> Optional[FreqShard]:
    """The shard a forward runs as, or None outside :func:`sharding`."""
    return _CURRENT.get()


@contextlib.contextmanager
def sharding(shard: Optional[FreqShard]):
    """Run the forwards inside as ``shard`` (None: unsharded)."""
    token = _CURRENT.set(shard)
    try:
        yield
    finally:
        _CURRENT.reset(token)
