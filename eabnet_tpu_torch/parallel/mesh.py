"""Device meshes and the process group, the port's counterpart of the JAX
package's ``parallel/mesh.py``.

The JAX package drives every local device from one process through one
jitted step; the port runs one process per card, as the reference's
DDP/NCCL trainer does (train_distributed.py:159-204), joined by a
``torch.distributed`` process group:

- training: each rank takes its rows of every global batch
  (``data/datasets.py::BatchLoader``), and the step all-reduces the
  loss's frame count, the gradients and the losses, and batch norms their
  sums (``train/step.py``, ``nn/norms.py``);
- serving: one process keeps a replica of the model on every device of a
  :class:`Mesh`'s ``data`` axis (``inference.py::Enhancer``); or, with
  ``shard_freq``, each rank of a group takes one entry of a ('data',
  'freq') mesh (rank r the r-th entry in row-major order), its rows of the
  batch and its share of the bins (``parallel/freq.py``), inside the
  subgroups of :func:`axis_group`.

Without a process group the helpers below answer as one process does.
"""

from __future__ import annotations

import datetime
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist


class Mesh:
    """An n-D array of ``torch.device`` entries with named axes. An entry
    may name a device more than once (two replicas on one card)."""

    def __init__(self, devices: np.ndarray, axis_names: Tuple[str, ...]):
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-D devices for axes "
                             f"{axis_names}")
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {list(self.devices.flat)})"


def make_mesh(axes: Sequence[str] = ("data",),
              devices: Optional[Sequence] = None,
              sizes: Optional[Sequence[int]] = None) -> Mesh:
    """A mesh over ``devices`` (default: every visible card), with the JAX
    package's rules: ``sizes`` pins each axis's extent (one entry may be
    -1 to take the rest); without it the leading axis takes every
    device."""
    if devices is None:
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError("make_mesh: no visible CUDA device; pass "
                               "devices= to mesh others")
        devices = [f"cuda:{i}" for i in range(n)]
    flat = np.empty(len(devices), dtype=object)
    flat[:] = [torch.device(d) for d in devices]
    n = flat.size
    if sizes is not None:
        sizes = list(sizes)
        if -1 in sizes:
            known = int(np.prod([s for s in sizes if s != -1]))
            sizes[sizes.index(-1)] = n // known
        if int(np.prod(sizes)) != n:
            raise ValueError(f"mesh sizes {sizes} != {n} devices")
    else:
        sizes = [n] + [1] * (len(axes) - 1)
    return Mesh(flat.reshape(sizes), tuple(axes))


def axis_group(mesh: Mesh, axis: str) -> Tuple[int, List[int], object]:
    """The ranks of a group laid out on ``mesh`` (rank r at the r-th entry,
    row-major) that share this rank's place on every axis but ``axis``:
    (this rank's index along ``axis``, their global ranks in order, their
    ``torch.distributed`` subgroup; None without a group). Every rank makes
    every line's subgroup, in the same order, as ``new_group`` requires."""
    from eabnet_tpu_torch.parallel.launch import GROUP_TIMEOUT_S

    ranks = np.arange(mesh.size).reshape(mesh.devices.shape)
    lines = np.moveaxis(ranks, mesh.axis_names.index(axis), -1).reshape(
        -1, mesh.shape[axis])
    me, mine = process_index(), None
    for line in lines.tolist():
        group = dist.new_group(line, timeout=datetime.timedelta(
            seconds=GROUP_TIMEOUT_S)) if in_group() else None
        if me in line:
            mine = (line.index(me), line, group)
    return mine


def host_local_slice(global_index: int, world: int, n: int) -> range:
    """The contiguous share of ``n`` items that process ``global_index``
    of ``world`` takes (the DistributedSampler analog); the shares cover
    every item."""
    per = (n + world - 1) // world
    lo = global_index * per
    return range(lo, min(lo + per, n))


def in_group() -> bool:
    """True inside an initialized ``torch.distributed`` process group."""
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    return dist.get_rank() if in_group() else 0


def process_count() -> int:
    return dist.get_world_size() if in_group() else 1


def local_index() -> int:
    """This process's index on its host: the launcher's ``LOCAL_RANK``,
    else its rank; 0 without a group."""
    if not in_group():
        return 0
    return int(os.environ.get("LOCAL_RANK", dist.get_rank()))


def is_chief() -> bool:
    return process_index() == 0


def collective_device() -> torch.device:
    """Where the group's collectives take their tensors: the current card
    under NCCL, the host otherwise."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_reduced(x: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """A copy of ``x``, reduced by ``op`` over the group's ranks, on
    ``x``'s device (staged through the collective's device), without
    gradient."""
    y = x.detach().to(collective_device(), copy=True)
    dist.all_reduce(y, op=op)
    return y.to(x.device)


def all_processes_mean(local_sum: float, local_count: float) -> float:
    """The mean over every process of the group of (sum, count) pairs
    (the reference's all_reduce of the validation loss,
    train_distributed.py:119-120); sum / count without a group."""
    if process_count() == 1:
        return local_sum / max(local_count, 1.0)
    total, count = all_reduced(torch.tensor(
        [local_sum, local_count], dtype=torch.float64)).tolist()
    return total / max(count, 1.0)


class _AllReduceSum(torch.autograd.Function):
    """Sum over the group's ranks, whose gradient is the sum of the ranks'
    gradients: each rank's loss is its share of one global loss, so the
    gradient of the global loss with respect to a rank's input gathers
    every rank's cotangent of the sum."""

    @staticmethod
    def forward(ctx, x):
        return all_reduced(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduced(g)


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over every rank of the group, differentiable."""
    return _AllReduceSum.apply(x)
