"""Starting and joining process groups.

- :func:`spawn` runs ``fn(*args)`` in ``world`` new processes (a
  ``spawn`` context), rank r in the r-th, each joined to one group on a
  free localhost port, and returns their results in rank order. A rank
  that raises or dies ends the others at once (killed by PID) and raises
  here: a rank left waiting in a collective never hangs the caller.
- :func:`join_from_env` joins the group a launcher such as ``torchrun``
  describes (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
  ``MASTER_PORT``), the counterpart of ``jax.distributed.initialize()``.
- :func:`build_once` builds the CUDA kernels and the native RIR engine in
  the calling process, so that the ranks it starts find them built
  (``kernels/_build.py`` and ``data/rir_native.py`` reuse a library whose
  digest matches) instead of each running its own compiler.

Every group gets a timeout: a collective that waits longer raises.
"""

from __future__ import annotations

import datetime
import multiprocessing
import os
import queue
import socket
import time
import traceback
from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

GROUP_TIMEOUT_S = 600.0


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def default_backend(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def join_from_env(backend: str) -> None:
    """Join the group that the environment describes (``env://``)."""
    dist.init_process_group(
        backend, init_method="env://",
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))


def build_once(cuda: bool) -> None:
    """Build (or find built) the native RIR engine and, with ``cuda``, the
    kernel library, in this process."""
    from eabnet_tpu_torch.data.rir_native import native_available

    native_available()
    if cuda:
        from eabnet_tpu_torch.kernels._build import load_library

        load_library()


def _rank_main(fn, rank: int, world: int, port: int, backend: str,
               args: tuple, results) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    try:
        dist.init_process_group(
            backend, init_method=f"tcp://localhost:{port}", rank=rank,
            world_size=world,
            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
        results.put((rank, True, fn(*args)))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn: Callable, world: int, args: Sequence = (),
          backend: str = "nccl", timeout_s: Optional[float] = None) -> List:
    """``[fn(*args) of rank r for r in range(world)]``, each rank in its own
    spawned process inside one group of ``backend``. ``fn`` must be
    importable (a module-level function), and a script that calls this
    does so under ``if __name__ == "__main__":``. Raises RuntimeError with
    the rank's traceback when a rank fails, TimeoutError after
    ``timeout_s`` seconds in all."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, args=(
        fn, r, world, port, backend, tuple(args), results))
        for r in range(world)]
    deadline = None if timeout_s is None else time.monotonic() + timeout_s
    grace = None  # a rank that failed may still be sending its traceback
    out = {}
    try:
        for p in procs:
            p.start()
        while len(out) < world:
            try:
                rank, ok, value = results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in out]
                if dead and grace is None:
                    grace = time.monotonic() + 5.0
                if dead and time.monotonic() > grace:
                    raise RuntimeError(
                        f"rank(s) {dead} exited with "
                        f"{[procs[r].exitcode for r in dead]} and no result")
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(
                        f"ranks {sorted(set(range(world)) - set(out))} gave "
                        f"no result within {timeout_s:g} s")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {world} failed:\n{value}")
            out[rank] = value
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(timeout=10)
        results.close()
    return [out[r] for r in range(world)]
