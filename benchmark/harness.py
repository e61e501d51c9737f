"""What every cell shares: finding a cell's files by name, the set-up
clock, the device's description, the per-layer readers, the guard
against JAX in the process, and the result line.

A cell is an entry of ``BENCHMARK.json``'s ``workloads``. By its name the
harness finds ``benchmark/configs/<config>.json`` (the model's sizes),
``benchmark/workloads/<cell>.json`` (the traffic's parameters, the
driver that runs it, the limits of its comparison) and, for each
per-layer metric the cell reports, ``benchmark/metrics/<metric>.py``
(a reader with ``read(ctx) -> number or None``). Nothing here names a
cell.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "eabnet_tpu")


@dataclass
class Cell:
    name: str
    chips: int
    config: Dict
    workload: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]
    root: Path = field(default=BENCH_DIR.parent)


def load_spec(root: Path) -> Dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _reports(metric: Dict, cell: str, e2e: List[str]) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves") in e2e


def find_cell(name: str, root: Path = BENCH_DIR.parent) -> Cell:
    """The cell ``name`` of ``root``'s BENCHMARK.json with its files."""
    spec = load_spec(root)
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"({sorted(cells)})")
    w = cells[name]
    bench = root / "benchmark"
    with open(bench / "configs" / f"{w['config']}.json") as f:
        config = json.load(f)
    with open(bench / "workloads" / f"{name}.json") as f:
        workload = json.load(f)
    e2e = [m for m in spec["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    names = [m["name"] for m in e2e]
    per_layer = [m for m in spec["per_layer"] if _reports(m, name, names)]
    return Cell(name, int(w["chips"]), config, workload, e2e, per_layer,
                root)


def metric_reader(name: str, root: Path) -> Callable:
    """``read(ctx)`` of ``benchmark/metrics/<name>.py``."""
    path = root / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def process_seconds() -> float:
    """Seconds since this process started (its start time from /proc;
    the interpreter's own start-up included)."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        with open("/proc/uptime") as f:
            return float(f.read().split()[0]) - start
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _IMPORTED


_IMPORTED = time.perf_counter()


def forbidden_modules() -> List[str]:
    """Top-level names of loaded modules that this process must not
    hold (compared whole: ``eabnet_tpu_torch`` is not ``eabnet_tpu``)."""
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


def quantile(values: List[float], q: float) -> float:
    """Linear interpolation between the closest ranks (numpy's default)."""
    v = sorted(values)
    if not v:
        raise ValueError("no values")
    pos = q * (len(v) - 1)
    lo = int(math.floor(pos))
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def sync(device) -> None:
    """Wait for the device's queued work (a no-op on the CPU)."""
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def device_description(chips: int) -> Dict:
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips,
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(d)
                                     for d in range(chips))}


def power_limit() -> str:
    """nvidia-smi's name and power limit of the card, or "not read"."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout else \
            "not read"
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


@dataclass
class Check:
    """One number compared: the run is correct only where ``value`` is at
    most ``limit`` (and is a number)."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


def emit(result: Dict, checks: List[Check]) -> None:
    """The checks as the last lines of standard error, then the result
    line (the checks last in it) as the last line of standard output."""
    for c in checks:
        print(f"check {c.name}: {c.value!r} (limit {c.limit!r}) "
              f"{'ok' if c.ok else 'FAILED'}", file=sys.stderr)
    result = dict(result)
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                        for c in checks}
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


def metric(value: float, unit: str) -> Dict:
    return {"value": value, "unit": unit}


def read_per_layer(cell: Cell, ctx) -> Dict[str, Dict]:
    """Each per-layer metric of the cell that finds something to read."""
    out = {}
    for m in cell.per_layer:
        value = metric_reader(m["name"], cell.root)(ctx)
        if value is not None:
            out[m["name"]] = metric(value, m["unit"])
    return out


def traced(result: Dict, cell: Cell, ctx) -> None:
    """Fill a traced run's result: the per-layer metrics, the device's
    busy seconds and the window, and the breakdown (the ten largest
    kinds of device work and idle gaps)."""
    from benchmark.trace import by_category, idle_gaps

    result["metrics"] = read_per_layer(cell, ctx)
    if ctx.trace is not None:
        result["device"]["busy_s"] = ctx.trace.busy_s()
        result["device"]["window_s"] = ctx.trace.window_s
        result["breakdown"] = {"device_ops": by_category(ctx.trace)[:10],
                               "idle_gaps": idle_gaps(ctx.trace)[:10]}


@dataclass
class Context:
    """What a per-layer reader reads: the traced window (``trace``, a
    ``trace.Trace``, or None where the profiler recorded no device
    event), the calls or steps inside it (``calls``: per call, the rows,
    the frames each row was computed over and, serving, the unpadded
    frames), the configuration file's content, the compute dtype, and
    the seconds a call or step of the same work took untraced just
    before (``plain_s``: the profiler stretches the traced window, so a
    share of the call's or step's time divides by this)."""

    trace: object
    calls: List[Dict]
    config: Dict
    dtype: str
    plain_s: Optional[float] = None

    def frame_flops(self) -> float:
        from benchmark.flops import frame_flops

        stft = self.config["stft"]
        return frame_flops(self.config["model"], stft["fft_num"] // 2 + 1)

