"""Run one cell of the benchmark and print its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The cell, its configuration, its traffic
and its per-layer metrics are found by name (``harness.py``); the
workload file names the driver (``benchmark/drivers/<driver>.py``) that
runs it. With ``--trace 0`` the line carries the cell's end-to-end
metrics, with ``--trace 1`` its per-layer metrics read from a profiled
window. The run exits non-zero, printing no result, where there is no
CUDA device or fewer than the cell asks for, or where a module of JAX or
of the JAX package is loaded once the window has closed.
"""

from __future__ import annotations

import argparse
import importlib
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
# every build and kernel cache at a fixed path inside the checkout
CACHES = {"TORCH_EXTENSIONS_DIR": "torch_extensions",
          "TRITON_CACHE_DIR": "triton",
          "PYTORCH_KERNEL_CACHE_PATH": "torch_kernels"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for var, sub in CACHES.items():
        os.environ[var] = str(ROOT / "build" / "benchmark_cache" / sub)
        os.makedirs(os.environ[var], exist_ok=True)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from benchmark import harness

    cell = harness.find_cell(args.workload, ROOT)
    import torch

    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA device(s); {cards} "
              "found", file=sys.stderr)
        return 3
    driver = importlib.import_module(
        f"benchmark.drivers.{cell.workload['driver']}")
    result, checks, found = driver.run(cell, args.seed, args.seconds,
                                       bool(args.trace), device="cuda")
    found = sorted(set(found) | set(harness.forbidden_modules()))
    if found:
        print(f"modules that must not be loaded: {found}", file=sys.stderr)
        return 4
    result["device"]["power_limit"] = harness.power_limit()
    harness.emit(result, checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
