"""Where a step of the first LSTM-BF forward design goes, on the card.

    python -m eabnet_tpu_torch.tools.lstm_fwd_split [--out PATH]

Builds ``lstm_fwd_split.cu`` (the first design with clock64() counters)
by its own ``nvcc -shared`` into ``build/lstm_fwd_split/`` and runs it at
T = 701 for the serving shapes, each with the lanes per block of the first
design (a power of two) and with the SM count's (one wave): clocks per step
of each phase's work and barrier wait (mean over the warps of every block),
once in full and once each with the weight loads, the h loads or both
knocked out. Also the kernel's time without counters (CUDA events) and its
largest difference from the plain version; and, for each L, the time of
this package's kernel (``double_lstm``), its clocks per step and their
ratio to the FFMA throughput floor of its lanes per block (384 clocks per
lane-step: 256 threads x 192 FFMA on 4 schedulers of 32 lanes). Writes the
numbers as JSON to PATH (default ``build/lstm_fwd_split/split.json``).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
PHASES = ("l1 product", "wait", "l1 cell", "wait", "l2 product", "wait",
          "l2 cell+store", "wait")
MODES = ("full", "no weight loads", "no h loads", "neither")
CASES = [(161, 2), (1127, 16), (1127, 9), (1288, 16), (1288, 10),
         (2576, 16), (2576, 20)]


def build() -> ctypes.CDLL:
    out = os.path.join(ROOT, "build", "lstm_fwd_split")
    os.makedirs(out, exist_ok=True)
    lib = os.path.join(out, "libsplit.so")
    cmd = ["/usr/local/cuda/bin/nvcc", "-gencode",
           "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", lib,
           os.path.join(HERE, "lstm_fwd_split.cu")]
    log = subprocess.run(cmd, capture_output=True, text=True)
    if log.returncode:
        raise RuntimeError(log.stdout + log.stderr)
    for line in (log.stdout + log.stderr).splitlines():
        if "registers" in line or "spill" in line:
            print("  " + line.strip())
    so = ctypes.CDLL(lib)
    so.split_fwd.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    so.split_fwd.restype = ctypes.c_int
    return so


def events_ms(fn, reps: int = 10) -> float:
    """Mean milliseconds per call of fn over reps calls (CUDA events)."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=os.path.join(
        ROOT, "build", "lstm_fwd_split", "split.json"))
    out = ap.parse_args().out
    if not torch.cuda.is_available():
        print("lstm_fwd_split: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from eabnet_tpu_torch.kernels.lstm_bf import (double_lstm,
                                                  double_lstm_reference,
                                                  fwd_lanes_per_block)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    so = build()
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    t = 701
    g = torch.Generator(device="cuda").manual_seed(0)
    w1, wi2, wh2 = (torch.randn(64, 256, generator=g, device="cuda") * 0.2
                    for _ in range(3))
    b2 = torch.randn(256, generator=g, device="cuda") * 0.2
    w2 = torch.cat([wi2, wh2]).contiguous()
    stream = torch.cuda.current_stream().cuda_stream
    results, package = [], {}
    torch.set_grad_enabled(False)
    for lanes, lb in CASES:
        xw1 = torch.randn(t, lanes, 256, generator=g, device="cuda")
        h2 = torch.empty(t, lanes, 64, device="cuda")
        blocks = -(-lanes // lb)
        clk = torch.zeros(blocks * 8 * 8, dtype=torch.int64, device="cuda")
        cal = torch.zeros(2, dtype=torch.int64, device="cuda")

        def run(mode, clk_on):
            err = so.split_fwd(xw1.data_ptr(), w1.data_ptr(), w2.data_ptr(),
                               b2.data_ptr(), h2.data_ptr(), clk.data_ptr(),
                               cal.data_ptr(), t, lanes, lb, mode, clk_on,
                               stream)
            if err:
                raise RuntimeError(f"launch failed: CUDA error {err}")

        run(0, 0)
        ref = double_lstm_reference(xw1, w1, wi2, wh2, b2)
        err = (h2 - ref).abs().max().item()
        ms = events_ms(lambda: run(0, 0))
        row = dict(L=lanes, LB=lb, blocks=blocks,
                   waves=-(-blocks // n_sm), ms=ms,
                   us_per_step=ms * 1e3 / t, max_abs_err=err, modes={})
        print(f"L={lanes} LB={lb}: {blocks} blocks ({row['waves']} wave(s) "
              f"of {n_sm} SMs), {ms:.4f} ms = {ms * 1e3 / t:.3f} us per "
              f"step without counters, max|kernel-plain| {err:.2e}")
        for mode, name in enumerate(MODES):
            run(mode, 1)
            torch.cuda.synchronize()
            per = clk.view(blocks, 8, 8).double().mean(dim=(0, 1)) / t
            ghz = cal[0].item() / cal[1].item()
            seg = per.tolist()
            row["modes"][name] = dict(clocks=seg, ghz=ghz)
            print(f"  {name:16s} {sum(seg):7.0f} clk/step ({ghz:.3f} GHz, "
                  f"{sum(seg) / ghz / 1e3:.3f} us): " + ", ".join(
                      f"{p} {c:.0f}" for p, c in zip(PHASES, seg)))
        results.append(row)
        if lanes in package:
            continue
        ms = events_ms(lambda: double_lstm(xw1, w1, wi2, wh2, b2))
        lb_new = fwd_lanes_per_block(lanes)
        clocks = ms * 1e6 / t * row["modes"][MODES[0]]["ghz"]
        package[lanes] = dict(LB=lb_new, ms=ms, us_per_step=ms * 1e3 / t,
                              clocks_per_step=clocks,
                              ffma_floor_share=384 * lb_new / clocks)
        print(f"L={lanes} double_lstm: LB={lb_new}, {ms:.4f} ms = "
              f"{ms * 1e3 / t:.3f} us per step = {clocks:.0f} clk, FFMA "
              f"floor {384 * lb_new} clk ({384 * lb_new / clocks:.2f})")
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump(dict(device=smi, T=t, phases=PHASES, cases=results,
                       package=package), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
