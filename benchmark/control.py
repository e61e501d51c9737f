"""Readings that set a cell's limits: the program's, its control's and
(for training) a planted fault's, on several seeds in one process.

    python3 -m benchmark.control --workload <cell> --seeds 1 2 3 \
        [--calls 32] [--device cuda]

Per seed, at the cell's own sizes:

- serving: the program serves the first ``--calls`` batches of the
  seed's ring; for the calls that a run samples, the number compared
  (``wav_err``) of the program against the float32 reference, and of
  the control against it: the reference with every product's operands
  rounded to TF32, the precision below the float32 the configuration
  states;
- training: the program's first steps against the float32 reference
  (``loss_gap``, ``grad_err``, ``block_gap``, ``change_gap``, and what
  ``look`` reads). On the first step alone (the numbers that they must
  fail are the first step's): the control, the reference computed one
  step below the configuration's bf16 as fp8 training computes (every
  product's operands and their gradients in float8 e4m3, every other
  operation's output in bf16: ``precision.fp8_training``); the fault of half
  the batch left out, the loss the mean over the other half, planted in
  the reference put in the program's place (a state left unchanged
  reads 1 on the change by construction); and, on the first
  ``--witnesses`` seeds, a second witness, the reference with every
  operation of its gradient computed in bf16, which shows how far bf16
  alone takes the gradient from float32's. The control and the witness
  report how many operations they rounded, how many of them were the
  backward's, and on how many threads.

One JSON line per seed. The benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def serve_readings(cell, seed: int, calls: int, device,
                   control: bool = True) -> dict:
    import torch

    from benchmark.drivers import serve

    enh, ref, ring = serve.setup(cell, seed, device)
    done, outs = [], []
    for i in range(calls):
        batch = ring[i % len(ring)]
        outs.append(enh.enhance_batch(batch))
        done.append({"ring": i % len(ring),
                     "longest": max(w.shape[-1] for w in batch)})
    del enh
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    prog = ctrl = 0.0
    for i in serve.sample_calls(done, cell.workload["check"]["calls"],
                                seed):
        batch = ring[done[i]["ring"]]
        want = serve.reference_outputs(cell, ref, batch, device)
        prog = max(prog, serve.wav_error(outs[i], want))
        if control:
            ctrl = max(ctrl, serve.wav_error(serve.reference_outputs(
                cell, ref, batch, device, rounding="tf32"), want))
    out = {"program": {"wav_err": prog}}
    if control:
        out["control_tf32"] = {"wav_err": ctrl}
    return out


def train_readings(cell, seed: int, device, control: bool = True,
                   witness: bool = False) -> dict:
    import torch

    from benchmark import weights
    from benchmark.drivers import train
    from benchmark.reference.precision import bf16, every_op, fp8_training

    wl = cell.workload
    n, block = wl["check"]["steps"], wl["check"]["block"]
    exp, model_cfg, state, step, ref, ring = train.setup(cell, seed, device)
    state, prog = train.first_steps(state, step, ring, n)
    del state, step
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    batches = [ring[k % len(ring)] for k in range(n)]
    base = train.reference(cell, model_cfg, ref, batches, block)
    readings = {"program": train.compare(prog, base),
                "look": train.look(prog, base)}
    runs = []
    if control:
        runs += [("control_fp8", {"within": lambda: fp8_training(ref)}),
                 ("fault_half_batch",
                  {"rows": range(ring[0][0].shape[0] // 2)})]
    if witness:
        runs += [("witness_bf16", {"within": lambda: every_op(bf16)})]
    for name, kw in runs:
        weights.draw(ref, seed, device)  # every run from the same weights
        r = train.reference(cell, model_cfg, ref, batches[:1], block, **kw)
        readings[name] = train.first_step(r, base)
        readings[name]["block_weights"] = train.block_weights(
            r["first"], base["blocks"], train.live_leaves(base)).tolist()
        if r["seen"] is not None:
            readings[name]["rounded"] = {
                "ops": r["seen"]["ops"], "backward": r["seen"]["backward"],
                "threads": len(r["seen"]["threads"])}
    return readings


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--calls", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--controls", type=int, default=None,
                    help="run the control and the fault on the first N "
                    "seeds only (default: every seed)")
    ap.add_argument("--witnesses", type=int, default=0,
                    help="run the bf16 witness on the first N seeds")
    args = ap.parse_args(argv)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from benchmark import harness

    cell = harness.find_cell(args.workload, ROOT)
    for k, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        control = args.controls is None or k < args.controls
        if cell.workload["driver"] == "serve":
            r = serve_readings(cell, seed, args.calls, args.device, control)
        else:
            r = train_readings(cell, seed, args.device, control,
                               k < args.witnesses)
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "seconds": round(time.perf_counter() - t0, 1),
                          **r}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
