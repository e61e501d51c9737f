"""Training: back-to-back steps of the program's train step on a ring of
batches staged on the device.

Set-up draws the weights, builds one training state
(``create_train_state``, the weights loaded through ``load_jax_params``)
and one step (``make_train_step``), and drives that state through its
first ``check.steps`` steps on the ring's first batches, reading what
the comparison needs: each step's losses, the Adam moment after step 1
(the first gradient as the optimizer got it, clipped) and each leaf's
change after the last of them. The same state then runs the window's
steps without a host read of its own (the program syncs once a step, in
its clip); the window ends with a device sync and the losses are read
after it. A traced run first times as many steps untraced as it traces,
on the same batches, so that the per-layer shares divide by the step's
own time and not by the profiler's. Once the window has closed and the
program's state is freed, the plain reference runs the same first steps
from the same weights in float32, in blocks of rows, and the gaps are
measured (``compare``).
"""

from __future__ import annotations

import contextlib
import math
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark import harness, traffic, weights
from benchmark.reference import train as ref_train
from benchmark.reference.model import Composed
from benchmark.trace import Window

B1 = ref_train.B1
LOSSES = ("eabnet", "postnet", "final")


def experiment(cell: harness.Cell):
    """The program's configuration of the cell: the model as released,
    in the training phase the configuration file states, with the
    recorded learning rate, clip and compute dtype."""
    from eabnet_tpu_torch.config import ExperimentConfig

    cfg = cell.config
    model = dict(cfg["model"])
    model.update({k: v for k, v in cfg["training_phase"].items()
                  if k != "why"})
    train = {k: cfg["train"][k] for k in ("lr", "grad_clip",
                                          "compute_dtype")}
    return ExperimentConfig.from_dict({"model": model, "stft": cfg["stft"],
                                       "train": train}), model


def norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {n: float(torch.linalg.vector_norm(t.double()))
            for n, t in tensors.items()}


def gaps(got: Dict[str, float], want: Dict[str, float], leaves
         ) -> List[float]:
    """Per leaf, |got - want| over the larger of want's norm of that leaf
    and of the median leaf (inf where got is not a number)."""
    median = float(np.median([want[n] for n in want]))
    out = []
    for n in leaves:
        g = got.get(n, float("nan"))
        out.append(abs(g - want[n]) / max(want[n], median, 1e-30)
                   if math.isfinite(g) else float("inf"))
    return out


def live_leaves(ref: Dict) -> List[str]:
    """The leaves whose reference gradient is at least a thousandth of
    the median leaf's: smaller ones (a conv's bias right before an
    instance norm, which takes out what it adds) are rounding alone, and
    Adam moves them by rounding alone."""
    g = ref["grad"]
    floor = 1e-3 * float(np.median(list(g.values())))
    return [n for n, v in g.items() if v >= floor]


def loss_gaps(prog: Dict, ref: Dict) -> List[float]:
    """Per step, the largest relative gap of the three losses."""
    out = []
    for p, r in zip(prog["losses"], ref["losses"]):
        out.append(max(abs(p[k] - r[k]) / abs(r[k]) if math.isfinite(p[k])
                       else float("inf") for k in LOSSES))
    return out + [float("inf")] * (len(ref["losses"]) - len(out))


def grad_errors(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor],
                leaves) -> List[float]:
    """Per leaf, the norm of (got - want) over want's norm: the first
    gradient's error, which a norm's gap sees only along the gradient."""
    out = []
    for n in leaves:
        if n not in got or not bool(torch.isfinite(got[n]).all()):
            out.append(float("inf"))
            continue
        d = torch.linalg.vector_norm((got[n] - want[n]).double())
        out.append(float(d) / max(float(torch.linalg.vector_norm(
            want[n].double())), 1e-30))
    return out


def block_weights(got: Dict[str, torch.Tensor], blocks: List[Dict],
                  leaves) -> np.ndarray:
    """The weights a (one per block of rows) of the least-squares fit
    got ~ sum_k a_k blocks[k] over the leaves' elements."""
    k = len(blocks)
    dev = got[leaves[0]].device
    gram = torch.zeros(k, k, dtype=torch.float64, device=dev)
    rhs = torch.zeros(k, dtype=torch.float64, device=dev)
    for n in leaves:
        b = torch.stack([blk[n].reshape(-1) for blk in blocks]).double()
        gram += b @ b.T
        rhs += b @ got[n].reshape(-1).double()
    return torch.linalg.solve(gram, rhs).cpu().numpy()


def block_gap(got: Dict[str, torch.Tensor], blocks: List[Dict], leaves
              ) -> float:
    """How unevenly the first gradient weighs the batch's blocks of rows:
    the largest gap of a block's fitted weight from their mean, over the
    mean. The reference's gradient is the blocks' sum, so a sound step
    reads near 0; with half of the batch left out (the mean over the
    rest) the kept blocks weigh 2 and the others 0, and it reads 1."""
    if any(n not in got or not bool(torch.isfinite(got[n]).all())
           for n in leaves):
        return float("inf")
    a = block_weights(got, blocks, leaves)
    mean = float(np.mean(a))
    return float(np.max(np.abs(a - mean)) / abs(mean)) if mean else \
        float("inf")


def total_error(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor],
                leaves) -> float:
    """The norm of (got - want) over want's norm, all live leaves as one
    vector (inf where got is not a number)."""
    d = w = 0.0
    for n in leaves:
        if n not in got or not bool(torch.isfinite(got[n]).all()):
            return float("inf")
        d += float(torch.sum((got[n] - want[n]).double() ** 2))
        w += float(torch.sum(want[n].double() ** 2))
    return math.sqrt(d / max(w, 1e-300))


def first_step(prog: Dict, ref: Dict) -> Dict[str, float]:
    """The numbers read on the first step alone: its largest relative
    loss gap; its gradient's relative error, at the median live leaf, at
    the first quartile's and over all of them as one vector (the
    precision below the configuration's fails one); and the blocks'
    weights in it (half of the batch left out fails it). A cell's
    workload file names the ones it compares."""
    live = live_leaves(ref)
    errs = grad_errors(prog["first"], ref["first"], live)
    return {"loss_gap": loss_gaps(prog, ref)[0],
            "grad_err": float(np.median(errs)),
            "grad_err_q25": float(np.quantile(errs, 0.25)),
            "grad_err_all": total_error(prog["first"], ref["first"], live),
            "block_gap": block_gap(prog["first"], ref["blocks"], live)}


def compare(prog: Dict, ref: Dict) -> Dict[str, float]:
    """The numbers read: ``first_step``'s and the worst live leaf's gap
    of the change's norm after the first steps (a state left unchanged
    fails it). (The later steps' losses and the gradient's
    norms swing with bf16 rounding and no control or fault separates
    them: ``look``.)"""
    live = live_leaves(ref)
    return {**first_step(prog, ref),
            "change_gap": max(gaps(prog["change"], ref["change"], live))}


def look(prog: Dict, ref: Dict) -> Dict[str, float]:
    """What the compared numbers leave out: every step's loss gap, the
    median and the worst live leaf of the first gradient's norm, the
    median and the worst leaf of the change, the blocks' fitted weights,
    and the leaves left out."""
    live = live_leaves(ref)
    g = gaps(prog["grad"], ref["grad"], live)
    c = gaps(prog["change"], ref["change"], live)
    return {"loss_gaps": loss_gaps(prog, ref),
            "grad_median": float(np.median(g)), "grad_worst": max(g),
            "grad_worst_leaf": live[int(np.argmax(g))],
            "change_median": float(np.median(c)),
            "change_worst_leaf": live[int(np.argmax(c))],
            "change_worst_ref": ref["change"][live[int(np.argmax(c))]],
            "change_median_ref": float(np.median(
                [ref["change"][n] for n in live])),
            "block_weights": block_weights(prog["first"], ref["blocks"],
                                           live).tolist(),
            "left_out": len(ref["grad"]) - len(live)}


def reference(cell, model_cfg, ref_model, batches, block, rows=None,
              within=contextlib.nullcontext):
    """The reference's readings of the first steps (``rows``: the rows
    its loss takes; ``within``: the context of each gradient's
    computation, a control's or a witness's precision)."""
    from benchmark.reference.precision import float32_products

    cfg = cell.config
    with float32_products():
        losses, first, blocks, change, seen = ref_train.run_steps(
            ref_model, cfg["stft"], batches, cfg["train"]["lr"],
            cfg["train"]["grad_clip"], block, rows, within)
    return {"losses": losses, "grad": norms(first), "first": first,
            "blocks": blocks, "change": norms(change), "seen": seen}


def setup(cell: harness.Cell, seed: int, device):
    """-> (experiment, model config, state, step, reference model, ring
    of batches on the device)."""
    from eabnet_tpu_torch.train.step import create_train_state, \
        make_train_step
    from eabnet_tpu_torch.weights import load_jax_params

    exp, model_cfg = experiment(cell)
    tr = cell.workload["traffic"]
    ref = Composed(model_cfg)
    drawn = weights.draw(ref, seed, device)
    state = create_train_state(exp, device=device)
    load_jax_params(state.model, weights.jax_tree(ref, drawn))
    step = make_train_step(exp)
    sr = cell.config["stft"]["sr"]
    corpus = traffic.load_corpus(cell.root / tr["corpus"],
                                 model_cfg["eabnet"]["M"], sr)
    host = traffic.train_ring(corpus, tr, sr, seed)
    ring = [(torch.from_numpy(n).to(device), torch.from_numpy(c).to(device))
            for n, c in host]
    return exp, model_cfg, state, step, ref, ring


def first_steps(state, step, ring, n: int):
    """Drive the state through its first ``n`` steps (the window's own
    call and feed) -> (state, the program's readings: each step's
    losses, the first gradient by leaf as Adam's first moment holds it,
    and its norms, each leaf's change's norm)."""
    params = dict(state.model.named_parameters())
    start = {k: p.detach().clone() for k, p in params.items()}
    losses, first = [], None
    for k in range(n):
        state, ls = step(state, *ring[k % len(ring)])
        losses.append(ls)
        if k == 0:
            first = {name: m.detach() / (1 - B1)
                     for name, m in state.opt_state.mu.items()}
    change = norms({k: p.detach() - start[k] for k, p in params.items()})
    return state, {"losses": [{k: float(v[k]) for k in LOSSES}
                              for v in losses],
                   "grad": norms(first), "first": first, "change": change}


def run(cell: harness.Cell, seed: int, seconds: float, trace: bool,
        device="cuda"):
    """One run: -> (result line without its checks, the checks, the
    forbidden modules found once the window closed)."""
    wl = cell.workload
    n_check = wl["check"]["steps"]
    exp, model_cfg, state, step, ref, ring = setup(cell, seed, device)
    state, prog = first_steps(state, step, ring, n_check)
    harness.sync(device)
    setup_s = harness.process_seconds()
    plain_s = None
    if trace:  # the traced steps' batches, untraced, for the step's time
        t0 = time.perf_counter()
        for j in range(wl["trace_steps"]):
            state, _ = step(state, *ring[(n_check + j) % len(ring)])
        harness.sync(device)
        plain_s = (time.perf_counter() - t0) / wl["trace_steps"]
    steps: List = []
    with Window(trace, device) as w:
        deadline = time.perf_counter() + seconds
        while time.perf_counter() < deadline and not (
                trace and len(steps) >= wl["trace_steps"]):
            i = n_check + len(steps)
            state, ls = step(state, *ring[i % len(ring)])
            steps.append(ls)
    failed = sum(1 for ls in steps if not math.isfinite(float(ls["final"])))
    found = harness.forbidden_modules()
    b, n = ring[0][0].shape[0], ring[0][0].shape[-1]
    hop = int(cell.config["stft"]["win_shift"] * cell.config["stft"]["sr"])
    calls = [{"rows": b, "frames": 1 + n // hop}] * len(steps)
    result = {"attempted": len(steps), "failed": failed}
    if torch.device(device).type == "cuda":
        result["device"] = harness.device_description(cell.chips)
    batches = [ring[k % len(ring)] for k in range(n_check)]
    del state, step
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    readings = compare(prog, reference(cell, model_cfg, ref, batches,
                                       wl["check"]["block"]))
    checks = [harness.Check(k, readings[k], v)
              for k, v in wl["limits"].items()]
    if trace:
        harness.traced(result, cell, harness.Context(
            w.trace, calls, cell.config,
            cell.config["train"]["compute_dtype"], plain_s))
    else:
        result["metrics"] = {
            "train_step_ms": harness.metric(
                1e3 * w.seconds / max(len(steps), 1), "ms"),
            "setup_s": harness.metric(setup_s, "s")}
    result["correct"] = all(c.ok for c in checks) and not found \
        and failed == 0 and len(steps) > 0
    return result, checks, found
