#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (eabnet_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each announced with its elapsed seconds:

1. device: the card's name and power limit (nvidia-smi), torch and CUDA.
2. build: the one nvcc call that builds every kernel, with the register,
   shared-memory and spill lines of -Xptxas -v.
3. kernels: each hand-written kernel against its plain PyTorch version on
   the card, at the shapes of the main path, with the release weights and
   seeded inputs; its time (CUDA events), the plain version's, the library
   yardstick's where one PyTorch call computes the same function, and the
   bound: max(FLOPs / 67 TFLOP/s, bytes / 3.35 TB/s), the H100 SXM f32
   non-tensor peak and memory rate.
4. slice: release/composed_9mic through load_enhancer on the card. One item
   alone, with the kernels' launch counts read around that forward and the
   output held against the JAX package's golden; then the 7 validation
   items as one batch, scored by SI-SDR against the clean references, and
   timed.
5. profile: that batch once more under torch.profiler, device time by
   kernel and by category, and the device's idle share.
6. backward (the train phase, part 1): each backward kernel, and the
   LSTM-BF training forward that saves its states, against its plain
   version on the card at the training shapes (T = 601; LSTM L = 1,127 and
   161; TCM chains at B = 7 and 1), seeded inputs and cotangents, release
   weights; times, the plain version's, cuDNN's LSTM backward as the
   yardstick, and the bound. Tolerances are the JAX gradient tests'
   (LSTM 3e-5 / 5e-5, rtol 1e-4; TCM 6e-5, rtol 1e-3), applied per entry
   to d xw1. The weight gradients are sums over ~10^5-10^6 rows, whose
   float32 rounding is relative to the largest terms: against a float64
   run the plain version itself misses the per-entry tolerance, so they
   are held against their output's largest entry. In the TCM chain an
   entry whose PReLU input lies within float32 noise of 0 can take the
   other branch in either version and move many entries downstream, so
   the TCM backward is held in two parts: the forward it recomputes
   against the plain forward (2e-5 plus 1e-5 relative), and its reverse
   walk against the plain reverse walk run on that recomputed forward.
   The PReLU inputs that take the other branch in the two forwards are
   counted: each must lie within the forward tolerance of 0, and where
   there are none the kernel must pass against the plain backward on its
   own forward as well.
7. train (part 2): eabnet_tpu_torch.train.trainer.train from the
   release 40000.params for 5 steps of the 7 val items (batch 7) with the
   config stored in the golden tests/golden/torch_port_train_composed_9mic.npz:
   launches per step, losses against the JAX package's (step 1 within
   1e-5; each loss of later steps within 3x its largest spread in 3 seeded
   runs of the same steps from params one ulp away, as Adam turns float32
   noise into +-lr moves), a run with a planted fault
   (the TCM chain's dalphas zeroed) that these limits must reject, the
   checkpoint written, read back and resumed from (the resumed step against
   a run that did not stop, both with cuDNN's deterministic algorithms),
   step time, and one step profiled (with the trainer's defaults).

The line before the last is the JSON record of the kernels, the last line
{"ok": true, "device": {...}}. Any failed check exits non-zero before them.
The script needs a CUDA device and the repository beside it.
"""

from __future__ import annotations

import faulthandler
import glob
import json
import os
import subprocess
import sys
import time

BUDGET_S = 1100           # a hang dumps every thread's stack and exits
F32_PEAK = 67e12          # H100 SXM f32 (non-tensor) FLOP/s
MEM_RATE = 3.35e12        # H100 SXM HBM3 bytes/s
KERNEL_ATOL = 2e-5        # the JAX kernel tests' forward tolerance
# the JAX kernel tests' gradient tolerances (tests/test_kernels.py,
# tests/test_tcm_chain.py)
LSTM_DX_ATOL, LSTM_DW_ATOL, LSTM_RTOL = 3e-5, 5e-5, 1e-4
TCM_ATOL, TCM_RTOL = 6e-5, 1e-3
GOLDEN_MIN_SNR_DB = 40.0
EXP = "release/composed_9mic"
VAL = "release/val_set"
GOLDEN = "tests/golden/torch_port_composed_9mic_00000.npz"
TRAIN_T = 601  # frames of one 6-s training item (96,000 samples)
TRAIN_GOLDEN = "tests/golden/torch_port_train_composed_9mic.npz"
TRAIN_DIR = "build/chip_smoke_train"
TRAIN_STEPS = 5
LOSS_KEYS = ("eabnet", "postnet", "final")
# tests/test_torch_train_step.py's LOSS_RTOL for the port's step against
# the JAX package's; from step 2 on, each loss gets at least this multiple
# of the spread that float32 noise alone gives, over this many seeded runs
# from params one ulp away (see loss_tolerance)
TRAIN_LOSS_RTOL = 1e-5
TRAIN_SPREAD_MARGIN = 3.0
TRAIN_ULP_RUNS = 3

T0 = time.perf_counter()


def say(msg: str) -> None:
    print(f"[{time.perf_counter() - T0:8.2f}s] {msg}", flush=True)


class Phase:
    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        say(f"== phase {self.name}: start")
        return self

    def __exit__(self, exc_type, exc, tb):
        say(f"== phase {self.name}: {'FAILED' if exc_type else 'done'}")
        return False


def require(cond: bool, what: str) -> None:
    say(("PASS " if cond else "FAIL ") + what)
    if not cond:
        raise SystemExit(f"check failed: {what}")


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean milliseconds per call of fn over reps launches (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(flops: float, nbytes: float):
    t_ops, t_mem = flops / F32_PEAK, nbytes / MEM_RATE
    return max(t_ops, t_mem) * 1e3, ("operations" if t_ops >= t_mem
                                     else "bytes")


def snr_db(ref, est) -> float:
    import numpy as np

    return float(10 * np.log10(np.sum(ref ** 2) / np.sum((ref - est) ** 2)))


# ---------------------------------------------------------------- kernels
def lstm_case(bf_map, lanes: int, t: int, seed: int):
    """LSTM-BF kernel vs plain version (and nn.LSTM) at (T, L) lanes."""
    import torch

    from eabnet_tpu_torch.kernels.lstm_bf import (double_lstm,
                                                  double_lstm_reference)

    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((t, lanes, 64), generator=g, device="cuda")
    r1, r2 = bf_map.rnn1, bf_map.rnn2
    xw1 = (x @ r1.w_ih + (r1.b_ih + r1.b_hh)).contiguous()
    args = (xw1, r1.w_hh, r2.w_ih, r2.w_hh, r2.b_ih + r2.b_hh)
    before = double_lstm.launches
    out = double_lstm(*args)
    ref = double_lstm_reference(*args)
    ref64 = double_lstm_reference(*(a.double() for a in args))
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    say(f"lstm_bf T={t} L={lanes}: max|kernel-plain| {err:.3e} (tolerance "
        f"{KERNEL_ATOL:g}), "
        f"max|kernel-f64| {(out.double() - ref64).abs().max().item():.3e}, "
        f"max|plain-f64| {(ref.double() - ref64).abs().max().item():.3e}")
    # the library yardstick: cuDNN's two-layer LSTM from the embeddings,
    # with the same weights (it also computes the layer-1 projection)
    lstm = torch.nn.LSTM(64, 64, num_layers=2).cuda()
    with torch.no_grad():
        for i, r in enumerate((r1, r2)):
            getattr(lstm, f"weight_ih_l{i}").copy_(r.w_ih.t())
            getattr(lstm, f"weight_hh_l{i}").copy_(r.w_hh.t())
            getattr(lstm, f"bias_ih_l{i}").copy_(r.b_ih)
            getattr(lstm, f"bias_hh_l{i}").copy_(r.b_hh)
    lib_out = lstm(x)[0]
    say(f"lstm_bf T={t} L={lanes}: max|nn.LSTM-plain| "
        f"{(lib_out - ref).abs().max().item():.3e}")
    ms = cuda_ms(lambda: double_lstm(*args), reps=20)
    plain = cuda_ms(lambda: double_lstm_reference(*args), reps=2, warmup=1)
    library = cuda_ms(lambda: lstm(x), reps=10)
    double_lstm.launches = before  # comparison launches do not count
    flops = 2.0 * (64 * 256 + 128 * 256) * lanes * t
    nbytes = 4.0 * (t * lanes * 256 + t * lanes * 64 + 192 * 256 + 256)
    bms, by = bound_ms(flops, nbytes)
    say(f"lstm_bf T={t} L={lanes}: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
        f"nn.LSTM {library:.4f} ms, bound {bms:.4f} ms ({by}; "
        f"{flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} MB)")
    return dict(err=err, ms=ms, plain_ms=plain, library_ms=library,
                bound_ms=bms, bound_by=by)


def tcm_case(group, b: int, t: int, seed: int):
    """TCM-chain kernel vs plain version for one group at (B, T)."""
    import torch

    from eabnet_tpu_torch.kernels.tcm_chain import (tcm_chain,
                                                    tcm_chain_reference)

    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((b, t, 256), generator=g, device="cuda")
    w = group.stacked_weights()
    dils, twin = group.dilations, group.twin_gate
    before = tcm_chain.launches
    out = tcm_chain(x, w, dils, twin)
    ref = tcm_chain_reference(x, w, dils, twin)
    ref64 = tcm_chain_reference(x.double(), tuple(v.double() for v in w),
                                dils, twin)
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    name = "twin K=%d" % w[1].shape[1] if twin else \
        "single K=%d" % w[1].shape[1]
    say(f"tcm_chain {name} B={b} T={t}: max|kernel-plain| {err:.3e} "
        f"(tolerance {KERNEL_ATOL:g}), "
        f"max|kernel-f64| {(out.double() - ref64).abs().max().item():.3e}, "
        f"max|plain-f64| {(ref.double() - ref64).abs().max().item():.3e}, "
        f"max|ref| {ref.abs().max().item():.3e}")
    ms = cuda_ms(lambda: tcm_chain(x, w, dils, twin), reps=50)
    plain = cuda_ms(lambda: tcm_chain_reference(x, w, dils, twin), reps=10)
    tcm_chain.launches = before
    p, k, c, d = len(dils), w[1].shape[1], 64, 256
    nb = 2 if twin else 1
    flops = 2.0 * b * t * p * (d * c + nb * k * c * c + c * d)
    # x in, y out, and the weights: wi, the branch convs, wo, and the
    # (p, 3, C) slopes, scales and biases
    nbytes = 4.0 * (2 * b * t * d + p * (d * c + nb * k * c * c + c * d
                                         + 9 * c))
    bms, by = bound_ms(flops, nbytes)
    say(f"tcm_chain {name} B={b} T={t}: kernel {ms:.4f} ms, plain "
        f"{plain:.4f} ms, bound {bms:.4f} ms ({by}; {flops / 1e9:.3f} GFLOP, "
        f"{nbytes / 1e6:.2f} MB)")
    return dict(err=err, ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by)


def tolerance_report(got, ref, ref64, atol: float, rtol: float) -> dict:
    """How got compares with ref under atol + rtol * |ref|: the largest
    difference; its ratio to the tolerance per entry, and with |ref| the
    output's largest entry; the share of entries outside the per-entry
    tolerance; and both versions' largest difference from a float64 run
    of the plain version."""
    diff = (got.double() - ref.double()).abs()
    bound = atol + rtol * ref.double().abs()
    return dict(max=diff.max().item(),
                ratio=(diff / bound).max().item(),
                out=(diff > bound).double().mean().item(),
                normwise=(diff.max() / (atol + rtol * ref.double().abs()
                                        .max())).item(),
                k64=(got.double() - ref64).abs().max().item(),
                p64=(ref.double() - ref64).abs().max().item())


def fmt(reps, key, spec="%.2e"):
    return "[" + ", ".join(spec % r[key] for r in reps) + "]"


def lstm_bwd_case(bf_map, lanes: int, t: int, seed: int):
    """LSTM-BF training forward and backward kernels vs their plain
    versions at (T, L) lanes, with the release weights; the library
    yardstick is cuDNN's two-layer LSTM (forward and backward)."""
    import torch

    from eabnet_tpu_torch.kernels import lstm_bf as K

    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((t, lanes, 64), generator=g, device="cuda")
    dy = torch.randn((t, lanes, 64), generator=g, device="cuda")
    r1, r2 = bf_map.rnn1, bf_map.rnn2
    xw1 = (x @ r1.w_ih + (r1.b_ih + r1.b_hh)).contiguous()
    w = (r1.w_hh, r2.w_ih, r2.w_hh, r2.b_ih + r2.b_hh)
    before = (K.double_lstm.launches, K.double_lstm.bwd_launches)
    states = K._launch_fwd(xw1, *w, states=True)
    ref_states = K.double_lstm_states_reference(xw1, *w)
    fwd_err = max((a - b).abs().max().item()
                  for a, b in zip(states, ref_states))
    got = K._launch_bwd(xw1, dy, *states, *w)
    ref = K.double_lstm_bwd_reference(xw1, dy, *states, *w)
    ref64 = K.double_lstm_bwd_reference(
        *(a.double() for a in (xw1, dy) + tuple(states) + tuple(w)))
    torch.cuda.synchronize()
    rep = [tolerance_report(got[0], ref[0], ref64[0], LSTM_DX_ATOL,
                            LSTM_RTOL)] + [
        tolerance_report(a, b, c, LSTM_DW_ATOL, LSTM_RTOL)
        for a, b, c in zip(got[1:], ref[1:], ref64[1:])]
    err = max(r["max"] for r in rep)
    # d xw1 per entry; the weight gradients, sums over T x L rows, against
    # their largest entry (see the module docstring)
    ok = (fwd_err <= KERNEL_ATOL and rep[0]["ratio"] <= 1.0
          and all(r["normwise"] <= 1.0 for r in rep[1:]))
    say(f"lstm_bf bwd T={t} L={lanes}: training forward max|kernel-plain| "
        f"{fwd_err:.3e}; backward (dxw1, dw_hh1, dw_ih2, dw_hh2, db2): "
        f"max|kernel-plain| {fmt(rep, 'max')}, per-entry tolerance ratio "
        f"{fmt(rep, 'ratio', '%.3f')}, share of entries outside "
        f"{fmt(rep, 'out')}, largest-entry ratio "
        f"{fmt(rep, 'normwise', '%.3f')} (dx atol {LSTM_DX_ATOL:g}, "
        f"weights {LSTM_DW_ATOL:g}, rtol {LSTM_RTOL:g}); max|kernel-f64| "
        f"{fmt(rep, 'k64')}, max|plain-f64| {fmt(rep, 'p64')}")
    lstm = torch.nn.LSTM(64, 64, num_layers=2).cuda()
    with torch.no_grad():
        for i, r in enumerate((r1, r2)):
            getattr(lstm, f"weight_ih_l{i}").copy_(r.w_ih.t())
            getattr(lstm, f"weight_hh_l{i}").copy_(r.w_hh.t())
            getattr(lstm, f"bias_ih_l{i}").copy_(r.b_ih)
            getattr(lstm, f"bias_hh_l{i}").copy_(r.b_hh)
    xg = x.clone().requires_grad_()
    with torch.enable_grad():
        lib_out = lstm(xg)[0]

        def lib_fwd_bwd():
            torch.autograd.backward(lstm(xg)[0], dy)

        def lib_bwd():
            torch.autograd.backward(lib_out, dy, retain_graph=True)

        ms = cuda_ms(lambda: K._launch_bwd(xw1, dy, *states, *w), reps=5)
        fwd_ms = cuda_ms(lambda: K._launch_fwd(xw1, *w, states=True), reps=5)
        plain = cuda_ms(lambda: K.double_lstm_bwd_reference(
            xw1, dy, *states, *w), reps=1, warmup=1)
        library = cuda_ms(lib_bwd, reps=5)
        library_fb = cuda_ms(lib_fwd_bwd, reps=5)
    K.double_lstm.launches, K.double_lstm.bwd_launches = before
    rows = t * lanes
    # recompute both layers' gates (3 products), the three cotangent
    # products and the three weight-gradient products, 64 x 256 each
    flops = 2.0 * 9 * 64 * 256 * rows
    # xw1, dy and the four states in, d xw1 out, weights in and out
    nbytes = 4.0 * (rows * (256 + 64 + 4 * 64 + 256) + 2 * (3 * 64 * 256
                                                             + 256))
    bms, by = bound_ms(flops, nbytes)
    # the training forward: the forward's products, xw1 in, 4 states out
    fwd_bms, fwd_by = bound_ms(2.0 * 3 * 64 * 256 * rows,
                               4.0 * (rows * (256 + 4 * 64) + 3 * 64 * 256
                                      + 256))
    say(f"lstm_bf T={t} L={lanes}: training forward {fwd_ms:.4f} ms, bound "
        f"{fwd_bms:.4f} ms ({fwd_by})")
    say(f"lstm_bf bwd T={t} L={lanes}: kernel {ms:.4f} ms (training "
        f"forward {fwd_ms:.4f} ms), plain {plain:.4f} ms, cuDNN LSTM "
        f"backward {library:.4f} ms (forward + backward {library_fb:.4f} ms "
        f"vs the port's {fwd_ms + ms:.4f} ms), bound {bms:.4f} ms ({by}; "
        f"{flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} MB)")
    return dict(err=err, ok=ok, ms=ms, fwd_ms=fwd_ms, plain_ms=plain,
                library_ms=library, library_fb_ms=library_fb,
                bound_ms=bms, bound_by=by)


def tcm_bwd_case(group, b: int, t: int, seed: int):
    """TCM-chain backward kernel vs its plain version for one group."""
    import torch

    from eabnet_tpu_torch.kernels import tcm_chain as K

    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((b, t, 256), generator=g, device="cuda")
    dy = torch.randn((b, t, 256), generator=g, device="cuda")
    w = tuple(v.detach() for v in group.stacked_weights())
    dils, twin = group.dilations, group.twin_gate
    before = K.tcm_chain.bwd_launches
    dx, dw, acts = K._launch_bwd(x, dy, w, dils, twin, activations=True)
    # the forward the kernel recomputed, against the plain forward
    fwd = K.tcm_chain_activations_reference(x, w, dils, twin)
    pairs = [(acts["x"], fwd["x"]), (acts["h"], fwd["h"])] + [
        (acts["c"][i], fwd["c"][i]) for i in range(2 if twin else 1)]
    fwd_err = max((a - r).abs().max().item() for a, r in pairs)
    # the forward tolerance, plus 1e-5 relative: trunk inputs and
    # activations reach ~50, the group outputs it was set for ~20
    fwd_ok = all(bool(((a - r).abs() <= KERNEL_ATOL + 1e-5 * r.abs()).all())
                 for a, r in pairs)
    # the reverse walk, against the plain one on the kernel's forward (the
    # same PReLU branches); and, reported only, the plain backward that
    # recomputes its own forward, and that one in float64
    rdx, rdw = K.tcm_chain_bwd_reference(x, dy, w, dils, twin, acts=acts)
    pdx, pdw = K.tcm_chain_bwd_reference(x, dy, w, dils, twin)
    r64 = K.tcm_chain_bwd_reference(x.double(), dy.double(),
                                    tuple(v.double() for v in w), dils, twin)
    torch.cuda.synchronize()
    rep = [tolerance_report(a, r, r6, TCM_ATOL, TCM_RTOL)
           for a, r, r6 in zip((dx,) + dw, (rdx,) + rdw, (r64[0],) + r64[1])]
    own = [tolerance_report(a, r, r6, TCM_ATOL, TCM_RTOL)
           for a, r, r6 in zip((dx,) + dw, (pdx,) + pdw, (r64[0],) + r64[1])]
    err = max(r["max"] for r in rep)

    # d x per entry; the weight gradients, sums over B x T rows, against
    # their output's largest entry
    def passes(reports):
        return (reports[0]["ratio"] <= 1.0
                and all(r["normwise"] <= 1.0 for r in reports[1:]))

    # PReLU inputs (h and g) that take the other branch in the two
    # forwards: each must lie within the forward tolerance of 0, and with
    # none the plain backward on its own forward must pass as well
    flips, flip_max, flips_ok = 0, 0.0, True
    for a, r in zip(K.prelu_inputs(acts, twin), K.prelu_inputs(fwd, twin)):
        f = (a > 0) != (r > 0)
        flips += int(f.sum().item())
        if f.any():
            near = torch.maximum(a[f].abs(), r[f].abs())
            flips_ok &= bool((near <= KERNEL_ATOL + 1e-5 * r[f].abs()).all())
            flip_max = max(flip_max, near.max().item())
    ok = (fwd_ok and passes(rep) and flips_ok
          and (flips > 0 or passes(own)))
    name = ("twin" if twin else "single") + " K=%d" % w[1].shape[1]
    zero_ok = twin or (dw[2].abs().max().item() == 0.0
                       and dw[4][:, 1].abs().max().item() == 0.0)
    say(f"tcm_chain bwd {name} B={b} T={t}: recomputed forward "
        f"max|kernel-plain| {fwd_err:.3e}; PReLU inputs of opposite sign "
        f"in the two forwards: {flips} (largest |input| among them "
        f"{flip_max:.3e}, within {KERNEL_ATOL:g} + 1e-5|r| of 0: "
        f"{flips_ok}); (dx, wi, wl, wr, wo, alphas, "
        f"gammas, betas) against the plain reverse walk on the kernel's "
        f"forward: max|kernel-plain| {fmt(rep, 'max')}, per-entry tolerance "
        f"ratio {fmt(rep, 'ratio', '%.3f')}, largest-entry ratio "
        f"{fmt(rep, 'normwise', '%.3f')} (atol {TCM_ATOL:g}, rtol "
        f"{TCM_RTOL:g}); against the plain backward on its own forward "
        f"({'passes' if passes(own) else 'fails'}; required when no input "
        f"changes sign): max|kernel-plain| {fmt(own, 'max')}, per-entry "
        f"tolerance ratio {fmt(own, 'ratio', '%.3f')}, largest-entry ratio "
        f"{fmt(own, 'normwise', '%.3f')}, share of entries outside "
        f"{fmt(own, 'out')}; max|kernel-f64| {fmt(rep, 'k64')}, "
        f"max|plain-f64| {fmt(own, 'p64')}; max|dx| "
        f"{pdx.abs().max().item():.3e}"
        + ("" if twin else f", unused-branch gradients zero: {zero_ok}"))
    ms = cuda_ms(lambda: K._launch_bwd(x, dy, w, dils, twin), reps=10)
    plain = cuda_ms(lambda: K.tcm_chain_bwd_reference(x, dy, w, dils, twin),
                    reps=3, warmup=1)
    K.tcm_chain.bwd_launches = before
    p, k, c, d = len(dils), w[1].shape[1], 64, 256
    nb = 2 if twin else 1
    # the recompute (one forward) and two products per forward product
    flops = 3 * 2.0 * b * t * p * (d * c + nb * k * c * c + c * d)
    # x, dy in, dx out, the weights in and their gradients out
    wfloats = p * (d * c + nb * k * c * c + c * d + 9 * c)
    nbytes = 4.0 * (3 * b * t * d + 2 * wfloats)
    bms, by = bound_ms(flops, nbytes)
    say(f"tcm_chain bwd {name} B={b} T={t}: kernel {ms:.4f} ms, plain "
        f"{plain:.4f} ms, bound {bms:.4f} ms ({by}; {flops / 1e9:.3f} GFLOP, "
        f"{nbytes / 1e6:.2f} MB)")
    return dict(err=err, ok=ok and zero_ok, ms=ms, plain_ms=plain,
                bound_ms=bms, bound_by=by)


def one_ulp_params(seed: int) -> bytes:
    """The release 40000.params with every value moved one ulp up or down
    (seeded), serialised as the JAX package writes it."""
    import numpy as np

    from eabnet_tpu_torch.checkpoint import load_params, msgpack_serialize

    rng = np.random.default_rng(seed)

    def move(tree):
        if isinstance(tree, dict):
            return {k: move(v) for k, v in tree.items()}
        up = rng.random(tree.shape) < 0.5
        return np.where(up, np.nextafter(tree, np.inf),
                        np.nextafter(tree, -np.inf)).astype(tree.dtype)

    tree = load_params(os.path.join(EXP, "40000.params"))
    return msgpack_serialize({"params": move(tree)})


def train_run(name: str, cfg_dict: dict, max_steps: int,
              params: bytes = None):
    """train() on the card in build/chip_smoke_train/<name>, which starts
    with a copy of the release 40000.params (or ``params``, the bytes of
    another such file); returns the step losses (steps, 3) and records."""
    import shutil

    import numpy as np

    from eabnet_tpu_torch.config import ExperimentConfig
    from eabnet_tpu_torch.train.trainer import train

    run = os.path.join(TRAIN_DIR, name)
    if not os.path.exists(run):
        os.makedirs(os.path.join(run, "ckpt"))
        target = os.path.join(run, "ckpt", "40000.params")
        if params is None:
            shutil.copy(os.path.join(EXP, "40000.params"), target)
        else:
            with open(target, "wb") as f:
                f.write(params)
    d = json.loads(json.dumps(cfg_dict))
    d["train"].update(checkpoint_dir=os.path.join(run, "ckpt"),
                      exp_root=run)
    hist = train(ExperimentConfig.from_dict(d), max_steps=max_steps,
                 device="cuda", tensorboard=False)
    return np.array([[h[k] for k in LOSS_KEYS] for h in hist]), hist


def loss_tolerance(spread):
    """Relative limits on the step losses against the JAX golden, per step
    (rows) and loss (eabnet, postnet, final), from ``spread``, the largest
    relative distance of the same run from params one ulp away (over
    TRAIN_ULP_RUNS seeds). Step 1 (a forward) is held to TRAIN_LOSS_RTOL.
    From step 2 on the losses carry float32 noise through Adam, which moves
    a parameter by ~lr whatever its gradient's size, so an element whose
    gradient sign is at noise level moves +lr in one run and -lr in
    another: each loss is held to TRAIN_SPREAD_MARGIN x its own largest
    spread over steps 2-5 (at least TRAIN_LOSS_RTOL)."""
    import numpy as np

    tol = np.full(spread.shape, TRAIN_LOSS_RTOL)
    tol[1:] = np.maximum(TRAIN_LOSS_RTOL, TRAIN_SPREAD_MARGIN
                         * spread[1:].max(axis=0))
    return tol


def zero_dalphas_run(cfg_dict: dict):
    """A planted fault: train_run with the TCM-chain backward kernel's
    slope gradients (dalphas) replaced by zeros."""
    import torch

    from eabnet_tpu_torch.kernels import tcm_chain as K

    launch = K._launch_bwd

    def faulty(*args, **kwargs):
        dx, dw = launch(*args, **kwargs)
        return dx, dw[:4] + (torch.zeros_like(dw[4]),) + dw[5:]

    K._launch_bwd = faulty
    try:
        return train_run("fault", cfg_dict, 40000 + TRAIN_STEPS)[0]
    finally:
        K._launch_bwd = launch


def train_phase():
    """The trainer on the card: 5 steps of batch 7 from the release
    params, launches, losses against the JAX golden, the checkpoint written,
    read and resumed from, step time, and one step profiled."""
    import shutil

    import numpy as np
    import torch

    from eabnet_tpu_torch.config import ExperimentConfig
    from eabnet_tpu_torch.data.datasets import OfflineMcseDataset
    from eabnet_tpu_torch.kernels.lstm_bf import double_lstm
    from eabnet_tpu_torch.kernels.tcm_chain import tcm_chain
    from eabnet_tpu_torch.train.checkpoint import load_checkpoint
    from eabnet_tpu_torch.train.step import (create_train_state,
                                             make_train_step)

    golden = np.load(TRAIN_GOLDEN)
    cfg_dict = json.loads(str(golden["config"]))
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    counters = (double_lstm, "launches"), (double_lstm, "bwd_launches"), \
        (tcm_chain, "launches"), (tcm_chain, "bwd_launches")
    for obj, attr in counters:
        setattr(obj, attr, 0)
    got, hist = train_run("a", cfg_dict, 40000 + TRAIN_STEPS)
    launches = [getattr(obj, attr) for obj, attr in counters]
    say(f"train: launches over {TRAIN_STEPS} steps (lstm_bf fwd, bwd, "
        f"tcm_chain fwd, bwd): {launches}")
    require(launches == [TRAIN_STEPS, TRAIN_STEPS, 21 * TRAIN_STEPS,
                         21 * TRAIN_STEPS],
            "train: 1 + 1 LSTM-BF and 21 + 21 TCM-chain launches per step")
    ref = golden["losses"]
    rel = np.abs(got - ref) / np.abs(ref)
    for i, (g, r) in enumerate(zip(got, ref)):
        say(f"train step {40001 + i}: losses {LOSS_KEYS} {g.tolist()} vs "
            f"JAX {r.tolist()}, relative {rel[i].tolist()}, "
            f"{hist[i]['seconds'] * 1e3:.2f} ms")
    require(got.shape == ref.shape and bool(np.isfinite(got).all()),
            f"train: {TRAIN_STEPS} finite steps")
    spreads = np.array([
        np.abs(train_run(f"ulp{seed}", cfg_dict, 40000 + TRAIN_STEPS,
                         params=one_ulp_params(seed))[0] - got) / np.abs(got)
        for seed in range(TRAIN_ULP_RUNS)])
    spread = spreads.max(axis=0)
    tol = loss_tolerance(spread)
    for j, k in enumerate(LOSS_KEYS):
        say(f"train: {k} loss per step: port vs JAX {rel[:, j].tolist()}; "
            f"port from params one ulp away, largest over steps 2-"
            f"{TRAIN_STEPS} in each of {TRAIN_ULP_RUNS} runs "
            f"{spreads[:, 1:, j].max(axis=1).tolist()}, largest per step "
            f"{spread[:, j].tolist()}; limit {tol[:, j].tolist()}")
    require(bool((rel <= tol).all()),
            f"train: step losses within their limits of the JAX golden "
            f"(step 1: {TRAIN_LOSS_RTOL:g}; later: {TRAIN_SPREAD_MARGIN:g} x "
            f"each loss's largest one-ulp spread)")
    fault = np.abs(zero_dalphas_run(cfg_dict) - ref) / np.abs(ref)
    for j, k in enumerate(LOSS_KEYS):
        over = np.flatnonzero(fault[:, j] > tol[:, j]) + 40001
        say(f"train: TCM-chain dalphas zeroed: {k} loss vs JAX per step "
            f"{fault[:, j].tolist()}, over its limit at steps "
            f"{over.tolist()}")
    require(bool((fault > tol).any()),
            "train: the limits reject a run whose TCM-chain backward zeroes "
            "dalphas")

    ckpt = os.path.join(TRAIN_DIR, "a", "ckpt", f"{40000 + TRAIN_STEPS}.ckpt")
    cfg = ExperimentConfig.from_dict(cfg_dict)
    state, epoch = load_checkpoint(ckpt, create_train_state(cfg, "cuda"),
                                   cfg)
    require((state.step, state.opt_state.count, epoch)
            == (40000 + TRAIN_STEPS, TRAIN_STEPS, TRAIN_STEPS),
            f"train: {os.path.basename(ckpt)} written and read back (step, "
            f"Adam count, epoch = {state.step}, {state.opt_state.count}, "
            f"{epoch})")
    # cuDNN's convolution backward may pick algorithms whose sums run in a
    # run-dependent order, so the runs compared here ask for deterministic
    # ones; the runs above, timed and profiled, use the trainer's defaults
    torch.backends.cudnn.deterministic = True
    try:
        train_run("det", cfg_dict, 40000 + TRAIN_STEPS)
        resumed = train_run("det", cfg_dict, 40001 + TRAIN_STEPS)[1]
        straight = train_run("det_straight", cfg_dict,
                             40001 + TRAIN_STEPS)[1]
    finally:
        torch.backends.cudnn.deterministic = False
    r, s_ = resumed[-1], straight[-1]
    same = all(r[k] == s_[k] for k in LOSS_KEYS)
    say(f"train: step {r['step']} after resuming "
        f"{[r[k] for k in LOSS_KEYS]}, without stopping "
        f"{[s_[k] for k in LOSS_KEYS]} "
        f"({'bit for bit' if same else 'not bit for bit'})")
    require(len(resumed) == 1 and r["step"] == s_["step"]
            and all(abs(r[k] - s_[k]) <= 1e-6 * abs(s_[k])
                    for k in LOSS_KEYS),
            "train: resuming from the checkpoint gives the loss of a run "
            "that did not stop (within 1e-6 relative)")

    step_s = min(h["seconds"] for h in hist[1:])
    batch = cfg.train.batch_size
    say(f"train: step time {step_s * 1e3:.2f} ms (min of steps 2-"
        f"{TRAIN_STEPS}: {[round(h['seconds'] * 1e3, 2) for h in hist[1:]]}),"
        f" {batch / step_s:.2f} items/s at batch {batch}, T = {TRAIN_T}")
    ds = OfflineMcseDataset(cfg.data.speech_root, cfg.data.transfer_int16)
    items = [ds[i] for i in range(batch)]
    noisy = torch.from_numpy(np.stack([x for x, _ in items])).cuda()
    clean = torch.from_numpy(np.stack([y for _, y in items])).cuda()
    step = make_train_step(cfg)
    step(state, noisy, clean)  # warm-up at this shape
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    profile_run(lambda: step(state, noisy, clean))
    say(f"train: peak device memory of a step "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    del state
    return dict(launches=launches, step_s=step_s, items_s=batch / step_s,
                max_rel=float(rel.max()))


def kernel_category(name: str) -> str:
    n = name.lower()
    for cat, keys in (("port lstm_bf", ("lstm_bf_fwd",)),
                      ("port tcm_chain", ("tcm_chain_fwd",)),
                      ("port lstm_bf bwd", ("lstm_bf_bwd", "lstm_bf_wgrad")),
                      ("port tcm_chain bwd", ("tcm_chain_bwd",
                                              "tcm_chain_grad_sum")),
                      ("conv (cuDNN)", ("conv", "cudnn", "xmma", "implicit",
                                        "dgrad", "wgrad", "fprop", "winograd",
                                        "fft")),
                      ("gemm", ("gemm", "cutlass", "sm90_", "ampere_",
                                "cublas")),
                      ("reduce", ("reduce", "norm", "welford")),
                      ("memcpy/memset", ("memcpy", "memset")),
                      ("elementwise", ("elementwise", "vectorized", "unrolled",
                                       "cat", "copy", "fill", "index",
                                       "pad", "where", "atan", "pow"))):
        if any(k in n for k in keys):
            return cat
    return "other"


def profile_run(fn) -> None:
    """fn() once under torch.profiler: device time by kernel and by
    category, and the device's idle share of the window (1 - the sum of
    kernel time over the wall; one stream, so kernels do not overlap)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t1) * 1e3
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        # device events only: a host range (an autograd Function whose
        # kernels are launched through ctypes, an aten op) also carries the
        # time of the kernels under it
        if us > 0 and e.device_type == DeviceType.CUDA:
            rows.append((us / 1e3, e.count, e.key))
    if not rows:
        say("profile: no device time recorded by torch.profiler "
            "(device breakdown not measured)")
        return
    busy = sum(r[0] for r in rows)
    say(f"profile: wall {wall_ms:.2f} ms (profiler on), kernel time "
        f"{busy:.2f} ms in {sum(r[1] for r in rows)} launches, device idle "
        f"share {max(0.0, 1 - busy / wall_ms):.3f}")
    cats = {}
    for ms, n, key in rows:
        c = cats.setdefault(kernel_category(key), [0.0, 0])
        c[0] += ms
        c[1] += n
    for cat, (ms, n) in sorted(cats.items(), key=lambda kv: -kv[1][0]):
        say(f"  {cat:16s} {ms:9.3f} ms {100 * ms / busy:5.1f}% "
            f"({n} launches)")
    for ms, n, key in sorted(rows, reverse=True)[:12]:
        say(f"  {ms:9.3f} ms x{n:<5d} {key[:100]}")


def main() -> int:
    faulthandler.dump_traceback_later(BUDGET_S, exit=True)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card "
              "only", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    os.chdir(root)
    sys.path.insert(0, root)
    import eabnet_tpu_torch  # noqa: F401  (fails outside the repository)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_grad_enabled(False)

    with Phase("device"):
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
        kind = torch.cuda.get_device_name(0)
        say(f"nvidia-smi: {smi}")
        say(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
            f"device 0: {kind}, {torch.cuda.device_count()} device(s)")

    with Phase("build"):
        from eabnet_tpu_torch.kernels._build import load_library

        lib = load_library()
        say(f"library {lib.path} ({'built' if lib.built else 'reused'}, "
            f"nvcc {lib.seconds:.1f} s)")
        for line in lib.log.splitlines():
            if "ptxas info" in line or "spill" in line:
                say("  " + line.strip())

    from eabnet_tpu_torch.checkpoint import latest_checkpoint, load_params
    from eabnet_tpu_torch.config import ExperimentConfig
    from eabnet_tpu_torch.inference import load_enhancer
    from eabnet_tpu_torch.kernels.lstm_bf import double_lstm
    from eabnet_tpu_torch.kernels.tcm_chain import tcm_chain
    from eabnet_tpu_torch.models.composed import build_model
    from eabnet_tpu_torch.utils.audio_io import read_wav
    from eabnet_tpu_torch.eval.metrics import si_sdr
    from eabnet_tpu_torch.weights import load_jax_params

    with Phase("kernels"):
        cfg = ExperimentConfig.load(os.path.join(EXP, "config.json"))
        model = load_jax_params(build_model(cfg.model),
                                load_params(latest_checkpoint(EXP))).cuda()
        bf_map = model.eabnet.bf_map
        twin_group = model.eabnet.stcn_0
        single_group = model.postnet.gag_0.glance.tcn_0
        t = 701  # one 6-s item: 96,000 samples + tail -> 112,000 -> 701 frames
        res = {
            "lstm_1": lstm_case(bf_map, 161, t, seed=1),
            "lstm_7": lstm_case(bf_map, 7 * 161, t, seed=2),
            "twin_1": tcm_case(twin_group, 1, t, seed=3),
            "twin_7": tcm_case(twin_group, 7, t, seed=4),
            "single_1": tcm_case(single_group, 1, t, seed=5),
            "single_7": tcm_case(single_group, 7, t, seed=6),
        }
        del model
        bad = [k for k, v in res.items() if not v["err"] <= KERNEL_ATOL]
        require(not bad, f"every kernel within {KERNEL_ATOL:g} of its plain "
                f"version (outside: {bad})")

    with Phase("slice"):
        enh = load_enhancer(EXP, device="cuda")
        _, noisy0 = read_wav(os.path.join(VAL, "noisy", "00000.wav"))
        golden = np.load(GOLDEN)
        for stage in ("esti", "esti0"):
            enh.output = stage
            enh(noisy0)  # warm-up (cuDNN algorithm choice, allocator)
            torch.cuda.synchronize()
            double_lstm.launches = 0
            tcm_chain.launches = 0
            out = enh(noisy0)
            torch.cuda.synchronize()
            launches = {"lstm_bf": double_lstm.launches,
                        "tcm_chain": tcm_chain.launches}
            say(f"{stage}: launches in one forward {launches}")
            require(launches == {"lstm_bf": 1, "tcm_chain": 21},
                    f"{stage}: 1 LSTM-BF and 21 TCM-chain launches")
            require(out.shape == golden[stage].shape
                    and bool(np.isfinite(out).all()),
                    f"{stage}: finite, shape {out.shape}")
            snr = snr_db(golden[stage], out)
            say(f"{stage}: SNR vs the JAX golden {snr:.2f} dB")
            require(snr >= GOLDEN_MIN_SNR_DB,
                    f"{stage}: SNR vs golden >= {GOLDEN_MIN_SNR_DB} dB")
            if stage == "esti":
                main_launches = launches

        enh.output = "esti"
        names = sorted(os.path.basename(p) for p in
                       glob.glob(os.path.join(VAL, "noisy", "*.wav")))
        noisy = [read_wav(os.path.join(VAL, "noisy", n))[1] for n in names]
        clean = [read_wav(os.path.join(VAL, "clean", n))[1] for n in names]
        enh.enhance_batch(noisy)  # warm-up at the batch shape
        torch.cuda.synchronize()
        walls = []
        for _ in range(3):
            t1 = time.perf_counter()
            enhanced = enh.enhance_batch(noisy)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t1)
        gains = []
        for n, x, s, y in zip(names, noisy, clean, enhanced):
            ref_mic = x[cfg.model.ref_mic]
            before, after = si_sdr(s, ref_mic), si_sdr(s, y)
            gains.append(after - before)
            say(f"{n}: SI-SDR noisy ref mic {before:.3f} dB -> enhanced "
                f"{after:.3f} dB ({after - before:+.3f})")
        mean_gain = float(np.mean(gains))
        require(all(bool(np.isfinite(e).all()) for e in enhanced),
                "batch outputs finite")
        require(mean_gain > 0, f"mean SI-SDR improvement {mean_gain:.3f} dB "
                "> 0")
        audio_s = sum(x.shape[-1] for x in noisy) / cfg.stft.sr
        wall = min(walls)
        say(f"batch of {len(noisy)} items ({audio_s:.1f} s of audio): wall "
            f"{wall * 1e3:.2f} ms (min of {['%.2f' % (w * 1e3) for w in walls]}"
            f" ms), real-time factor {wall / audio_s:.5f}, on {smi}")

    with Phase("profile"):
        profile_run(lambda: enh.enhance_batch(noisy))

    with Phase("backward"):
        # the train phase, part 1: the backward kernels against their
        # plain versions at the training shapes (T = 601: one 6-s item
        # of 96,000 samples, no bucketing tail), release weights
        cfg = ExperimentConfig.load(os.path.join(EXP, "config.json"))
        model = load_jax_params(build_model(cfg.model),
                                load_params(latest_checkpoint(EXP))).cuda()
        t = TRAIN_T
        bwd = {
            "lstm_7": lstm_bwd_case(model.eabnet.bf_map, 7 * 161, t, 11),
            "lstm_1": lstm_bwd_case(model.eabnet.bf_map, 161, t, 12),
            "twin_7": tcm_bwd_case(model.eabnet.stcn_0, 7, t, 13),
            "twin_1": tcm_bwd_case(model.eabnet.stcn_0, 1, t, 14),
            "single_7": tcm_bwd_case(
                model.postnet.gag_0.glance.tcn_0, 7, t, 15),
            "single_1": tcm_bwd_case(
                model.postnet.gag_0.glance.tcn_0, 1, t, 16),
        }
        del model
        bad = [k for k, v in bwd.items() if not v["ok"]]
        require(not bad, "every backward kernel within the JAX "
                f"gradient tests' tolerances of its plain version "
                f"(outside: {bad})")

    with Phase("train"):
        # part 2: the trainer on the card, the slice's main path
        trained = train_phase()

    def per_forward(twin, single):
        """Both variants as one forward runs them: 3 twin + 18 single."""
        return {k: 3 * res[twin][k] + 18 * res[single][k]
                for k in ("ms", "plain_ms", "bound_ms")}

    tcm = per_forward("twin_1", "single_1")
    tcm_step = {k: 3 * bwd["twin_7"][k] + 18 * bwd["single_7"][k]
                for k in ("ms", "plain_ms", "bound_ms")}
    record = {"kernels": [
        {"name": "lstm_bf_fwd", "route": "cuda",
         "source": "eabnet_tpu_torch/csrc/lstm_bf.cu",
         "replaces": "eabnet_tpu/kernels/lstm_bf.py:57",
         "launches": main_launches["lstm_bf"],
         "max_abs_err": max(res["lstm_1"]["err"], res["lstm_7"]["err"]),
         "ms": res["lstm_1"]["ms"], "plain_ms": res["lstm_1"]["plain_ms"],
         "bound_ms": res["lstm_1"]["bound_ms"],
         "bound_by": res["lstm_1"]["bound_by"],
         "library_ms": res["lstm_1"]["library_ms"]},
        {"name": "tcm_chain_fwd", "route": "cuda",
         "source": "eabnet_tpu_torch/csrc/tcm_chain.cu",
         "replaces": "eabnet_tpu/kernels/tcm_chain.py:175",
         "launches": main_launches["tcm_chain"],
         "max_abs_err": max(res[k]["err"] for k in
                            ("twin_1", "twin_7", "single_1", "single_7")),
         "ms": tcm["ms"], "plain_ms": tcm["plain_ms"],
         "bound_ms": tcm["bound_ms"],
         "bound_by": res["twin_1"]["bound_by"],
         "library_ms": None},
        {"name": "lstm_bf_bwd", "route": "cuda",
         "source": "eabnet_tpu_torch/csrc/lstm_bf.cu",
         "replaces": "eabnet_tpu/kernels/lstm_bf.py:107",
         "launches": trained["launches"][1],
         "max_abs_err": max(bwd["lstm_7"]["err"], bwd["lstm_1"]["err"]),
         "ms": bwd["lstm_7"]["ms"], "plain_ms": bwd["lstm_7"]["plain_ms"],
         "bound_ms": bwd["lstm_7"]["bound_ms"],
         "bound_by": bwd["lstm_7"]["bound_by"],
         "library_ms": bwd["lstm_7"]["library_ms"]},
        {"name": "tcm_chain_bwd", "route": "cuda",
         "source": "eabnet_tpu_torch/csrc/tcm_chain.cu",
         "replaces": "eabnet_tpu/kernels/tcm_chain.py:187",
         "launches": trained["launches"][3],
         "max_abs_err": max(bwd[k]["err"] for k in
                            ("twin_1", "twin_7", "single_1", "single_7")),
         "ms": tcm_step["ms"], "plain_ms": tcm_step["plain_ms"],
         "bound_ms": tcm_step["bound_ms"],
         "bound_by": bwd["twin_7"]["bound_by"],
         "library_ms": None},
    ]}
    record["kernels"][0]["train_launches"] = trained["launches"][0]
    record["kernels"][1]["train_launches"] = trained["launches"][2]
    say("kernel times above are per forward of one 6-s item (B=1, T=701): "
        "lstm_bf one launch at L=161, tcm_chain 3 EaBNet + 18 GaGNet "
        "group launches; the backward ones per train step of 7 items (T="
        f"{TRAIN_T}): lstm_bf one launch at L=1,127, tcm_chain 3 + 18 group "
        f"launches at B=7; launches of the forward kernels are those of one "
        f"enhancement forward (train_launches: of the {TRAIN_STEPS} train "
        "steps), of the backward ones those of the train steps")
    say(f"total {time.perf_counter() - T0:.1f} s")
    faulthandler.cancel_dump_traceback_later()
    print(smi)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
