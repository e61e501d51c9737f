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
GOLDEN_MIN_SNR_DB = 40.0
EXP = "release/composed_9mic"
VAL = "release/val_set"
GOLDEN = "tests/golden/torch_port_composed_9mic_00000.npz"

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


def kernel_category(name: str) -> str:
    n = name.lower()
    for cat, keys in (("port lstm_bf", ("lstm_bf_fwd",)),
                      ("port tcm_chain", ("tcm_chain_fwd",)),
                      ("conv (cuDNN)", ("conv", "cudnn", "xmma", "implicit",
                                        "dgrad", "fprop", "winograd", "fft")),
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


def profile_batch(enh, wavs) -> None:
    """One batch forward under torch.profiler: device time by kernel and by
    category, and the device's idle share of the window (1 - the sum of
    kernel time over the wall; one stream, so kernels do not overlap)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        enh.enhance_batch(wavs)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t1) * 1e3
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        # skip host-side ops and runtime calls, and the profiler's own
        # buffer requests
        if us > 0 and not e.key.startswith(("aten::", "cuda", "Activity")):
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
        profile_batch(enh, noisy)

    def per_forward(twin, single):
        """Both variants as one forward runs them: 3 twin + 18 single."""
        return {k: 3 * res[twin][k] + 18 * res[single][k]
                for k in ("ms", "plain_ms", "bound_ms")}

    tcm = per_forward("twin_1", "single_1")
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
    ]}
    say("kernel times above are per forward of one 6-s item (B=1, T=701): "
        "lstm_bf one launch at L=161, tcm_chain 3 EaBNet + 18 GaGNet "
        "group launches")
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
