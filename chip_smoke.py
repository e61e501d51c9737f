#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (eabnet_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each announced with its elapsed seconds:

1. device: the card's name and power limit (nvidia-smi), torch and CUDA.
2. build: the kernels' nvcc calls (one per source, all started together,
   then one link), with the register, shared-memory and spill lines of
   -Xptxas -v.
3. kernels: each hand-written kernel against its plain PyTorch version on
   the card, at the shapes of the main path, with the release weights and
   seeded inputs; its time (CUDA events), the plain version's, the library
   yardstick's where one PyTorch call computes the same function, and the
   bound: max(FLOPs / 67 TFLOP/s, bytes / 3.35 TB/s), the H100 SXM f32
   non-tensor peak and memory rate. The LSTM-BF forward at T = 701 for
   one item and batches of 7, 8 and 16 (L = 161, 1,127, 1,288, 2,576),
   and one item's share on 2 and 4 freq ranks (L = 81, 41),
   each with its lanes per block, blocks and waves over the SMs and the
   microseconds per step of it and of nn.LSTM; a second launch must give
   the same bits, L = 1,127 must fill at least 120 of 132 SMs and L =
   2,576 take one wave. The TCM-chain forward for one item and batches of
   7, 8 and 16, each with its cooperative launch (blocks, blocks per SM,
   tile rounds per block) and its bound also with every product as three
   TF32 products on the tensor cores; a second launch must give the same
   bits.
4. slice: release/composed_9mic through load_enhancer on the card, with
   torch's default TF32 flags as a user has them. One item alone, with the
   kernels' launch counts read around that forward and the output held
   against the JAX package's golden; then the 7 validation items as one
   batch, scored by SI-SDR against the clean references, and timed; the
   flags must be as they were.
5. profile: that batch once more under torch.profiler, device time by
   kernel and by category, and the device's idle share.
5a. cln: the second shipped model, release/eabnet_9mic_cln (cLN in both
   nets, the non-squeezed GaGNet), through load_enhancer with torch's
   default flags: item 00000 against its JAX golden at both stages with
   one LSTM-BF and no TCM-chain launch per forward (its cLN TCN groups run
   module by module, as the JAX package routes them); the 7 val items as
   one batch (SI-SDR gain > 0, wall, RTF) and profiled.
5b. stream: that model's StreamingComposed with float32 products: item
   00000's 701 offline STFT frames one at a time against the offline
   model (within 2e-4, the JAX soak tolerance; no kernel launched; the
   state's bytes after 8 frames those after 701); cli.stream on item 00000
   (in a process of its own, beside the next run) and on the 7 val items
   in lockstep against the offline Enhancer (correlation > 0.99, RMS
   ratio in (0.8, 1.25)); ms per frame (mean, p50, p99) and kernel
   launches per frame at 1, 7 and 64 streams beside the 10 ms hop.
5c. lowp: bfloat16 and int8w serving. The bf16 variants of the two
   forward kernels against their plain bf16 versions at the release
   weights: the LSTM-BF forward at T = 701, L = 161 and 1,127, the TCM
   chain twin and single at B = 1 and 7. Let R be the SNR between the
   plain bf16 and the plain float32 versions (TF32 off), D between the
   plain bf16 version computed in float32 and in float64 around the same
   bf16 operands (float32 rounding alone moves a bf16 result that far: a
   rounding to bf16 that flips moves later operands by a bf16 step); a
   kernel must reach min(R + 20, D - 3) dB, and a second launch must give
   the same bits. Each kernel's time, its plain version's, nn.LSTM in
   bf16 as the LSTM's yardstick, and the bound with bf16 bytes (FLOPs at
   the f32 rate, and on the tensor cores at bf16's 989 TFLOP/s). Then
   both released models in bfloat16 and int8w through load_enhancer on
   item 00000, both stages (and through cli.enhance --compute-dtype,
   stage esti), with the launches per forward read around it
   ({1, 21, 0, 0} for composed_9mic, {1, 0, 0, 0} for the cLN model),
   against the JAX package's goldens: R - 6 dB against its bf16 (int8w:
   its int8w) output and, in bf16, R - 3 dB against its float32, R
   between its float32 and bf16 goldens; int8w also within the JAX int8w
   test's criteria of the port's own float32 output (relative error <
   0.15, correlation > 0.99). The 7 val items as one batch for each model
   and mode: the mean SI-SDR gain within 0.5 dB of that model's float32
   gain in this run, wall, RTF, one profiled run's idle share, the peak
   device memory and the resident parameter bytes beside float32's.
5d. eval: both released models scored on the card as release/REPORT.md
   and release/REPORT_CLN.md were: the port's evaluate_dataset (PESQ wb
   and nb, STOI, ESTOI, SI-SDR/SIR/SAR, SegSNR, LSD; host code, in
   worker processes) with Enhancer(pad_mode="reference"), the
   featurization those records used (no zero tail). (a) The noisy
   reference mic of release/val_set and release/val_set_large: the
   reports' noisy rows, means and 95 % CIs, at their printed precision.
   (b) composed_9mic on release/val_set_large, esti0 and esti, per item
   against the JAX package's scores (release/refeval_oursdec_*.csv):
   within 1e-3 (PESQ, dB metrics, LSD) and 1e-4 (STOI, ESTOI), the
   largest difference per metric printed with its item. (c)
   composed_9mic on release/val_set and (d) eabnet_9mic_cln on
   release/val_set_large: every mean within 0.001 of the report's, the
   esti - esti0 margins within 0.002. (e) cli.test as a user runs it
   (default padding) for both models and stages on release/val_set, its
   CSV per item against the JAX package's cli.test
   (tests/golden/torch_port_eval_val_set.npz) at (b)'s limits. (f) The
   launches of one forward by C entry ({lstm_bf_fwd 1, tcm_chain_fwd 21}
   for composed_9mic, {lstm_bf_fwd 1} for the cLN model), the wall, items
   scored per second, host seconds enhancing against scoring. Then
   composed_9mic in bf16 and int8w on release/val_set (esti), means
   beside float32's, no limit.
6. backward (the train phase, part 1): each backward kernel, and the
   LSTM-BF training forward that saves its states, against its plain
   version on the card at the training shapes (T = 601; LSTM L = 1,127
   and 161, and 1,288 and 2,576: batches 8 and 16, as the released configs
   and the recipes train; TCM chains at B = 7, 1, 8 and 16, each with its
   launch geometry and its split by kernel name: the walk, the
   weight-gradient GEMM, the sum), seeded inputs and
   cotangents, release weights (the training forward, like the serving
   one, with its launch geometry and per-step times, and a second launch
   that must give the same bits); times (the LSTM-BF backward also split
   into its three launches, by kernel name under torch.profiler: the
   reverse-time walk, the weight-gradient partials, their sum), the plain
   version's, cuDNN's LSTM backward (and forward with grad
   on) as the yardstick, and the bound (for the LSTM-BF backward also at
   the tensor cores' TF32 rate, as its products run as three TF32
   products each; the TCM chain's too). A second backward launch on the
   same input must give the same bits. Tolerances are the JAX gradient tests'
   (LSTM 3e-5 / 5e-5, rtol 1e-4; TCM 6e-5, rtol 1e-3), applied per entry
   to d xw1. The weight gradients are sums over ~10^5-10^6 rows, whose
   float32 rounding is relative to the largest terms: against a float64
   run the plain version itself misses the per-entry tolerance, so they
   are held against their output's largest entry, and their distance
   from the float64 run may be at most 3x the plain version's (a GEMM
   that loses precision in its sum can pass the first rule and not this
   one). In the TCM chain an
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
   config stored in the golden tests/golden/torch_port_train_composed_9mic.npz.
   With the trainer's defaults: launches per step, step time, and one step
   profiled. With cuDNN's deterministic algorithms, so that a call repeats
   its numbers: losses against the JAX package's (step 1 within 1e-5; each
   loss of later steps within 3x its largest spread in 3 seeded runs of
   the same steps from params one ulp away, as Adam turns float32 noise
   into +-lr moves), a run with a planted fault (the TCM chain's dalphas
   zeroed) that these limits must reject, and the checkpoint written, read
   back and resumed from (the resumed step against a run that did not
   stop).

8. lowp_train: bf16 training's kernels alone at the training shapes (T =
   601; LSTM L = 161, 1,127, 1,288, 2,576; TCM twin and single at B = 1,
   7, 8, 16), release weights, seeded inputs and cotangents in bf16. The
   LSTM-BF training forward's four sequences against the plain bf16
   forward at R + 20 dB; the LSTM-BF backward on the kernel's own
   sequences, each output (dxw1, dW_hh1, dW_ih2, dW_hh2, db2) at min(R +
   20, D - 3). The TCM-chain backward: the trunk it recomputes, TCM by
   TCM against the plain bf16 TCM on the kernel's trunk input, at R + 20;
   one TCM at a time on its float32 trunk and cotangent in, as the kernel
   carried them, its cotangent out at R + 20 and its weight gradients at
   min(R + 20, D - 3), its dwo against the float64 sum of its own rounded
   operands; the whole chain, every output at min(R + 20, D - 6). R from
   the plain float32 version; D, how far float32 rounding alone moves the
   plain bf16 version, from plain probes that take nothing from the
   kernel: the same in float64, on the CPU, on inputs moved by float32
   rounding (PERF.md §2); a second launch gives the same bits. Times (the
   backwards split by launch), the plain versions', cuDNN's LSTM in bf16
   as the LSTM's yardstick, and the bound at bf16's 989 TFLOP/s on bf16
   bytes, with the float32 rate's beside.
9. train_bf16: train() of composed_9mic in bf16 from 40000.params on the
   7 val items, 5 steps: 1 + 21 + 1 + 21 kernel launches per step, all
   of the bf16 training entries (counted by C entry), step time,
   items/s, peak memory and one profiled step beside the float32 train
   phase's; under cuDNN's deterministic algorithms the 5 steps' losses
   against the JAX package's bf16 and float32 losses of the same steps
   (tests/golden/torch_port_train_composed_9mic_bf16.npz): as one vector
   of losses over JAX's float32, R - 6 dB against JAX bf16 and R - 3 to R
   + 10 against JAX float32, and the float32 train phase's losses of the
   same steps (the control) must fail that rule; the checkpoint keeps
   float32 params and moments. Then 2 bf16 steps of eabnet_9mic_cln from
   its 50000.params: 1 / 0 / 1 / 0 launches per step, all bf16, finite
   losses, step time.
9a. heads: the cnn and miso beamforming heads and L3DAS23 training. (a)
   release/composed_9mic with its LSTM head replaced by a seeded Dense
   bf_map (head_experiment: default_rng(16), normal / sqrt(embed_dim),
   zero bias), as bf_type="cnn" and as topo_type="miso", through the
   Enhancer with torch's default TF32 flags: item 00000 at both stages
   against the JAX golden tests/golden/torch_port_heads_00000.npz (>= 40
   dB), 0 LSTM-BF and 21 TCM-chain launches per float32 forward; the cnn
   head in bf16 and int8w by the lowp phase's rules (R - 6 dB against the
   JAX output of the same mode; bf16 also R - 3 against JAX float32;
   int8w also within the int8w criteria of the port's float32). (b)
   release/eabnet_9mic_cln with each head through StreamingComposed over
   item 00000's first 64 STFT frames: within 2e-4 of the offline model
   on those frames, no kernel launched, no head state, the state's bytes
   after 8 frames those after 64. (c) train() on the card on
   release/val_set written as L3DAS23 pickles (noisy mics 0-3 as (4, N),
   clean as (1, N)), composed_9mic's release config with M = 4, batch 7,
   float32, 3 steps from 40000.params restricted to mics 0-3
   (restrict_mics): 1 + 21 + 1 + 21 launches per step (L = 1,127, B =
   7), the step-1 losses within 1e-5 relative of the JAX golden
   tests/golden/torch_port_train_l3das.npz, steps 2-3 printed beside
   JAX's, the step wall, loader wait and items/s.
10. online: online synthesis feeding the flagship recipe
   (examples/train_online_scene.sh: release-sized cLN models, bf16, batch
   16, 6-s clips, device_mix="scene", int16 transport, 3 loader workers).
   Stages its data with the port's tools under build/chip_smoke_online/
   (160 speech and 24 noise files from synth_speech, tools/e2e_demo.py's
   settings, cli.split's lists, 12 validation items from cli.datagen with
   3 spawned workers). Host: the native RIR engine against numpy (1e-5),
   items per second of full synthesis, parts and scene parameters in one
   process. On the card at the flagship's shapes (16 items, the same
   seeds as the host path; the JAX data tests' tolerances): mix_parts
   against synthesize_item (2e-5 of the peak, rtol 1e-4), the int16
   transport within 1e-3 of float32, the scene early RIRs against
   ism_early_rir (3e-5), the tails' per-bin energy against hist_amp^2
   (rtol 1e-4), each rebuilt RIR's energy against the host render (rtol
   0.08), the clean target against the host direct path (3e-5), and both
   mixes giving the same bits twice. The flagship config through
   cli.train --device cuda for 4 steps, validating once on the 12 items:
   finite losses, one bf16 LSTM-BF training forward and backward per
   step, one float32 forward per validation item, no TCM-chain launch. A
   run stopped at an epoch's end and resumed against one that did not
   stop, under cuDNN's deterministic algorithms. Modes False, "loader"
   and "parts" for 3 steps each (False and "parts" see the same audio:
   step-1 losses within 1e-3). Per mode: step wall (median), seconds
   waited on the loader, host-to-device bytes, items/s, the mix's kernel
   time, one profiled step's idle share, peak memory; the resident
   corpus's bytes.
11. ddp: data-parallel training and batch serving on the one card. The
   kernels and the native RIR engine are built in this process first, so
   the spawned ranks find them built; every rank sets cuDNN's
   deterministic algorithms and TF32 off itself and trains under
   float32_products. composed_9mic in float32 from 40000.params on
   release/val_set, global batch 6, 3 steps, as (a) one process, (b)
   train() in a spawned NCCL group of world 1 (the code path of a
   multi-card run) and (c) two spawned gloo ranks on cuda:0, 3 rows each.
   (b) equals (a) bit for bit (losses, every parameter after step 3); the
   ranks of (c) hold the same parameter bits after every step; (c)'s
   step-1 loss within 1e-5 of (a)'s and its step-1 gradients (the
   all-reduced ones clipping sees) within atol 1e-5, rtol 1e-3 per tensor
   (the JAX package's multi-device tolerance), its steps 2-3 within 3x the
   spread of 3 runs of (a) from params one ulp away; each rank launches 1 +
   1 LSTM-BF and 21 + 21 TCM-chain entries a step. Per rank: step walls,
   the last step's share in its all-reduces (each timed with the card
   synchronised around it), the 35 MB gradient all-reduce alone, peak
   memory, seconds from the process's start to torch ready. The
   flagship's online bf16 config (cLN, scene, batch 16 = 2 x 8, one loader
   worker per rank) for 2 steps on two gloo ranks: step-1 loss within
   1e-3 of the online phase's one-process step 1, each rank loading its
   own corpus onto the card, 1 + 1 bf16 LSTM-BF training launches a step.
   Enhancer(mesh=make_mesh(devices=[cuda:0, cuda:0])) on the 7 val items
   (padded to 8) for both released models in float32 and bf16: within
   2e-5 of one replica, one forward's launches per replica, the walls.
12. freq: frequency-axis model parallelism. Two gloo ranks on cuda:0
   (NCCL refuses two ranks on one device) form a 1 x 2 ('data', 'freq')
   mesh and serve item 00000 through Enhancer(shard_freq=True):
   composed_9mic float32 at both stages and eabnet_9mic_cln float32
   esti, each >= 40 dB against the JAX golden and within 2e-5 of the
   one-process output of the slice and cln phases; composed_9mic bf16 at
   R - 6 dB against one process in bf16; every rank the same output bits,
   one LSTM-BF forward at its B·F_r lanes (81, 80) and, for
   composed_9mic, 21 TCM-chain forwards per forward. Then four ranks for
   composed_9mic float32 esti (41 + 40 + 40 + 40 lanes). Per rank: the
   collectives and bytes by kind (halo, norm, gather, row) and the host
   wall of one sharded forward beside one process's; the ranks share one
   card and stage every collective through the host.

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
TF32_PEAK = 495e12        # H100 SXM dense TF32 tensor-core FLOP/s
BF16_PEAK = 989e12        # H100 SXM dense bf16 tensor-core FLOP/s
KERNEL_ATOL = 2e-5        # the JAX kernel tests' forward tolerance
# the JAX kernel tests' gradient tolerances (tests/test_kernels.py,
# tests/test_tcm_chain.py)
LSTM_DX_ATOL, LSTM_DW_ATOL, LSTM_RTOL = 3e-5, 5e-5, 1e-4
# an LSTM-BF weight gradient may be at most this many times as far from a
# float64 run as the plain float32 version is
LSTM_DW_F64_FACTOR = 3.0
TCM_ATOL, TCM_RTOL = 6e-5, 1e-3
GOLDEN_MIN_SNR_DB = 40.0
EXP = "release/composed_9mic"
VAL = "release/val_set"
GOLDEN = "tests/golden/torch_port_composed_9mic_00000.npz"
EXP_CLN = "release/eabnet_9mic_cln"
GOLDEN_CLN = "tests/golden/torch_port_eabnet_9mic_cln_00000.npz"
# bf16 and int8w: the JAX package's outputs of item 00000 (keys
# <stage>_<dtype>) beside each model's float32 golden
LOWP_MODES = ("bfloat16", "int8w")
LOWP_MODELS = ((EXP, GOLDEN, (1, 21, 0, 0)), (EXP_CLN, GOLDEN_CLN,
                                              (1, 0, 0, 0)))
# a kernel against its plain version: R + this (the TCM chain: each TCM
# alone; the whole chain at this or D - LOWP_SPREAD_DB, whichever is
# lower); a model against the JAX goldens: R - these
LOWP_KERNEL_DB, LOWP_SPREAD_DB = 20.0, 3.0
# the bf16 TCM-chain backward's whole chain: D - this. At B = 1 a flipped
# rounding's cascade makes the chain's SNR heavy-tailed: the plain version
# run on the CPU, a second correct float32 implementation, lands under
# D - 3 in 10 of 112 outputs over 16 seeds and at D - 6.07 at worst
# (PERF.md §2)
LOWP_CHAIN_BWD_SPREAD_DB = 6.0
LOWP_MODEL_DB, LOWP_F32_DB = 6.0, 3.0
# bf16 train losses: at most R + this from JAX's float32 losses (they must
# carry bf16's noise; the same steps in float32 sit far above)
LOWP_F32_CAP_DB = 10.0
LOWP_GAIN_DB = 0.5  # mean SI-SDR gain within this of float32's
LOWP_DIR = "build/chip_smoke_lowp"  # the CLI's wavs
# tests/test_quantize.py's int8w criteria against float32
INT8W_MAX_ERR, INT8W_MIN_CORR = 0.15, 0.99
STREAM_DIR = "build/chip_smoke_stream"
# the JAX package's soak tolerance for streaming against offline
# (tests/test_streaming_soak.py)
STREAM_TOL = 2e-4
STREAM_BATCHES = (1, 7, 64)
STREAM_FRAMES = 30  # timed frames per batch of streams
STREAM_FILE_TIMEOUT_S = 400  # cli.stream on one 7-s file, its own process
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
# bf16 training: the JAX package's bf16 and float32 losses of the same 5
# steps; the port's bf16 losses (each divided by JAX's float32 loss, as a
# vector over steps and losses) at R - 6 dB against JAX bf16 and R - 3
# against JAX float32, R between JAX's bf16 and float32 (PERF.md §2)
TRAIN_BF16_GOLDEN = "tests/golden/torch_port_train_composed_9mic_bf16.npz"
CLN_BF16_STEPS = 2  # eabnet_9mic_cln bf16 steps: launches and time
# a bf16 weight gradient against the float64 sum of the kernel's own
# (rounded) operands, rounded once: the float32 summation order flips a
# bf16 rounding in ~0.1% of entries (~78 dB); one more rounding of the
# partial sums anywhere costs about a bf16 rounding's own ~59 dB
LOWP_SUM_DB = 68.0
# the eval phase: both released models scored as the release reports were
VAL_LARGE = "release/val_set_large"
EVAL_GOLDEN = "tests/golden/torch_port_eval_val_set.npz"
EVAL_DIR = "build/chip_smoke_eval"  # cli.test's reports
EVAL_KEYS = ("si_sdr", "pesq", "nb_pesq", "stoi", "estoi", "seg_snr", "lsd")
# a score against the JAX package's, per item: the port's float32 output
# lies far inside the 40 dB golden rule and the metric code is the same
SCORE_TOL = {"pesq": 1e-3, "nb_pesq": 1e-3, "stoi": 1e-4, "estoi": 1e-4,
             "si_sdr": 1e-3, "si_sir": 1e-3, "si_sar": 1e-3, "seg_snr": 1e-3,
             "lsd": 1e-3}
# a mean against a report's: one unit of its last digit; esti - esti0
# margins: two
EVAL_MEAN_TOL, EVAL_MARGIN_TOL = 0.001, 0.002
EVAL_SHARD = 4  # items per scoring job of the worker processes
EVAL_NUDGES = 16  # one-ulp nudges of an estimate scored outside its limit

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


# the kernels' launch counters, in the order of the record's kernels
LAUNCH_KEYS = ("lstm_bf", "tcm_chain", "lstm_bf_bwd", "tcm_chain_bwd")


def launch_counters():
    """(wrapper, counter attribute) of every kernel, as LAUNCH_KEYS."""
    from eabnet_tpu_torch.kernels.lstm_bf import double_lstm
    from eabnet_tpu_torch.kernels.tcm_chain import tcm_chain

    return ((double_lstm, "launches"), (tcm_chain, "launches"),
            (double_lstm, "bwd_launches"), (tcm_chain, "bwd_launches"))


def zero_launches() -> None:
    """Every launch counter to 0: the totals and the counts by C entry."""
    from eabnet_tpu_torch.kernels.lstm_bf import double_lstm
    from eabnet_tpu_torch.kernels.tcm_chain import tcm_chain

    for obj, attr in launch_counters():
        setattr(obj, attr, 0)
    double_lstm.entry_launches, tcm_chain.entry_launches = {}, {}


def read_launches() -> dict:
    """The launch totals, keyed as LAUNCH_KEYS."""
    return {k: getattr(obj, attr) for k, (obj, attr) in
            zip(LAUNCH_KEYS, launch_counters())}


def read_entries() -> dict:
    """The launches by C entry, keyed by its name without ``eabnet_``
    ({"lstm_bf_fwd_train_bf16": n, ...}); entries not launched left out."""
    from eabnet_tpu_torch.kernels.lstm_bf import double_lstm
    from eabnet_tpu_torch.kernels.tcm_chain import tcm_chain

    out = {f"lstm_bf_{e}": n for e, n in double_lstm.entry_launches.items()
           if n}
    out.update({f"tcm_chain_{e}": n for e, n in
                tcm_chain.entry_launches.items() if n})
    return out


def want_entries(want: dict, lowp: bool, train: bool = False) -> dict:
    """The launches by C entry that totals ``want`` (keyed as LAUNCH_KEYS)
    must come from: the float32 or the bf16 entries, and for the LSTM-BF
    forward the training form (``train``) or the serving form."""
    sfx = "_bf16" if lowp else ""
    names = ("lstm_bf_fwd" + ("_train" if train else "") + sfx,
             "tcm_chain_fwd" + sfx, "lstm_bf_bwd" + sfx,
             "tcm_chain_bwd" + sfx)
    return {n: want[k] for n, k in zip(names, LAUNCH_KEYS) if want[k]}


# the C entries of each row of the kernels record, and the path whose
# launches are its "launches"
ROW_ENTRIES = {
    "lstm_bf_fwd": (("lstm_bf_fwd", "lstm_bf_fwd_train"), "slice"),
    "tcm_chain_fwd": (("tcm_chain_fwd",), "slice"),
    "lstm_bf_bwd": (("lstm_bf_bwd",), "train"),
    "tcm_chain_bwd": (("tcm_chain_bwd",), "train"),
    "lstm_bf_fwd_bf16": (("lstm_bf_fwd_bf16",), "composed_9mic bfloat16"),
    "tcm_chain_fwd_bf16": (("tcm_chain_fwd_bf16",),
                           "composed_9mic bfloat16"),
    "lstm_bf_fwd_train_bf16": (("lstm_bf_fwd_train_bf16",), "train_bf16"),
    "lstm_bf_bwd_bf16": (("lstm_bf_bwd_bf16",), "train_bf16"),
    "tcm_chain_bwd_bf16": (("tcm_chain_bwd_bf16",), "train_bf16"),
}


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


def tc_bound_ms(flops: float, nbytes: float) -> float:
    """The bound with every product on the tensor cores as three TF32
    products (the split that keeps float32's precision)."""
    return max(3 * flops / TF32_PEAK, nbytes / MEM_RATE) * 1e3


def tcm_geometry(name: str, b: int, t: int, k: int, twin: bool,
                 backward: bool) -> dict:
    """The TCM-chain kernel's cooperative launch at (B, T), printed and
    returned: tiles, blocks, co-resident blocks per SM, tile rounds per
    block (the most and the mean)."""
    from eabnet_tpu_torch.kernels.tcm_chain import geometry

    geo = geometry(b, t, k, twin, backward)
    say(f"tcm_chain {'bwd ' if backward else ''}{name} B={b} T={t}: "
        f"{geo['tiles']} tiles on {geo['blocks']} blocks "
        f"({geo['blocks_per_sm']} per SM), tile rounds per block: most "
        f"{geo['rounds_max']}, mean {geo['rounds_mean']:.3f}")
    return geo


def snr_db(ref, est) -> float:
    import numpy as np

    return float(10 * np.log10(np.sum(ref ** 2) / np.sum((ref - est) ** 2)))


# ---------------------------------------------------------------- kernels
def fwd_geometry(lanes: int, t: int, ms: float, library_ms: float) -> dict:
    """The LSTM-BF forward's launch at ``lanes`` lanes (lanes per block,
    blocks, waves over the SMs) and the microseconds per step of the
    kernel and of the library yardstick, printed and returned."""
    import torch

    from eabnet_tpu_torch.kernels.lstm_bf import fwd_lanes_per_block

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    lb = fwd_lanes_per_block(lanes)
    blocks = -(-lanes // lb)
    geo = dict(t=t, lanes=lanes, lanes_per_block=lb, blocks=blocks, sms=sms,
               waves=-(-blocks // sms), us_per_step=ms * 1e3 / t,
               library_us_per_step=library_ms * 1e3 / t)
    say(f"lstm_bf fwd T={t} L={lanes}: {lb} lanes per block, {blocks} "
        f"blocks on {sms} SMs ({geo['waves']} wave(s)); "
        f"{geo['us_per_step']:.3f} us per step, nn.LSTM "
        f"{geo['library_us_per_step']:.3f} us")
    return geo


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
    same = torch.equal(out, double_lstm(*args))
    ref = double_lstm_reference(*args)
    ref64 = double_lstm_reference(*(a.double() for a in args))
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    say(f"lstm_bf T={t} L={lanes}: max|kernel-plain| {err:.3e} (tolerance "
        f"{KERNEL_ATOL:g}), "
        f"max|kernel-f64| {(out.double() - ref64).abs().max().item():.3e}, "
        f"max|plain-f64| {(ref.double() - ref64).abs().max().item():.3e}; "
        f"a second launch gives {'the same bits' if same else 'OTHER BITS'}")
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
    return dict(err=err, same=same, ms=ms, plain_ms=plain,
                library_ms=library, bound_ms=bms, bound_by=by,
                geometry=fwd_geometry(lanes, t, ms, library))


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
    same = torch.equal(out, tcm_chain(x, w, dils, twin))
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
        f"max|ref| {ref.abs().max().item():.3e}; a second launch gives "
        f"{'the same bits' if same else 'OTHER BITS'}")
    geo = tcm_geometry(name, b, t, w[1].shape[1], twin, backward=False)
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
    tc_bms = tc_bound_ms(flops, nbytes)
    say(f"tcm_chain {name} B={b} T={t}: kernel {ms:.4f} ms, plain "
        f"{plain:.4f} ms, bound {bms:.4f} ms ({by}; {flops / 1e9:.3f} GFLOP, "
        f"{nbytes / 1e6:.2f} MB), bound on the tensor cores (3 x TF32) "
        f"{tc_bms:.4f} ms")
    return dict(err=err, same=same, ms=ms, plain_ms=plain, bound_ms=bms,
                bound_by=by, tc_bound_ms=tc_bms, geometry=geo)


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
    fwd_same = all(torch.equal(a, b) for a, b in
                   zip(states, K._launch_fwd(xw1, *w, states=True)))
    ref_states = K.double_lstm_states_reference(xw1, *w)
    fwd_err = max((a - b).abs().max().item()
                  for a, b in zip(states, ref_states))
    got = K._launch_bwd(xw1, dy, *states, *w)
    again = K._launch_bwd(xw1, dy, *states, *w)
    ref = K.double_lstm_bwd_reference(xw1, dy, *states, *w)
    ref64 = K.double_lstm_bwd_reference(
        *(a.double() for a in (xw1, dy) + tuple(states) + tuple(w)))
    torch.cuda.synchronize()
    rep = [tolerance_report(got[0], ref[0], ref64[0], LSTM_DX_ATOL,
                            LSTM_RTOL)] + [
        tolerance_report(a, b, c, LSTM_DW_ATOL, LSTM_RTOL)
        for a, b, c in zip(got[1:], ref[1:], ref64[1:])]
    err = max(r["max"] for r in rep)
    # the weight-gradient sum runs in a fixed order: a second launch on the
    # same input gives the same bits (the resumed train step relies on it)
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    # d xw1 per entry; the weight gradients, sums over T x L rows, against
    # their largest entry and against the plain version's distance from
    # float64 (see the module docstring)
    f64_ratio = [dict(q=r["k64"] / r["p64"]) for r in rep[1:]]
    ok = (fwd_err <= KERNEL_ATOL and fwd_same and rep[0]["ratio"] <= 1.0
          and all(r["normwise"] <= 1.0 and q["q"] <= LSTM_DW_F64_FACTOR
                  for r, q in zip(rep[1:], f64_ratio)) and same)
    say(f"lstm_bf bwd T={t} L={lanes}: training forward max|kernel-plain| "
        f"{fwd_err:.3e}, a second launch gives "
        f"{'the same bits' if fwd_same else 'OTHER BITS'}; backward (dxw1, "
        f"dw_hh1, dw_ih2, dw_hh2, db2): "
        f"max|kernel-plain| {fmt(rep, 'max')}, per-entry tolerance ratio "
        f"{fmt(rep, 'ratio', '%.3f')}, share of entries outside "
        f"{fmt(rep, 'out')}, largest-entry ratio "
        f"{fmt(rep, 'normwise', '%.3f')} (dx atol {LSTM_DX_ATOL:g}, "
        f"weights {LSTM_DW_ATOL:g}, rtol {LSTM_RTOL:g}); max|kernel-f64| "
        f"{fmt(rep, 'k64')}, max|plain-f64| {fmt(rep, 'p64')} (weights' "
        f"ratio {fmt(f64_ratio, 'q', '%.3f')}, limit "
        f"{LSTM_DW_F64_FACTOR:g}); a second "
        f"launch gives {'the same bits' if same else 'OTHER BITS'}")
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
        # the three launches' device time, by kernel name
        by_kernel = device_ms(lambda: K._launch_bwd(xw1, dy, *states, *w),
                              reps=5)
        split = lstm_split(by_kernel)
        fwd_ms = cuda_ms(lambda: K._launch_fwd(xw1, *w, states=True), reps=5)
        library_fwd = cuda_ms(lambda: lstm(xg), reps=5)
        plain_fwd = cuda_ms(lambda: K.double_lstm_states_reference(xw1, *w),
                            reps=1, warmup=1)
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
    tc_bms = tc_bound_ms(flops, nbytes)
    # the training forward: the forward's products, xw1 in, 4 states out
    fwd_bms, fwd_by = bound_ms(2.0 * 3 * 64 * 256 * rows,
                               4.0 * (rows * (256 + 4 * 64) + 3 * 64 * 256
                                      + 256))
    say(f"lstm_bf T={t} L={lanes}: training forward {fwd_ms:.4f} ms, bound "
        f"{fwd_bms:.4f} ms ({fwd_by}), plain {plain_fwd:.4f} ms, cuDNN LSTM "
        f"forward with grad {library_fwd:.4f} ms")
    fwd_geo = fwd_geometry(lanes, t, fwd_ms, library_fwd)
    say(f"lstm_bf bwd T={t} L={lanes}: split by launch (torch.profiler): "
        + ("not measured (no device time recorded)" if split is None else
           f"reverse-time walk {split['walk']:.4f} ms, weight-gradient "
           f"partials {split['wgrad']:.4f} ms, their sum "
           f"{split['sum']:.4f} ms"))
    say(f"lstm_bf bwd T={t} L={lanes}: kernel {ms:.4f} ms (training "
        f"forward {fwd_ms:.4f} ms), plain {plain:.4f} ms, cuDNN LSTM "
        f"backward {library:.4f} ms (forward + backward {library_fb:.4f} ms "
        f"vs the port's {fwd_ms + ms:.4f} ms), bound {bms:.4f} ms ({by}; "
        f"{flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} MB), bound on the "
        f"tensor cores (3 x TF32) {tc_bms:.4f} ms")
    return dict(err=err, ok=ok, ms=ms, fwd_ms=fwd_ms, fwd_err=fwd_err,
                plain_ms=plain, library_ms=library, library_fb_ms=library_fb,
                library_fwd_ms=library_fwd, plain_fwd_ms=plain_fwd,
                fwd_bound_ms=fwd_bms, fwd_geometry=fwd_geo,
                split_ms=split, bound_ms=bms, bound_by=by, tc_bound_ms=tc_bms)


def lstm_split(by_kernel):
    """The LSTM-BF backward's device ms by launch from ``device_ms``: the
    walk, the weight-gradient partials, their sum (kernel names are
    templates: the name is followed by '<' or '(')."""
    if by_kernel is None:
        return None
    return {name: sum(v for k, v in by_kernel.items()
                      if f"::{fn}<" in k or f"::{fn}(" in k)
            for name, fn in (("walk", "lstm_bf_bwd_kernel"),
                             ("wgrad", "lstm_bf_wgrad_kernel"),
                             ("sum", "lstm_bf_wgrad_sum_kernel"))}


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
    # the weight gradients are summed in a fixed order: a second launch
    # gives the same bits
    again = K._launch_bwd(x, dy, w, dils, twin)
    same = torch.equal(dx, again[0]) and all(
        torch.equal(a, c) for a, c in zip(dw, again[1]))
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
        + ("" if twin else f", unused-branch gradients zero: {zero_ok}")
        + "; a second launch gives "
        + ("the same bits" if same else "OTHER BITS"))
    geo = tcm_geometry(name, b, t, w[1].shape[1], twin, backward=True)
    ms = cuda_ms(lambda: K._launch_bwd(x, dy, w, dils, twin), reps=10)
    # the three launches' device time, by kernel name
    by_kernel = device_ms(lambda: K._launch_bwd(x, dy, w, dils, twin), reps=5)
    split = None if by_kernel is None else {
        part: sum(v for key, v in by_kernel.items() if f"::{fn}" in key)
        for part, fn in (("walk", "tcm_chain_bwd_kernel"),
                         ("wgrad", "tcm_chain_wgrad_kernel"),
                         ("sum", "tcm_chain_grad_sum_kernel"))}
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
    tc_bms = tc_bound_ms(flops, nbytes)
    say(f"tcm_chain bwd {name} B={b} T={t}: split by launch "
        "(torch.profiler): " + (
            "not measured (no device time recorded)" if split is None else
            f"walk {split['walk']:.4f} ms, weight-gradient GEMM "
            f"{split['wgrad']:.4f} ms, sum {split['sum']:.4f} ms"))
    say(f"tcm_chain bwd {name} B={b} T={t}: kernel {ms:.4f} ms, plain "
        f"{plain:.4f} ms, bound {bms:.4f} ms ({by}; {flops / 1e9:.3f} GFLOP, "
        f"{nbytes / 1e6:.2f} MB), bound on the tensor cores (3 x TF32) "
        f"{tc_bms:.4f} ms")
    return dict(err=err, ok=ok and zero_ok and same, same=same, ms=ms,
                plain_ms=plain, bound_ms=bms, bound_by=by, tc_bound_ms=tc_bms,
                split_ms=split, geometry=geo)


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


def stage_train_run(name: str, params: bytes = None,
                    start: str = None) -> str:
    """build/chip_smoke_train/<name>, made (once) with a copy of the
    release 40000.params (or ``start``, another release params file; or
    ``params``, the bytes of such a file)."""
    import shutil

    start = start or os.path.join(EXP, "40000.params")
    run = os.path.join(TRAIN_DIR, name)
    if not os.path.exists(run):
        os.makedirs(os.path.join(run, "ckpt"))
        target = os.path.join(run, "ckpt", os.path.basename(start))
        if params is None:
            shutil.copy(start, target)
        else:
            with open(target, "wb") as f:
                f.write(params)
    return run


def train_run(name: str, cfg_dict: dict, max_steps: int,
              params: bytes = None, start: str = None,
              device: str = "cuda"):
    """train() on ``device`` in stage_train_run(name, params, start);
    returns the step losses (steps, 3) and records."""
    import numpy as np

    from eabnet_tpu_torch.config import ExperimentConfig
    from eabnet_tpu_torch.train.trainer import train

    run = stage_train_run(name, params, start)
    d = json.loads(json.dumps(cfg_dict))
    d["train"].update(checkpoint_dir=os.path.join(run, "ckpt"),
                      exp_root=run)
    hist = train(ExperimentConfig.from_dict(d), max_steps=max_steps,
                 device=device, tensorboard=False)
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
    from eabnet_tpu_torch.train.checkpoint import load_checkpoint
    from eabnet_tpu_torch.train.step import (create_train_state,
                                             make_train_step)

    golden = np.load(TRAIN_GOLDEN)
    cfg_dict = json.loads(str(golden["config"]))
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    zero_launches()
    # launches and step time with the trainer's defaults
    hist = train_run("timed", cfg_dict, 40000 + TRAIN_STEPS)[1]
    launches, entries = read_launches(), read_entries()
    say(f"train: launches over {TRAIN_STEPS} steps: {launches}, by C "
        f"entry {entries}")
    want = dict(zip(LAUNCH_KEYS, (TRAIN_STEPS, 21 * TRAIN_STEPS, TRAIN_STEPS,
                                  21 * TRAIN_STEPS)))
    require(launches == want and entries == want_entries(want, False, True),
            "train: 1 + 1 LSTM-BF and 21 + 21 TCM-chain launches per step, "
            "all of the float32 training kernels")
    # cuDNN's default convolution algorithms may sum in a run-dependent
    # order: the losses after step 1 and their one-ulp limits then move
    # from call to call, and one tree passed and failed in turn. The runs
    # whose losses are compared ask for deterministic algorithms, so a call
    # repeats its numbers.
    torch.backends.cudnn.deterministic = True
    try:
        max_rel, losses = compared_runs(cfg_dict, golden["losses"])
    finally:
        torch.backends.cudnn.deterministic = False

    step_s = min(h["seconds"] for h in hist[1:])
    cfg = ExperimentConfig.from_dict(cfg_dict)
    batch = cfg.train.batch_size
    say(f"train: step time {step_s * 1e3:.2f} ms (min of steps 2-"
        f"{TRAIN_STEPS}: {[round(h['seconds'] * 1e3, 2) for h in hist[1:]]}"
        f"; step 1 {hist[0]['seconds'] * 1e3:.2f} ms), {batch / step_s:.2f} "
        f"items/s at batch {batch}, T = {TRAIN_T}")
    ckpt = os.path.join(TRAIN_DIR, "timed", "ckpt",
                        f"{40000 + TRAIN_STEPS}.ckpt")
    state = load_checkpoint(ckpt, create_train_state(cfg, "cuda"), cfg)[0]
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
    return dict(launches=launches, entries=entries, step_s=step_s,
                items_s=batch / step_s, max_rel=max_rel, losses=losses)


def compared_runs(cfg_dict: dict, ref):
    """The train phase's checks of losses against the JAX golden's ``ref``
    (steps, 3), of the checkpoint and of resuming from it; returns the
    largest relative loss difference from JAX and the losses (steps, 3)
    of the run compared."""
    import numpy as np

    from eabnet_tpu_torch.config import ExperimentConfig
    from eabnet_tpu_torch.train.checkpoint import load_checkpoint
    from eabnet_tpu_torch.train.step import create_train_state

    got = train_run("a", cfg_dict, 40000 + TRAIN_STEPS)[0]
    rel = np.abs(got - ref) / np.abs(ref)
    for i, (g, r) in enumerate(zip(got, ref)):
        say(f"train step {40001 + i}: losses {LOSS_KEYS} {g.tolist()} vs "
            f"JAX {r.tolist()}, relative {rel[i].tolist()}")
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
    del state
    resumed = train_run("a", cfg_dict, 40001 + TRAIN_STEPS)[1]
    straight = train_run("straight", cfg_dict, 40001 + TRAIN_STEPS)[1]
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
    return float(rel.max()), got


def kernel_category(name: str) -> str:
    n = name.lower()
    for cat, keys in (("port lstm_bf", ("lstm_bf_fwd",)),
                      ("port tcm_chain", ("tcm_chain_fwd",)),
                      ("port lstm_bf bwd", ("lstm_bf_bwd", "lstm_bf_wgrad")),
                      ("port tcm_chain bwd", ("tcm_chain_bwd",
                                              "tcm_chain_wgrad",
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


def profiled(fn, reps: int = 1):
    """fn() reps times under torch.profiler -> (rows, wall ms): rows are
    (device ms, launches, kernel name) over the reps."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        for _ in range(reps):
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
    return rows, wall_ms


def device_ms(fn, reps: int):
    """Mean device milliseconds per launch by kernel name over reps calls
    of fn (after one to warm up), or None where torch.profiler records no
    device time. Per launch, not per call: the profiler has been seen to
    drop one of five launches of a kernel."""
    fn()
    rows, _ = profiled(fn, reps)
    return {key: ms / n for ms, n, key in rows} or None


def profile_run(fn):
    """fn() once under torch.profiler: device time by kernel and by
    category, and the device's idle share of the window (1 - the sum of
    kernel time over the wall; one stream, so kernels do not overlap);
    returns {wall_ms, kernel_ms, launches, idle}, or None where the
    profiler recorded no device time."""
    rows, wall_ms = profiled(fn)
    if not rows:
        say("profile: no device time recorded by torch.profiler "
            "(device breakdown not measured)")
        return None
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
    return dict(wall_ms=wall_ms, kernel_ms=busy,
                launches=sum(r[1] for r in rows),
                idle=max(0.0, 1 - busy / wall_ms))


def latency(step, frames, reps: int) -> dict:
    """Milliseconds per frame of ``step(frame)`` over frames 0..reps-1 of
    ``frames`` (B, T, F, M, 2), each synchronised (a stream's frame is
    done when its output is): mean, p50, p99, and the step's outputs."""
    import numpy as np
    import torch

    ms, outs = [], []
    for t in range(reps):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        outs.append(step(frames[:, t]))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t1) * 1e3)
    return dict(mean=float(np.mean(ms)), p50=float(np.percentile(ms, 50)),
                p99=float(np.percentile(ms, 99)), outs=outs)


def stream_phase(enh, smi: str) -> dict:
    """The port's StreamingComposed of ``enh``'s model on the card, with
    float32 products: item 00000's offline STFT frames one at a time
    against the offline model (within STREAM_TOL, no kernel launched, the
    state's bytes constant); cli.stream on that item and on the 7 val
    items in lockstep against the offline Enhancer (correlation > 0.99,
    RMS ratio in (0.8, 1.25) on the back half, as
    tests/test_stream_cli.py); and ms and kernel launches per frame at 1,
    7 and 64 streams beside the hop."""
    import shutil

    import numpy as np
    import torch

    from eabnet_tpu_torch.cli import stream as stream_cli
    from eabnet_tpu_torch.dsp import prepare_data
    from eabnet_tpu_torch.streaming import StreamingComposed, state_bytes
    from eabnet_tpu_torch.utils.audio_io import read_wav
    from eabnet_tpu_torch.utils.precision import float32_products

    cfg = enh.cfg
    hop_ms = cfg.stft.hop_samples / cfg.stft.sr * 1e3
    names = sorted(os.path.basename(p) for p in
                   glob.glob(os.path.join(VAL, "noisy", "*.wav")))
    noisy = [read_wav(os.path.join(VAL, "noisy", n))[1] for n in names]
    # the Enhancer's padding: the n_fft / 2 + 1 tail, then the 1-s bucket
    n = max(x.shape[-1] for x in noisy)
    padded = -(-(n + cfg.stft.fft_num // 2 + 1) // enh.bucket) * enh.bucket
    wavs = torch.from_numpy(np.stack([np.pad(x, ((0, 0), (0, padded - n)))
                                      for x in noisy])).cuda()
    s = StreamingComposed(enh.model)
    with float32_products("cuda"):
        frames, _ = prepare_data(wavs, None, cfg.stft)  # (7, 701, F, 9, 2)
        offline = enh.model(frames[:1])
        t_all = frames.shape[1]
        zero_launches()
        state = s.init_state(1)
        sizes = []

        def step(frame):
            nonlocal state
            state, out = s.step(state, frame)
            if len(sizes) < 8:  # the bytes after frame 8
                sizes.append(state_bytes(state))
            return out

        with torch.inference_mode():  # as cli.stream runs the step
            lat = {1: latency(step, frames[:1], t_all)}
        launches, entries = read_launches(), read_entries()
        outs = lat[1].pop("outs")
        sizes.append(state_bytes(state))
    say(f"stream: kernel launches over {t_all} frames: {launches}")
    require(not any(launches.values()) and not entries, "stream: no kernel "
            "of the port on "
            "the frame step (its LSTM step is two products, as the JAX "
            "stepper's runs outside Pallas)")
    err = {}
    for k in ("esti0", "esti"):
        got = torch.stack([o[k] for o in outs], dim=1)
        require(got.shape == offline[k].shape
                and bool(torch.isfinite(got).all()),
                f"stream {k}: finite, shape {tuple(got.shape)}")
        err[k] = (got - offline[k]).abs().max().item()
        say(f"stream {k}: {t_all} frames one at a time, max|stream - "
            f"offline| {err[k]:.3e} (largest |offline| "
            f"{offline[k].abs().max().item():.3e}; tolerance {STREAM_TOL:g})")
    require(max(err.values()) <= STREAM_TOL,
            f"stream: within {STREAM_TOL:g} of the offline model")
    require(sizes[7] == sizes[-1], f"stream: state bytes after 8 frames "
            f"({sizes[7]}) = after {t_all} ({sizes[-1]})")

    # wav level, through the CLI as a user runs it
    shutil.rmtree(STREAM_DIR, ignore_errors=True)
    os.makedirs(STREAM_DIR)
    # the file mode in a process of its own while this one streams the
    # directory: each is host-bound on one core and leaves the card idle
    # most of a frame, so the two take the time of one
    one = os.path.join(STREAM_DIR, "00000.wav")
    file_run = subprocess.Popen(
        [sys.executable, "-m", "eabnet_tpu_torch.cli.stream",
         os.path.join(VAL, "noisy", "00000.wav"), one, "--exp-root",
         EXP_CLN], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    try:
        stream_cli.main([os.path.join(VAL, "noisy"),
                         os.path.join(STREAM_DIR, "val"), "--exp-root",
                         EXP_CLN])
        log = file_run.communicate(timeout=STREAM_FILE_TIMEOUT_S)[0]
    finally:
        if file_run.poll() is None:
            file_run.kill()
            file_run.communicate()
    print(log.strip()[-2000:])
    require(file_run.returncode == 0,
            f"stream: cli.stream on one file exits 0 "
            f"(exit {file_run.returncode})")
    enh.output = "esti"
    refs = enh.enhance_batch(noisy)
    wav_checks = []
    for path, ref in [(one, refs[0])] + [
            (os.path.join(STREAM_DIR, "val", nm), r)
            for nm, r in zip(names, refs)]:
        got = read_wav(path)[1]
        lead, warm = cfg.stft.fft_num // 2, len(got) // 2
        m = min(len(ref), len(got) - lead) - warm
        a, b = got[lead + warm:lead + warm + m], ref[warm:warm + m]
        corr = float(np.corrcoef(a, b)[0, 1])
        ratio = float(np.sqrt(np.mean(a ** 2) / np.mean(b ** 2)))
        say(f"stream wav {os.path.relpath(path, STREAM_DIR)}: correlation "
            f"with the offline Enhancer {corr:.8f}, RMS ratio {ratio:.5f}")
        wav_checks.append(corr > 0.99 and 0.8 < ratio < 1.25)
    require(all(wav_checks), "stream: every streamed wav correlates > 0.99 "
            "with the offline Enhancer, RMS ratio in (0.8, 1.25)")

    # latency and launches per frame at 1, 7 and 64 streams
    per_frame = {}
    with float32_products("cuda"), torch.inference_mode():
        for b in STREAM_BATCHES:
            batch = frames[[i % len(noisy) for i in range(b)]]
            state = s.init_state(b)

            def step(frame):
                nonlocal state
                state, _ = s.step(state, frame)

            if b > 1:
                latency(step, batch, 5)  # warm-up at this batch
                lat[b] = latency(step, batch[:, 5:], STREAM_FRAMES)
                del lat[b]["outs"]
            rows, wall_ms = profiled(lambda: step(batch[:, 0]))
            busy = sum(r[0] for r in rows)
            per_frame[b] = dict(launches=sum(r[1] for r in rows),
                                kernel_ms=busy, idle=1 - busy / wall_ms)
    for b in STREAM_BATCHES:
        say(f"stream B={b}: {lat[b]['mean']:.3f} ms per frame (p50 "
            f"{lat[b]['p50']:.3f}, p99 {lat[b]['p99']:.3f}; "
            f"{'all %d frames of item 00000' % t_all if b == 1 else '%d frames after 5' % STREAM_FRAMES}), "
            f"{lat[b]['mean'] / b:.3f} ms per frame per stream, "
            f"hop {hop_ms:g} ms; one profiled frame: "
            f"{per_frame[b]['launches']} kernel launches, kernel time "
            f"{per_frame[b]['kernel_ms']:.3f} ms, device idle share "
            f"{per_frame[b]['idle']:.3f}; on {smi}")
    return dict(err=err, latency=lat, launches_per_frame=per_frame,
                state_bytes=sizes[-1], launches=launches, entries=entries)


def serve_item(enh, golden_path, want: dict, label: str = "",
               check=None, lowp: bool = False,
               stages=("esti", "esti0")):
    """Item 00000 alone through ``enh`` at ``stages``: every kernel's
    launches in one forward (must equal ``want``, keyed as LAUNCH_KEYS,
    all through the float32 entries or with ``lowp`` the bf16 ones),
    finite output, and SNR against the JAX golden (a path, or its arrays
    by stage; or ``check(stage, out)``); returns the launches of the
    ``esti`` forward, the same by C entry, and the outputs by stage."""
    import numpy as np
    import torch

    from eabnet_tpu_torch.utils.audio_io import read_wav

    _, noisy0 = read_wav(os.path.join(VAL, "noisy", "00000.wav"))
    golden = (np.load(golden_path) if isinstance(golden_path, str)
              else golden_path)
    outs = {}
    for stage in stages:
        enh.output = stage
        enh(noisy0)  # warm-up (cuDNN algorithm choice, allocator)
        torch.cuda.synchronize()
        zero_launches()
        out = enh(noisy0)
        torch.cuda.synchronize()
        launches, entries = read_launches(), read_entries()
        say(f"{label}{stage}: launches in one forward {launches}, by C "
            f"entry {entries}")
        require(launches == want and entries == want_entries(want, lowp),
                f"{label}{stage}: {want['lstm_bf']} LSTM-BF and "
                f"{want['tcm_chain']} TCM-chain forward launches, all of "
                f"the {'bf16' if lowp else 'float32'} serving kernels, no "
                "backward one")
        require(out.shape == golden[stage].shape
                and bool(np.isfinite(out).all()),
                f"{label}{stage}: finite, shape {out.shape}")
        outs[stage] = out
        if check is not None:
            check(stage, out)
        else:
            snr = snr_db(golden[stage], out)
            say(f"{label}{stage}: SNR vs the JAX golden {snr:.2f} dB")
            require(snr >= GOLDEN_MIN_SNR_DB, f"{label}{stage}: SNR vs "
                    f"golden >= {GOLDEN_MIN_SNR_DB} dB")
        if stage == "esti":
            esti_launches, esti_entries = launches, entries
    return esti_launches, esti_entries, outs


def serve_batch(enh, smi: str, label: str = "") -> dict:
    """The 7 val items as one batch through ``enh`` (stage esti): SI-SDR
    against the clean references (the mean gain over the noisy reference
    mic must be > 0) and the wall time, min of 3 after a warm-up."""
    import numpy as np
    import torch

    from eabnet_tpu_torch.eval.metrics import si_sdr
    from eabnet_tpu_torch.utils.audio_io import read_wav

    cfg = enh.cfg
    enh.output = "esti"
    names = sorted(os.path.basename(p) for p in
                   glob.glob(os.path.join(VAL, "noisy", "*.wav")))
    noisy = [read_wav(os.path.join(VAL, "noisy", n))[1] for n in names]
    clean = [read_wav(os.path.join(VAL, "clean", n))[1] for n in names]
    enh.enhance_batch(noisy)  # warm-up at the batch shape
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for _ in range(3):
        t1 = time.perf_counter()
        enhanced = enh.enhance_batch(noisy)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t1)
    gains = []
    for n, x, s, y in zip(names, noisy, clean, enhanced):
        before, after = si_sdr(s, x[cfg.model.ref_mic]), si_sdr(s, y)
        gains.append(after - before)
        say(f"{label}{n}: SI-SDR noisy ref mic {before:.3f} dB -> enhanced "
            f"{after:.3f} dB ({after - before:+.3f})")
    mean_gain = float(np.mean(gains))
    require(all(bool(np.isfinite(e).all()) for e in enhanced),
            f"{label}batch outputs finite")
    require(mean_gain > 0, f"{label}mean SI-SDR improvement {mean_gain:.3f} "
            "dB > 0")
    audio_s = sum(x.shape[-1] for x in noisy) / cfg.stft.sr
    wall = min(walls)
    peak = torch.cuda.max_memory_allocated()
    say(f"{label}batch of {len(noisy)} items ({audio_s:.1f} s of audio): "
        f"wall {wall * 1e3:.2f} ms (min of "
        f"{['%.2f' % (w * 1e3) for w in walls]} ms), real-time factor "
        f"{wall / audio_s:.5f}, peak device memory {peak} bytes, resident "
        f"parameters {enh.param_bytes()} bytes, on {smi}")
    return dict(gain=mean_gain, wall=wall, rtf=wall / audio_s, noisy=noisy,
                names=names, peak_bytes=peak, param_bytes=enh.param_bytes())


# ------------------------------------------------------------------ lowp
def lowp_rule(what: str, out, ref16, ref32, wide=None,
              spread: float = LOWP_SPREAD_DB) -> dict:
    """A bf16 kernel against its plain bf16 version (ref16): its SNR, R
    (plain bf16 against plain float32, ref32) and the bound R + 20; with
    ``wide`` (a whole TCM chain, a backward) D and the bound min(R + 20, D
    - ``spread``). D: how far float32 rounding alone moves the plain version, the
    smallest SNR between it and each of ``wide``, plain runs that take
    nothing from the kernel (the same in float64; for a backward also the
    same on inputs that differ by float32 rounding only, or on the CPU).
    Also the largest entry gap (reported, not bounded), printed."""
    f = [a.float().cpu().numpy() for a in (out, ref16, ref32)]
    snr, r = snr_db(f[1], f[0]), snr_db(f[2], f[1])
    need, d, probes = r + LOWP_KERNEL_DB, None, ""
    if wide is not None:
        ws = [w.float().cpu().numpy() for w in (
            wide if isinstance(wide, (list, tuple)) else (wide,))]
        ds = [snr_db(w, f[1]) for w in ws]
        d = min(ds)
        need = min(need, d - spread)
        # printed: each probe against the plain version and the kernel
        probes = "; probes vs plain " + ", ".join(
            f"{v:.2f}" for v in ds) + ", vs kernel " + ", ".join(
            f"{snr_db(w, f[0]):.2f}" for w in ws)
    gap = float(abs(f[0] - f[1]).max())
    say(f"{what}: kernel vs plain bf16 {snr:.2f} dB (R {r:.2f}, R + "
        f"{snr - r:.2f}" + ("" if d is None else f"; D {d:.2f}") +
        f"; needs {need:.2f}{probes}), largest entry gap {gap:.3e}")
    return dict(snr=snr, r=r, d=d, need=need, err=gap, ok=snr >= need)


def tcm_each_rule(what: str, x16, trunks, w32, w16, dils, twin: bool) -> dict:
    """Each TCM of a bf16 chain kernel alone: ``trunks`` are the float32
    trunk after each TCM as the kernel computed it (the forward's, from
    ``bf16_trunks``; or the backward's recomputed ones, one fewer). TCM j's
    on the kernel's own float32 trunk input, against the plain bf16
    version's on the same input, must reach R + 20 dB, R from the plain
    float32 version there. Printed: each TCM's margin over R and the
    largest entry gap."""
    from eabnet_tpu_torch.kernels.tcm_chain import tcm_chain_reference

    trunk, snrs, rs, gap = x16.float(), [], [], 0.0
    for j, dil in zip(range(len(trunks)), dils):
        ref32, ref16 = (tcm_chain_reference(
            trunk, tuple(w[j:j + 1] for w in ws), (dil,), twin)
            for ws in (w32, w16))
        f = [a.cpu().numpy() for a in (trunks[j], ref16, ref32)]
        snrs.append(snr_db(f[1], f[0]))
        rs.append(snr_db(f[2], f[1]))
        gap = max(gap, float(abs(f[0] - f[1]).max()))
        trunk = trunks[j]
    margins = [g - r for g, r in zip(snrs, rs)]
    say(f"{what}, each TCM alone (float32 trunk in and out): R + "
        f"{', '.join(f'{m:.2f}' for m in margins)} dB (needs R + "
        f"{LOWP_KERNEL_DB:g}), largest entry gap {gap:.3e}")
    return dict(each_snr=snrs, each_r=rs, each_err=gap,
                each_ok=min(margins) >= LOWP_KERNEL_DB)


def lowp_bound(flops: float, nbytes: float):
    """The bound of a kernel on bf16 inputs: bf16 bytes over the memory
    rate against FLOPs at bf16's dense tensor-core rate (the card's peak
    for bf16 operands); beside it the same bytes against FLOPs at the
    float32 rate, the rate of arithmetic done as float32."""
    t_ops, t_mem = flops / BF16_PEAK, nbytes / MEM_RATE
    return (max(t_ops, t_mem) * 1e3,
            "operations" if t_ops >= t_mem else "bytes",
            bound_ms(flops, nbytes)[0])


def lstm_lowp_case(bf_map, lanes: int, t: int, seed: int) -> dict:
    """The bf16 LSTM-BF forward against its plain bf16 version at (T, L),
    with the release weights; times beside nn.LSTM in bf16."""
    import torch

    from eabnet_tpu_torch.kernels.lstm_bf import (double_lstm,
                                                  double_lstm_reference)

    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((t, lanes, 64), generator=g, device="cuda")
    r1, r2 = bf_map.rnn1, bf_map.rnn2
    xw1 = (x @ r1.w_ih + (r1.b_ih + r1.b_hh)).contiguous()
    a32 = (xw1, r1.w_hh, r2.w_ih, r2.w_hh, r2.b_ih + r2.b_hh)
    a16 = tuple(a.bfloat16().contiguous() for a in a32)
    before = double_lstm.launches
    out = double_lstm(*a16)
    same = torch.equal(out, double_lstm(*a16))
    rule = lowp_rule(f"lstm_bf bf16 T={t} L={lanes}", out,
                     double_lstm_reference(*a16),
                     double_lstm_reference(*a32))
    lstm = torch.nn.LSTM(64, 64, num_layers=2).cuda()
    with torch.no_grad():
        for i, r in enumerate((r1, r2)):
            getattr(lstm, f"weight_ih_l{i}").copy_(r.w_ih.t())
            getattr(lstm, f"weight_hh_l{i}").copy_(r.w_hh.t())
            getattr(lstm, f"bias_ih_l{i}").copy_(r.b_ih)
            getattr(lstm, f"bias_hh_l{i}").copy_(r.b_hh)
    # one weight buffer, where cuDNN takes the dtype (it does not for bf16
    # here: PyTorch then warns and packs the weights on every call)
    lstm.to(torch.bfloat16).flatten_parameters()
    x16 = x.bfloat16()
    ms = cuda_ms(lambda: double_lstm(*a16), reps=20)
    plain = cuda_ms(lambda: double_lstm_reference(*a16), reps=2, warmup=1)
    try:  # the yardstick only: cuDNN's LSTM in bf16, where it runs
        library = cuda_ms(lambda: lstm(x16), reps=10)
    except RuntimeError as e:
        say(f"nn.LSTM in bf16 did not run ({e}); library time not measured")
        library = None
    double_lstm.launches = before  # comparison launches do not count
    flops = 2.0 * (64 * 256 + 128 * 256) * lanes * t
    nbytes = 2.0 * (t * lanes * 256 + t * lanes * 64 + 192 * 256 + 256)
    bms, by, f32b = lowp_bound(flops, nbytes)
    say(f"lstm_bf bf16 T={t} L={lanes}: kernel {ms:.4f} ms, plain "
        f"{plain:.4f} ms, nn.LSTM bf16 {library} ms, bound {bms:.4f} ms "
        f"({by}; {flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} MB), at the "
        f"float32 rate {f32b:.4f} ms; a second launch gives "
        f"{'the same bits' if same else 'OTHER BITS'}")
    return dict(rule, same=same, ms=ms, plain_ms=plain, library_ms=library,
                bound_ms=bms, bound_by=by, f32_bound_ms=f32b)


def tcm_lowp_case(group, b: int, t: int, seed: int) -> dict:
    """The bf16 TCM-chain forward against its plain bf16 version for one
    release group at (B, T)."""
    import torch

    from eabnet_tpu_torch.kernels.tcm_chain import (bf16_trunks, tcm_chain,
                                                    tcm_chain_reference)

    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((b, t, 256), generator=g, device="cuda")
    w32 = group.stacked_weights()
    w16 = tuple(w.bfloat16().contiguous() for w in w32)
    x16 = x.bfloat16()
    dils, twin, k = group.dilations, group.twin_gate, w32[1].shape[1]
    name = f"{'twin' if twin else 'single'} K={k}"
    before = tcm_chain.launches
    out = tcm_chain(x16, w16, dils, twin)
    same = torch.equal(out, tcm_chain(x16, w16, dils, twin))
    rule = lowp_rule(f"tcm_chain bf16 {name} B={b} T={t}", out,
                     tcm_chain_reference(x16, w16, dils, twin),
                     tcm_chain_reference(x, w32, dils, twin),
                     tcm_chain_reference(x16, w16, dils, twin,
                                         compute=torch.float64))
    each = tcm_each_rule(f"tcm_chain bf16 {name} B={b} T={t}", x16,
                         bf16_trunks(x16, w16, dils, twin), w32, w16, dils,
                         twin)
    rule.update(each, ok=rule["ok"] and each["each_ok"],
                err=max(rule["err"], each["each_err"]))
    from eabnet_tpu_torch.kernels.tcm_chain import geometry

    geo = geometry(b, t, k, twin, backward=False, lowp=True)
    ms = cuda_ms(lambda: tcm_chain(x16, w16, dils, twin), reps=50)
    plain = cuda_ms(lambda: tcm_chain_reference(x16, w16, dils, twin),
                    reps=10)
    tcm_chain.launches = before
    p, c, d = len(dils), 64, 256
    nb = 2 if twin else 1
    flops = 2.0 * b * t * p * (d * c + nb * k * c * c + c * d)
    nbytes = 2.0 * (2 * b * t * d + p * (d * c + nb * k * c * c + c * d
                                         + 9 * c))
    bms, by, f32b = lowp_bound(flops, nbytes)
    say(f"tcm_chain bf16 {name} B={b} T={t}: kernel {ms:.4f} ms, plain "
        f"{plain:.4f} ms, bound {bms:.4f} ms ({by}; {flops / 1e9:.3f} "
        f"GFLOP, {nbytes / 1e6:.2f} MB), at the float32 rate {f32b:.4f} ms; "
        f"{geo['blocks']} blocks ({geo['blocks_per_sm']} per SM); a second "
        f"launch gives {'the same bits' if same else 'OTHER BITS'}")
    return dict(rule, same=same, ms=ms, plain_ms=plain, bound_ms=bms,
                bound_by=by, f32_bound_ms=f32b, geometry=geo)


def lowp_serving(exp: str, golden_path: str, want, mode: str, f32_item,
                 f32_batch: dict, smi: str) -> dict:
    """One released model in one low-precision mode through load_enhancer:
    item 00000 at both stages against the JAX goldens (module doc, 5c),
    int8w also against the port's own float32 item outputs (f32_item),
    and the 7 val items as one batch beside float32's (f32_batch)."""
    import numpy as np
    import torch

    from eabnet_tpu_torch.inference import load_enhancer

    from eabnet_tpu_torch.cli import enhance as enhance_cli
    from eabnet_tpu_torch.utils.audio_io import read_wav

    label = f"{os.path.basename(exp)} {mode} "
    g32 = np.load(golden_path)
    glow = np.load(golden_path.replace(".npz", "_lowp.npz"))
    checks = {}

    def check(stage, out, key=None):
        r = snr_db(g32[stage], glow[f"{stage}_bfloat16"])
        to_ref = snr_db(glow[f"{stage}_{mode}"], out)
        to_f32 = snr_db(g32[stage], out)
        say(f"{label}{key or stage}: vs JAX {mode} {to_ref:.2f} dB (R "
            f"{r:.2f}, needs {r - LOWP_MODEL_DB:.2f}), vs JAX float32 "
            f"{to_f32:.2f} dB" + (f" (needs {r - LOWP_F32_DB:.2f})"
                                  if mode == "bfloat16" else ""))
        require(to_ref >= r - LOWP_MODEL_DB, f"{label}{key or stage}: >= R "
                f"- {LOWP_MODEL_DB:g} dB vs JAX {mode}")
        if mode == "bfloat16":
            require(to_f32 >= r - LOWP_F32_DB, f"{label}{key or stage}: >= "
                    f"R - {LOWP_F32_DB:g} dB vs JAX float32")
        else:
            ref = f32_item[stage]
            err = float(np.linalg.norm(out - ref) / np.linalg.norm(ref))
            corr = float(np.corrcoef(out, ref)[0, 1])
            say(f"{label}{key or stage}: vs the port's float32: relative "
                f"error {err:.4f}, correlation {corr:.5f}")
            require(err < INT8W_MAX_ERR and corr > INT8W_MIN_CORR,
                    f"{label}{key or stage}: relative error < "
                    f"{INT8W_MAX_ERR}, correlation > {INT8W_MIN_CORR} vs "
                    "float32")
        checks[key or stage] = dict(snr=to_ref, r=r, snr_f32=to_f32)

    enh = load_enhancer(exp, compute_dtype=mode, device="cuda")
    launches, entries, _ = serve_item(
        enh, golden_path, dict(zip(LAUNCH_KEYS, want)), label, check,
        lowp=True)
    # the same item through the CLI, as a user runs it
    os.makedirs(LOWP_DIR, exist_ok=True)
    wav = os.path.join(LOWP_DIR, f"{os.path.basename(exp)}_{mode}.wav")
    enhance_cli.main([os.path.join(VAL, "noisy", "00000.wav"), wav,
                      "--exp-root", exp, "--compute-dtype", mode])
    check("esti", read_wav(wav)[1], key="cli esti")
    batch = serve_batch(enh, smi, label)
    prof = profile_run(lambda: enh.enhance_batch(batch["noisy"]))
    dg = batch["gain"] - f32_batch["gain"]
    say(f"{label}batch: mean SI-SDR gain {batch['gain']:+.3f} dB (float32 "
        f"{f32_batch['gain']:+.3f}, {dg:+.3f}); wall {batch['wall'] * 1e3:.2f}"
        f" ms (float32 {f32_batch['wall'] * 1e3:.2f}), RTF "
        f"{batch['rtf']:.5f}; peak device memory {batch['peak_bytes']} "
        f"bytes (float32 {f32_batch['peak_bytes']}), resident parameters "
        f"{batch['param_bytes']} bytes (float32 "
        f"{f32_batch['param_bytes']})" + (
            f"; profiled idle share {prof['idle']:.3f} (float32 "
            f"{f32_batch['profile']['idle']:.3f})"
            if prof and f32_batch.get("profile") else ""))
    require(abs(dg) <= LOWP_GAIN_DB, f"{label}mean SI-SDR gain within "
            f"{LOWP_GAIN_DB} dB of float32's")
    del enh
    torch.cuda.empty_cache()
    return dict(launches=launches, entries=entries, item=checks,
                gain=batch["gain"],
                gain_f32=f32_batch["gain"], wall=batch["wall"],
                rtf=batch["rtf"], peak_bytes=batch["peak_bytes"],
                param_bytes=batch["param_bytes"],
                idle=prof["idle"] if prof else None)


# ------------------------------------------------------------------ eval
def read_set(root: str):
    """(names, noisy (M, N) per item, clean per item) of an offline val
    dir, in the order the datasets list it."""
    from eabnet_tpu_torch.utils.audio_io import read_wav

    names = sorted(os.listdir(os.path.join(root, "clean")))
    noisy = [read_wav(os.path.join(root, "noisy", n))[1] for n in names]
    clean = [read_wav(os.path.join(root, "clean", n))[1] for n in names]
    return names, noisy, clean


def score_shard(names, mixes, cleans, estis, sr: int):
    """The port's evaluate_dataset over estimates made beforehand, in a
    worker process (the metrics are host code): rows and seconds."""
    from eabnet_tpu_torch.eval import evaluate_dataset

    t1 = time.perf_counter()
    estimates = iter(estis)
    _, rows = evaluate_dataset(
        lambda noisy: next(estimates),
        ((m[None], c) for m, c in zip(mixes, cleans)), sr=sr, names=names)
    return rows, time.perf_counter() - t1


class Scoring:
    """Items scored by a pool of worker processes, EVAL_SHARD items a job,
    collected per (set, model, stage) key in item order."""

    def __init__(self, pool, sr: int):
        self.pool, self.sr, self.jobs = pool, sr, {}

    def submit(self, key, names, noisy, clean, estis) -> None:
        self.jobs[key] = [self.pool.submit(
            score_shard, names[i:i + EVAL_SHARD],
            [x[0] for x in noisy[i:i + EVAL_SHARD]], clean[i:i + EVAL_SHARD],
            estis[i:i + EVAL_SHARD], self.sr)
            for i in range(0, len(names), EVAL_SHARD)]

    def collect(self):
        """{key: (accumulator, rows)} and the workers' seconds in all."""
        from eabnet_tpu_torch.eval.harness import METRICS
        from eabnet_tpu_torch.eval.metrics import MetricAccumulator

        out, seconds = {}, 0.0
        for key, futures in self.jobs.items():
            acc, rows = MetricAccumulator(METRICS), []
            for f in futures:
                part, s = f.result()
                seconds += s
                rows += part
            for r in rows:
                acc.update({m: r[m] for m in METRICS if m in r})
            out[key] = (acc, rows)
        return out, seconds


def entries_since(before: dict) -> dict:
    """Launches by C entry since ``before`` (a read_entries())."""
    now = read_entries()
    return {k: n - before.get(k, 0) for k, n in now.items()
            if n - before.get(k, 0)}


def enhance_set(enh, noisy, label: str, want=None):
    """Every item through ``enh`` on the card, one forward each; the
    launches by C entry of the first forward must equal ``want``. Returns
    the estimates and the seconds spent."""
    outs, seconds = [], 0.0
    for i, x in enumerate(noisy):
        before = read_entries()
        t1 = time.perf_counter()
        outs.append(enh(x))  # returns host arrays: the card has finished
        seconds += time.perf_counter() - t1
        if i == 0 and want is not None:
            got = entries_since(before)
            say(f"eval (f) {label}: launches in one forward by C entry "
                f"{got}")
            require(got == want, f"eval (f) {label}: {want} per forward, "
                    "no bf16 or backward entry")
    return outs, seconds


def release_report(path: str) -> dict:
    """A release report's tables: {set: {"stages": {stage: {metric:
    "mean ± ci"}}, "margins": {metric: float}, "n": items}}."""
    import re

    out = {}
    for block in open(path).read().split("\n## ")[1:]:
        lines = block.splitlines()
        name, n = re.match(r"(\S+) \((\d+) items\)", lines[0]).groups()
        head = next(x for x in lines if x.startswith("| stage |"))
        keys = [c.strip() for c in head.strip().strip("|").split("|")][1:]
        stages = {}
        for x in lines:
            if x.startswith("| ") and not x.startswith("| stage |"):
                cells = [c.strip() for c in x.strip().strip("|").split("|")]
                stages[cells[0]] = dict(zip(keys, cells[1:]))
        m = next(x for x in lines if x.startswith("esti − esti0 margins:"))
        margins = {k: float(v) for k, v in (
            p.split() for p in m.split(":", 1)[1].split(","))}
        out[name] = dict(stages=stages, margins=margins, n=int(n))
    return out


def report_row(acc) -> dict:
    """{metric: "mean ± ci"} as the release reports print a stage."""
    return {k: "%.3f ± %.3f" % acc.mean_ci(k) for k in EVAL_KEYS}


def check_means(label: str, accs: dict, report: dict) -> list:
    """Each stage's means within EVAL_MEAN_TOL of the report's printed
    ones, the esti - esti0 margins within EVAL_MARGIN_TOL; returns the
    failed checks."""
    rep = report["stages"]
    bad = []
    for stage, acc in accs.items():
        row = report_row(acc)
        say(f"eval {label} {stage}: | {stage} | "
            + " | ".join(row[k] for k in EVAL_KEYS) + " |")
        say(f"eval {label} {stage}: report | {stage} | "
            + " | ".join(rep[stage][k] for k in EVAL_KEYS) + " |")
        for k in EVAL_KEYS:
            d = acc.mean_ci(k)[0] - float(rep[stage][k].split(" ± ")[0])
            if not abs(d) <= EVAL_MEAN_TOL:
                bad.append(f"{stage} {k} {d:+.4f}")
    margins = {k: accs["esti"].mean_ci(k)[0] - accs["esti0"].mean_ci(k)[0]
               for k in EVAL_KEYS}
    say(f"eval {label}: esti - esti0 margins " + ", ".join(
        f"{k} {margins[k]:+.4f} (report {report['margins'][k]:+.4f})"
        for k in EVAL_KEYS))
    bad += [f"margin {k} {margins[k] - report['margins'][k]:+.4f}"
            for k in EVAL_KEYS
            if not abs(margins[k] - report["margins"][k]) <= EVAL_MARGIN_TOL]
    what = (f"eval {label}: every mean within {EVAL_MEAN_TOL:g} of the "
            f"report's, every margin within {EVAL_MARGIN_TOL:g}")
    say(("FAIL " if bad else "PASS ") + what + (f" (outside: {bad})"
                                                if bad else ""))
    return [what] if bad else []


def nudged_scores(clean, mix, esti, metric: str) -> list:
    """``metric`` of ``esti`` moved by one float32 ulp (each sample times
    1 + eps * N(0, 1), seeded), EVAL_NUDGES times: the scores float32
    rounding of the estimate alone can give."""
    import numpy as np

    from eabnet_tpu_torch.eval.harness import cal_single_metrics

    rng = np.random.default_rng(0)
    eps = float(np.finfo(np.float32).eps)
    return [cal_single_metrics(clean, mix, (esti * (
        1 + eps * rng.standard_normal(esti.shape))).astype(np.float32))[
            metric] for _ in range(EVAL_NUDGES)]


def check_items(label: str, rows: list, ref: dict, item) -> list:
    """Per item against ``ref`` ({metric: values in item order}) at
    SCORE_TOL: the largest |difference| per metric and its item, and every
    item outside a limit with both values. Such an item passes only if a
    one-ulp nudge of the port's own estimate (``item(i)`` -> clean,
    mixture, estimate) scores within the limit of the reference: the
    metric is discontinuous there at float32 rounding (PERF.md §2).
    Returns the failed checks."""
    bad, worst, jumps = [], {}, []
    for i, row in enumerate(rows):
        for m, tol in SCORE_TOL.items():
            want = float(ref[m][i])
            d = abs(row[m] - want)
            if d >= worst.get(m, (-1.0, ""))[0]:
                worst[m] = (d, row["filename"])
            if d <= tol:
                continue
            nudged = nudged_scores(*item(i), m)
            near = min(abs(v - want) for v in nudged)
            seen = sorted(set(round(v, 6) for v in nudged))
            say(f"eval {label}: outside its limit: {row['filename']} {m}: "
                f"port {row[m]!r}, JAX {want!r}; one-ulp nudges of the "
                f"port's estimate score {seen}, nearest {near:.2e} from "
                "JAX's")
            (jumps if near <= tol else bad).append(f"{row['filename']} {m}")
    say(f"eval {label}: largest |difference| per metric (item) " + ", ".join(
        f"{m} {d:.2e} ({name})" for m, (d, name) in worst.items()))
    what = (f"eval {label}: {len(rows)} items, every score within 1e-3 "
            "(PESQ, dB metrics, LSD) / 1e-4 (STOI, ESTOI) of JAX's, or "
            "within it of a one-ulp nudge of the estimate")
    say(("FAIL " if bad else "PASS ") + what + (
        f" (at a discontinuity: {jumps})" if jumps else "")
        + (f" (outside: {bad})" if bad else ""))
    return [what] if bad else []


def eval_phase(smi: str) -> dict:
    """Both released models scored on the card as the release reports were
    (module doc, 5d): (a) to (f), then composed_9mic in bf16 and int8w."""
    import concurrent.futures
    import csv
    import multiprocessing

    import numpy as np
    import torch

    from eabnet_tpu_torch.checkpoint import latest_checkpoint, load_params
    from eabnet_tpu_torch.cli import test as cli_test
    from eabnet_tpu_torch.config import ExperimentConfig
    from eabnet_tpu_torch.inference import Enhancer

    t_phase = time.perf_counter()
    sets = {VAL: read_set(VAL), VAL_LARGE: read_set(VAL_LARGE)}
    reports = {EXP: release_report("release/REPORT.md"),
               EXP_CLN: release_report("release/REPORT_CLN.md")}
    for exp, rep in reports.items():
        for name, table in rep.items():
            require(len(sets[name][0]) == table["n"], f"eval: {name} holds "
                    f"the {table['n']} items of {exp}'s report")
    workers = max(1, min(6, (os.cpu_count() or 2) - 2))
    pool = concurrent.futures.ProcessPoolExecutor(
        workers, mp_context=multiprocessing.get_context("spawn"))
    try:
        scoring = Scoring(pool, 16000)
        for name, (names, noisy, clean) in sets.items():  # (a): no model
            scoring.submit(("noisy", name), names, noisy, clean,
                           [x[0] for x in noisy])
        zero_launches()
        enhance_s, forwards, kept = 0.0, 0, {}
        want = {EXP: {"lstm_bf_fwd": 1, "tcm_chain_fwd": 21},
                EXP_CLN: {"lstm_bf_fwd": 1}}
        plan = {EXP: (VAL_LARGE, VAL), EXP_CLN: (VAL_LARGE,)}  # (b)-(d)
        for exp, set_names in plan.items():
            cfg = ExperimentConfig.load(os.path.join(exp, "config.json"))
            params = load_params(latest_checkpoint(exp))
            enh = Enhancer(cfg, params, pad_mode="reference", device="cuda")
            for stage in ("esti0", "esti"):
                enh.output = stage
                for name in set_names:
                    names, noisy, clean = sets[name]
                    label = f"{os.path.basename(exp)} {stage} {name}"
                    estis, s = enhance_set(
                        enh, noisy, label,
                        want[exp] if name == VAL_LARGE else None)
                    enhance_s += s
                    forwards += len(noisy)
                    scoring.submit((exp, stage, name), names, noisy, clean,
                                   estis)
                    if exp == EXP and name == VAL_LARGE:
                        kept[stage] = estis
            del enh
        # the padding the records did not use: item 00000 of
        # release/val_set_large with the default zero tail, stage esti
        names, noisy, clean = sets[VAL_LARGE]
        estis, s = enhance_set(Enhancer(
            ExperimentConfig.load(os.path.join(EXP, "config.json")),
            load_params(latest_checkpoint(EXP)), device="cuda"), noisy[:1],
            "composed_9mic esti tail")
        enhance_s, forwards = enhance_s + s, forwards + 1
        scoring.submit(("tail",), names[:1], noisy[:1], clean[:1], estis)
        # (e) cli.test as a user runs it (default padding, on the card),
        # while the workers score the rest
        os.makedirs(EVAL_DIR, exist_ok=True)
        golden = np.load(EVAL_GOLDEN)
        cli_rows, t_cli = {}, time.perf_counter()
        for exp in (EXP, EXP_CLN):
            model = os.path.basename(exp)
            for stage in ("esti0", "esti"):
                prefix = os.path.join(EVAL_DIR, f"{model}_{stage}")
                cli_test.main([
                    "--config", os.path.join(exp, "config.json"),
                    "--set", f"data.val_set={VAL}",
                    "--set", f"data.speech_root={VAL}",
                    "--ckpt", latest_checkpoint(exp), "--output", stage,
                    "--out-prefix", prefix])
                with open(prefix + ".csv") as f:
                    cli_rows[model, stage] = [
                        {k: (v if k == "filename" else float(v))
                         for k, v in r.items()} for r in csv.DictReader(f)]
        t_cli = time.perf_counter() - t_cli
        eval_entries = read_entries()
        eval_wall = time.perf_counter() - t_phase
        # composed_9mic in bf16 and int8w on release/val_set, stage esti:
        # a measurement beside float32's, no limit
        zero_launches()
        cfg = ExperimentConfig.load(os.path.join(EXP, "config.json"))
        params = load_params(latest_checkpoint(EXP))
        names, noisy, clean = sets[VAL]
        for mode in LOWP_MODES:
            enh = Enhancer(cfg, params, output="esti", compute_dtype=mode,
                           pad_mode="reference", device="cuda")
            estis, _ = enhance_set(enh, noisy, f"composed_9mic {mode}")
            scoring.submit((mode,), names, noisy, clean, estis)
            del enh
        lowp_entries = read_entries()
        torch.cuda.empty_cache()
        t_wait = time.perf_counter()
        scored, score_s = scoring.collect()
        t_wait = time.perf_counter() - t_wait
    finally:
        pool.shutdown(cancel_futures=True)

    failed = []  # every check runs and prints before the phase fails

    def cli_item(model: str, stage: str):
        """Item i of release/val_set as cli.test enhanced it (default
        padding), for nudging a score outside its limit."""
        exp = f"release/{model}"
        cfg = ExperimentConfig.load(os.path.join(exp, "config.json"))
        enh = Enhancer(cfg, load_params(latest_checkpoint(exp)),
                       output=stage, device="cuda")
        names, noisy, clean = sets[VAL]
        return lambda i: (clean[i], noisy[i][0], enh(noisy[i]))

    # (a) the metric port alone: the noisy rows, digit for digit
    for name in (VAL, VAL_LARGE):
        acc, _ = scored["noisy", name]
        row = report_row(acc)
        say(f"eval (a) {name}: | noisy | "
            + " | ".join(row[k] for k in EVAL_KEYS) + " |")
        for exp, rep in reports.items():
            if name in rep:
                want_row = rep[name]["stages"]["noisy"]
                what = (f"eval (a) {name}: the noisy row of {exp}'s "
                        "report, means and CIs at 3 decimals")
                say(("PASS " if row == want_row else "FAIL ") + what)
                failed += [] if row == want_row else [what]
    # (b) composed_9mic per item against the JAX package's CSVs
    for stage in ("esti0", "esti"):
        with open(f"release/refeval_oursdec_{stage}.csv") as f:
            ref_rows = list(csv.DictReader(f))
        _, rows = scored[EXP, stage, VAL_LARGE]
        require([r["filename"] for r in rows]
                == [r["item"] + ".wav" for r in ref_rows],
                f"eval (b) {stage}: the CSV's items in order")
        names, noisy, clean = sets[VAL_LARGE]
        failed += check_items(
            f"(b) composed_9mic {stage} {VAL_LARGE}", rows,
            {m: [r[m] for r in ref_rows] for m in SCORE_TOL},
            lambda i: (clean[i], noisy[i][0], kept[stage][i]))
    tail, ref0 = scored["tail",][1][0], scored[EXP, "esti", VAL_LARGE][1][0]
    say(f"eval padding: composed_9mic esti {ref0['filename']} of "
        f"{VAL_LARGE}: SI-SDR {ref0['si_sdr']:.6f} dB, PESQ "
        f"{ref0['pesq']:.6f} with no tail (the records' featurization); "
        f"{tail['si_sdr']:.6f} dB, {tail['pesq']:.6f} with the default "
        "zero tail")
    # (c), (d): means against the reports' tables
    for exp, name, tag in ((EXP, VAL, "(c)"), (EXP, VAL_LARGE, "(b)"),
                           (EXP_CLN, VAL_LARGE, "(d)")):
        failed += check_means(
            f"{tag} {os.path.basename(exp)} {name}",
            {s: scored[exp, s, name][0] for s in ("esti0", "esti")},
            reports[exp][name])
    # (e) cli.test against the JAX package's cli.test
    for (model, stage), rows in cli_rows.items():
        key = f"{model}/{stage}/"
        require([r["filename"] for r in rows]
                == list(golden[key + "filename"]),
                f"eval (e) {model} {stage}: the golden's items")
        failed += check_items(f"(e) cli.test {model} {stage}", rows,
                              {m: golden[key + m] for m in SCORE_TOL},
                              lambda i: cli_item(model, stage)(i))
    # bf16 and int8w beside float32 (release/val_set, esti, no tail)
    f32 = report_row(scored[EXP, "esti", VAL][0])
    say("eval lowp composed_9mic esti release/val_set: float32 | "
        + " | ".join(f32[k] for k in EVAL_KEYS) + " |")
    lowp = {}
    for mode in LOWP_MODES:
        acc = scored[mode,][0]
        row = report_row(acc)
        say(f"eval lowp composed_9mic esti release/val_set: {mode} | "
            + " | ".join(row[k] for k in EVAL_KEYS) + " |")
        lowp[mode] = {k: acc.mean_ci(k)[0] for k in EVAL_KEYS}
    say(f"eval lowp: launches by C entry over the 14 forwards "
        f"{lowp_entries}")
    # (f) time
    n_scored = sum(len(rows) for _, rows in scored.values()) + sum(
        len(r) for r in cli_rows.values())
    wall = time.perf_counter() - t_phase
    say(f"eval (f): launches by C entry over the phase's float32 forwards "
        f"({forwards} items + cli.test's 28) {eval_entries}")
    say(f"eval (f): wall {wall:.1f} s ({eval_wall:.1f} s to the end of the "
        f"float32 forwards and cli.test; waiting on the scores after them "
        f"{t_wait:.1f} s); {n_scored} items scored, "
        f"{n_scored / wall:.2f} items/s; host seconds enhancing "
        f"{enhance_s:.1f} ({forwards} forwards, "
        f"{1e3 * enhance_s / forwards:.1f} ms each), scoring {score_s:.1f} "
        f"in {workers} worker processes; cli.test x 4 (28 forwards and "
        f"scorings in this process) {t_cli:.1f} s; on {smi}")
    require(not failed, f"eval: every check of (a) to (e) (failed: "
            f"{failed})")
    return dict(entries=eval_entries, lowp_entries=lowp_entries, wall=wall,
                enhance_s=enhance_s, score_s=score_s, cli_s=t_cli,
                workers=workers, n_scored=n_scored, lowp=lowp,
                items_per_s=n_scored / wall)


# ---------------------------------------------------------- bf16 training
def lstm_train_lowp_case(bf_map, lanes: int, t: int, seed: int) -> dict:
    """The bf16 LSTM-BF training forward and backward kernels against their
    plain bf16 versions at (T, L), release weights, seeded inputs: the four
    sequences at R + 20 dB (R from the plain float32 forward); the
    backward on the kernel's own sequences, each output at min(R + 20, D
    - 3) (R from the plain float32 backward on the float32 sequences, D
    from the plain bf16 backward in float64). Times beside cuDNN's LSTM in
    bf16 (forward with grad, and backward)."""
    import torch

    from eabnet_tpu_torch.kernels import lstm_bf as K

    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((t, lanes, 64), generator=g, device="cuda")
    dy = torch.randn((t, lanes, 64), generator=g, device="cuda")
    r1, r2 = bf_map.rnn1, bf_map.rnn2
    xw1 = (x @ r1.w_ih + (r1.b_ih + r1.b_hh)).contiguous()
    a32 = (xw1, r1.w_hh, r2.w_ih, r2.w_hh, r2.b_ih + r2.b_hh)
    a16 = tuple(a.bfloat16().contiguous() for a in a32)
    dy16 = dy.bfloat16()
    before = (K.double_lstm.launches, K.double_lstm.bwd_launches)
    states = K._launch_fwd(*a16, states=True)
    fwd_same = all(torch.equal(a, b) for a, b in
                   zip(states, K._launch_fwd(*a16, states=True)))
    ref16 = K.double_lstm_states_reference(*a16)
    ref32 = K.double_lstm_states_reference(*a32)
    name = f"lstm_bf bf16 train T={t} L={lanes}"
    fwd = [lowp_rule(f"{name} forward {n}", a, b, c) for n, a, b, c in zip(
        ("h1", "c1", "h2", "c2"), states, ref16, ref32)]
    got = K._launch_bwd(a16[0], dy16, *states, *a16[1:])
    again = K._launch_bwd(a16[0], dy16, *states, *a16[1:])
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    p16 = K.double_lstm_bwd_reference(a16[0], dy16, *states, *a16[1:])
    p32 = K.double_lstm_bwd_reference(xw1, dy16.float(), *ref32, *a32[1:])
    p64 = K.double_lstm_bwd_reference(a16[0], dy16, *states, *a16[1:],
                                      compute=torch.float64)
    # the same on the plain forward's sequences: they differ from the
    # kernel's by float32 rounding only (roundings to bf16 that flip)
    pown = K.double_lstm_bwd_reference(a16[0], dy16, *ref16, *a16[1:])
    bwd = [lowp_rule(f"{name} backward {n}", a, b, c, w)
           for n, a, b, c, w in zip(("dxw1", "dw_hh1", "dw_ih2", "dw_hh2",
                                     "db2"), got, p16, p32, zip(p64, pown))]
    lstm = torch.nn.LSTM(64, 64, num_layers=2).cuda()
    with torch.no_grad():
        for i, r in enumerate((r1, r2)):
            getattr(lstm, f"weight_ih_l{i}").copy_(r.w_ih.t())
            getattr(lstm, f"weight_hh_l{i}").copy_(r.w_hh.t())
            getattr(lstm, f"bias_ih_l{i}").copy_(r.b_ih)
            getattr(lstm, f"bias_hh_l{i}").copy_(r.b_hh)
    lstm.to(torch.bfloat16).flatten_parameters()
    xg = x.bfloat16().requires_grad_()
    with torch.enable_grad():
        fwd_ms = cuda_ms(lambda: K._launch_fwd(*a16, states=True), reps=5)
        ms = cuda_ms(lambda: K._launch_bwd(a16[0], dy16, *states, *a16[1:]),
                     reps=5)
        split = lstm_split(device_ms(
            lambda: K._launch_bwd(a16[0], dy16, *states, *a16[1:]), reps=3))
        plain_fwd = cuda_ms(lambda: K.double_lstm_states_reference(*a16),
                            reps=1, warmup=1)
        plain = cuda_ms(lambda: K.double_lstm_bwd_reference(
            a16[0], dy16, *states, *a16[1:]), reps=1, warmup=1)
        try:  # the yardstick only: cuDNN's LSTM in bf16, where it runs
            lib_out = lstm(xg)[0]
            library_fwd = cuda_ms(lambda: lstm(xg), reps=5)
            library = cuda_ms(lambda: torch.autograd.backward(
                lib_out, dy16, retain_graph=True), reps=5)
        except RuntimeError as e:
            say(f"nn.LSTM in bf16 did not run ({e}); library time not "
                "measured")
            library_fwd = library = None
    K.double_lstm.launches, K.double_lstm.bwd_launches = before
    rows = t * lanes
    flops = 2.0 * 9 * 64 * 256 * rows
    nbytes = 2.0 * (rows * (256 + 64 + 4 * 64 + 256)
                    + 2 * (3 * 64 * 256 + 256))
    bms, by, f32b = lowp_bound(flops, nbytes)
    fwd_bms, fwd_by, fwd_f32b = lowp_bound(
        2.0 * 3 * 64 * 256 * rows,
        2.0 * (rows * (256 + 4 * 64) + 3 * 64 * 256 + 256))
    say(f"{name}: training forward {fwd_ms:.4f} ms (plain {plain_fwd:.4f}, "
        f"cuDNN LSTM bf16 forward with grad {library_fwd} ms, bound "
        f"{fwd_bms:.4f} ms ({fwd_by}), at the float32 rate "
        f"{fwd_f32b:.4f}); backward {ms:.4f} ms = "
        + ("(split not measured)" if split is None else
           f"walk {split['walk']:.4f} + GEMM {split['wgrad']:.4f} + sum "
           f"{split['sum']:.4f}")
        + f" (plain {plain:.4f}, cuDNN LSTM bf16 backward {library} ms, "
        f"bound {bms:.4f} ms ({by}; {flops / 1e9:.3f} GFLOP, "
        f"{nbytes / 1e6:.2f} MB), at the float32 rate {f32b:.4f}); "
        f"second launches give {'the same bits' if fwd_same and same else 'OTHER BITS'}")
    return dict(
        fwd=fwd, bwd=bwd, same=fwd_same and same,
        ok=all(r["ok"] for r in fwd + bwd) and fwd_same and same,
        err=max(r["err"] for r in fwd + bwd), fwd_err=max(
            r["err"] for r in fwd),
        ms=ms, plain_ms=plain, library_ms=library, bound_ms=bms,
        bound_by=by, f32_bound_ms=f32b, split_ms=split, fwd_ms=fwd_ms,
        plain_fwd_ms=plain_fwd, library_fwd_ms=library_fwd,
        fwd_bound_ms=fwd_bms, fwd_bound_by=fwd_by, fwd_f32_bound_ms=fwd_f32b)


TCM_GRADS = ("dwi", "dwl", "dwr", "dwo", "dalphas", "dgammas", "dbetas")


def tcm_bwd_lowp_case(group, b: int, t: int, seed: int) -> dict:
    """The bf16 TCM-chain backward kernel against its plain bf16 version
    for one release group at (B, T). The trunk the backward recomputes:
    after each TCM (but the last) at R + 20 dB against that TCM's plain
    bf16 version on the kernel's trunk input (tcm_each_rule). Each TCM
    alone, on its float32 trunk input and float32 cotangent as the kernel
    carried them: its cotangent out at R + 20 dB, R from the same TCM with
    float32 weights; its weight gradients at min(R + 20, D - 3), D from
    plain probes of that TCM that take nothing from the kernel
    (``tcm_chain_bwd_probes``); its dwo against the float64 sum of its own
    operands. The whole chain: every output at min(R + 20, D - 6), D from
    the same probes of the chain (LOWP_CHAIN_BWD_SPREAD_DB)."""
    import torch

    from eabnet_tpu_torch.kernels import tcm_chain as K

    g = torch.Generator(device="cuda").manual_seed(seed)
    x16 = torch.randn((b, t, 256), generator=g, device="cuda").bfloat16()
    dy16 = torch.randn((b, t, 256), generator=g, device="cuda").bfloat16()
    w32 = tuple(w.detach() for w in group.stacked_weights())
    w16 = tuple(w.bfloat16().contiguous() for w in w32)
    dils, twin, k = group.dilations, group.twin_gate, w32[1].shape[1]
    name = f"tcm_chain bf16 bwd {'twin' if twin else 'single'} K={k} B={b}"
    before = (K.tcm_chain.launches, K.tcm_chain.bwd_launches)
    dx, dw, acts = K._launch_bwd(x16, dy16, w16, dils, twin,
                                 activations=True)
    again = K._launch_bwd(x16, dy16, w16, dils, twin)
    same = torch.equal(dx, again[0]) and all(
        torch.equal(a, c) for a, c in zip(dw, again[1]))
    # the recomputed trunk, TCM by TCM; beside it, whether it is the
    # forward kernel's trunk bit for bit
    p = len(dils)
    trunk = tcm_each_rule(f"{name} recomputed trunk", x16, list(acts["x"]),
                          w32, w16, dils, twin)
    fwd_trunks = K.bf16_trunks(x16, w16, dils, twin)[:p - 1]
    say(f"{name}: the recomputed trunk is the forward kernel's bit for bit: "
        f"{all(torch.equal(a, c) for a, c in zip(acts['x'], fwd_trunks))}")

    def held(what, a, r16, r32, wide=None, spread=LOWP_SPREAD_DB):
        if r16.float().abs().max().item() == 0:  # single: wr, table row 1
            ok = a.float().abs().max().item() == 0
            say(f"{what}: zero in the plain version, the kernel's zero: {ok}")
            return dict(ok=ok, err=0.0, snr=float("inf"), need=0.0, r=0.0,
                        d=None)
        return lowp_rule(what, a, r16, r32, wide, spread)

    # each TCM alone: trunk in, cotangent in and out as the kernel had them
    trunks = [x16.float()] + list(acts["x"])
    cots = list(acts["dy"]) + [dy16.float()]
    outs = [dx] + list(acts["dy"])  # TCM 0's: dx, rounded to bf16
    each, margins, wmargins = [], [], []
    for j in range(p):
        wj = [tuple(w[j:j + 1] for w in ws) for ws in (w32, w16)]
        args = (trunks[j], cots[j])
        p16 = K.tcm_chain_bwd_reference(*args, wj[1], dils[j:j + 1], twin)
        p32 = K.tcm_chain_bwd_reference(*args, wj[0], dils[j:j + 1], twin)
        probes = K.tcm_chain_bwd_probes(*args, wj[1], dils[j:j + 1], twin,
                                        seed=seed + 100 * j)
        r = lowp_rule(f"{name} TCM {j} dx", outs[j],
                      p16[0].to(outs[j].dtype), p32[0])
        each.append(r)
        margins.append(r["snr"] - r["r"])
        ws = [held(f"{name} TCM {j} {n}", a, q16, q32,
                   tuple(q[1][i] for q in probes))
              for i, (n, a, q16, q32) in enumerate(zip(
                  TCM_GRADS, (v[j:j + 1] for v in dw), p16[1], p32[1]))]
        each += ws
        wmargins.append({n: w["snr"] - w["r"] for n, w in zip(TCM_GRADS, ws)
                         if w["d"] is not None})
    # the weight-gradient sums: each TCM's dwo against the float64 sum of
    # its operands as the kernel kept them (no and the cotangent at TCM
    # j's output, rounded to bf16 as the GEMM takes them), rounded once
    sums = []
    for j in range(p):
        ref = torch.einsum("btc,btd->cd", acts["no"][j].bfloat16().double(),
                           cots[j].bfloat16().double()).bfloat16()
        sums.append(snr_db(ref.float().cpu().numpy(),
                           dw[3][j].float().cpu().numpy()))
    say(f"{name}: each TCM's dwo against the float64 sum of its own "
        f"operands rounded once: {', '.join(f'{v:.2f}' for v in sums)} dB "
        f"(needs {LOWP_SUM_DB:g})")
    # the whole chain
    c16 = K.tcm_chain_bwd_reference(x16, dy16, w16, dils, twin)
    c32 = K.tcm_chain_bwd_reference(x16.float(), dy16.float(), w32, dils,
                                    twin)
    probes = K.tcm_chain_bwd_probes(x16, dy16, w16, dils, twin, seed=seed)
    chain = [held(f"{name} chain {n}", a, r16, r32, ws,
                  LOWP_CHAIN_BWD_SPREAD_DB)
             for n, a, r16, r32, ws in zip(
                 ("dx",) + TCM_GRADS, (dx,) + dw, (c16[0],) + c16[1],
                 (c32[0],) + c32[1], zip(*(((q[0],) + q[1]) for q in probes)))]
    geo = K.geometry(b, t, k, twin, backward=True, lowp=True)
    ms = cuda_ms(lambda: K._launch_bwd(x16, dy16, w16, dils, twin), reps=10)
    by_kernel = device_ms(lambda: K._launch_bwd(x16, dy16, w16, dils, twin),
                          reps=5)
    split = None if by_kernel is None else {
        part: sum(v for key, v in by_kernel.items() if f"::{fn}" in key)
        for part, fn in (("walk", "tcm_chain_bwd_kernel"),
                         ("wgrad", "tcm_chain_wgrad_kernel"),
                         ("sum", "tcm_chain_grad_sum_kernel"))}
    plain = cuda_ms(lambda: K.tcm_chain_bwd_reference(x16, dy16, w16, dils,
                                                      twin),
                    reps=3, warmup=1)
    K.tcm_chain.launches, K.tcm_chain.bwd_launches = before
    c, d = 64, 256
    nb = 2 if twin else 1
    flops = 3 * 2.0 * b * t * p * (d * c + nb * k * c * c + c * d)
    wvals = p * (d * c + nb * k * c * c + c * d + 9 * c)
    nbytes = 2.0 * (3 * b * t * d + 2 * wvals)
    bms, by, f32b = lowp_bound(flops, nbytes)
    say(f"{name}: kernel {ms:.4f} ms = " + (
        "(split not measured)" if split is None else
        f"walk {split['walk']:.4f} + GEMM {split['wgrad']:.4f} + sum "
        f"{split['sum']:.4f}") + f", plain {plain:.4f} ms, bound "
        f"{bms:.4f} ms ({by}; {flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} "
        f"MB), at the float32 rate {f32b:.4f} ms; {geo['blocks']} blocks "
        f"({geo['blocks_per_sm']} per SM); each TCM's dx R + "
        f"{', '.join(f'{m:.2f}' for m in margins)} (needs R + "
        f"{LOWP_KERNEL_DB:g}); a second launch gives "
        f"{'the same bits' if same else 'OTHER BITS'}")
    sum_ok = min(sums) >= LOWP_SUM_DB
    each_ok = all(r["ok"] for r in each)
    return dict(ok=each_ok and trunk["each_ok"] and sum_ok
                and all(r["ok"] for r in chain) and same,
                each_ok=each_ok, each_margins=margins,
                each_wgrad_margins=wmargins, trunk_ok=trunk["each_ok"],
                trunk_margins=[a - r for a, r in zip(trunk["each_snr"],
                                                     trunk["each_r"])],
                sums=sums, sum_ok=sum_ok, chain=chain, same=same,
                err=max(r["err"] for r in chain), ms=ms, plain_ms=plain,
                bound_ms=bms, bound_by=by, f32_bound_ms=f32b, split_ms=split,
                geometry=geo, snr={n: r["snr"] for n, r in zip(
                    ("dx",) + TCM_GRADS, chain)},
                need={n: r["need"] for n, r in zip(("dx",) + TCM_GRADS,
                                                    chain)})


def bf16_loss_rule(got, golden) -> dict:
    """The bf16 train losses (steps, 3) against the golden's JAX bf16 and
    float32 losses of the same steps: every loss divided by JAX's float32
    one, as one vector; R = SNR(JAX float32, JAX bf16), and the port must
    reach R - 6 dB against JAX bf16 and R - 3 against JAX float32, and
    carry bf16's noise: at most R + LOWP_F32_CAP_DB from JAX float32 (a
    float32 step sits far above that)."""
    import numpy as np

    j16, j32 = golden["losses"], golden["losses_f32"]
    v = [np.asarray(a, np.float64) / j32 for a in (got, j16, j32)]
    r = snr_db(v[2], v[1])
    s16, s32 = snr_db(v[1], v[0]), snr_db(v[2], v[0])
    ok = bool(np.isfinite(got).all()) and s16 >= r - LOWP_MODEL_DB \
        and r - LOWP_F32_DB <= s32 <= r + LOWP_F32_CAP_DB
    return dict(r=r, s16=s16, s32=s32, ok=ok)


def bf16_train_rule(name: str = "bf16") -> dict:
    """The bf16 run whose losses are compared: train() from the release
    40000.params with the bf16 golden's config under cuDNN's deterministic
    algorithms; -> bf16_loss_rule's numbers and the losses."""
    import numpy as np
    import torch

    golden = np.load(TRAIN_BF16_GOLDEN)
    cfg_dict = json.loads(str(golden["config"]))
    torch.backends.cudnn.deterministic = True
    try:
        got = train_run(name, cfg_dict, 40000 + len(golden["losses"]))[0]
    finally:
        torch.backends.cudnn.deterministic = False
    return dict(bf16_loss_rule(got, golden), losses=got.tolist())


def train_bf16_phase(cfg_f32: dict, f32_losses) -> dict:
    """bf16 training on the card: release/composed_9mic in bf16 from
    40000.params on release/val_set, 5 steps of batch 7 at T = 601: the
    launches per step (1 + 21 + 1 + 21), step time, items/s, peak memory
    and one profiled step; under cuDNN's deterministic algorithms the
    losses against the JAX golden (bf16_loss_rule). Then 2 bf16 steps of
    release/eabnet_9mic_cln (launches 1 / 0 / 1 / 0 per step, finite
    losses, step time). ``cfg_f32``: the float32 train phase's config, for
    the cLN run's data and optimizer settings; ``f32_losses``: that
    phase's losses of the same 5 steps in float32, the control that the
    bf16 loss rule must reject."""
    import numpy as np
    import torch

    from eabnet_tpu_torch.config import ExperimentConfig
    from eabnet_tpu_torch.data.datasets import OfflineMcseDataset
    from eabnet_tpu_torch.train.checkpoint import load_checkpoint
    from eabnet_tpu_torch.train.step import (create_train_state,
                                             make_train_step)

    golden = np.load(TRAIN_BF16_GOLDEN)
    cfg_dict = json.loads(str(golden["config"]))
    n = len(golden["losses"])
    zero_launches()
    hist = train_run("bf16_timed", cfg_dict, 40000 + n)[1]
    launches, entries = read_launches(), read_entries()
    say(f"train_bf16: launches over {n} steps: {launches}, by C entry "
        f"{entries}")
    want = dict(zip(LAUNCH_KEYS, (n, 21 * n, n, 21 * n)))
    require(launches == want and entries == want_entries(want, True, True),
            "train_bf16: 1 + 1 LSTM-BF and 21 + 21 TCM-chain launches per "
            "step, all of the bf16 training kernels")
    rule = bf16_train_rule()
    got = np.asarray(rule.pop("losses"))
    for i in range(n):
        say(f"train_bf16 step {40001 + i}: losses {LOSS_KEYS} "
            f"{got[i].tolist()} vs JAX bf16 {golden['losses'][i].tolist()} "
            f"and float32 {golden['losses_f32'][i].tolist()}")
    say(f"train_bf16: losses over JAX float32 as one vector: R {rule['r']:.2f} "
        f"dB (JAX bf16 vs float32); port vs JAX bf16 {rule['s16']:.2f} dB "
        f"(needs R - {LOWP_MODEL_DB:g} = {rule['r'] - LOWP_MODEL_DB:.2f}), "
        f"vs JAX float32 {rule['s32']:.2f} dB (needs R - {LOWP_F32_DB:g} = "
        f"{rule['r'] - LOWP_F32_DB:.2f} to R + {LOWP_F32_CAP_DB:g} = "
        f"{rule['r'] + LOWP_F32_CAP_DB:.2f})")
    require(rule["ok"], f"train_bf16: {n} finite steps whose losses meet "
            "the bf16 loss rule against the JAX golden")
    control = bf16_loss_rule(np.asarray(f32_losses), golden)
    say(f"train_bf16: the float32 train phase's losses of the same steps "
        f"(the control): vs JAX bf16 {control['s16']:.2f} dB, vs JAX "
        f"float32 {control['s32']:.2f} dB (a bf16 step: at most R + "
        f"{LOWP_F32_CAP_DB:g} = {rule['r'] + LOWP_F32_CAP_DB:.2f})")
    require(not control["ok"], "train_bf16: the bf16 loss rule rejects the "
            "same steps in float32")
    step_s = min(h["seconds"] for h in hist[1:])
    cfg = ExperimentConfig.from_dict(cfg_dict)
    batch = cfg.train.batch_size
    say(f"train_bf16: step time {step_s * 1e3:.2f} ms (min of steps 2-{n}: "
        f"{[round(h['seconds'] * 1e3, 2) for h in hist[1:]]}; step 1 "
        f"{hist[0]['seconds'] * 1e3:.2f} ms), {batch / step_s:.2f} items/s "
        f"at batch {batch}, T = {TRAIN_T}")
    ckpt = os.path.join(TRAIN_DIR, "bf16_timed", "ckpt", f"{40000 + n}.ckpt")
    state = load_checkpoint(ckpt, create_train_state(cfg, "cuda"), cfg)[0]
    require(all(p.dtype == torch.float32 for p in state.model.parameters())
            and all(v.dtype == torch.float32
                    for v in state.opt_state.mu.values()),
            "train_bf16: the checkpoint keeps float32 params and moments")
    ds = OfflineMcseDataset(cfg.data.speech_root, cfg.data.transfer_int16)
    items = [ds[i] for i in range(batch)]
    noisy = torch.from_numpy(np.stack([x for x, _ in items])).cuda()
    clean = torch.from_numpy(np.stack([y for _, y in items])).cuda()
    step = make_train_step(cfg)
    step(state, noisy, clean)  # warm-up at this shape
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    prof = profile_run(lambda: step(state, noisy, clean))
    peak = torch.cuda.max_memory_allocated()
    say(f"train_bf16: peak device memory of a step {peak / 2 ** 30:.2f} GiB")
    del state

    # the flagship recipe's norm: eabnet_9mic_cln in bf16, 2 steps
    with open(os.path.join(EXP_CLN, "config.json")) as f:
        d = json.load(f)
    d["model"]["freeze_eabnet"] = False
    d["data"] = dict(cfg_f32["data"])
    d["train"].update({k: cfg_f32["train"][k] for k in (
        "lr", "grad_clip", "batch_size", "log_every", "total_epoch")})
    d["train"]["compute_dtype"] = "bfloat16"
    start = os.path.join(EXP_CLN, "50000.params")
    zero_launches()
    cln_got, cln_hist = train_run("bf16_cln", d, 50000 + CLN_BF16_STEPS,
                                  start=start)
    cln_launches, cln_entries = read_launches(), read_entries()
    m = CLN_BF16_STEPS
    say(f"train_bf16 cln: losses {cln_got.tolist()}, launches over {m} "
        f"steps {cln_launches}, by C entry {cln_entries}, step times "
        f"{[round(h['seconds'] * 1e3, 2) for h in cln_hist]} ms")
    want = dict(zip(LAUNCH_KEYS, (m, 0, m, 0)))
    require(cln_launches == want
            and cln_entries == want_entries(want, True, True)
            and bool(np.isfinite(cln_got).all()),
            "train_bf16 cln: 1 / 0 / 1 / 0 launches per step, all of the "
            "bf16 training kernels, finite losses")
    return dict(launches=launches, entries=entries, step_s=step_s,
                items_s=batch / step_s, rule=rule, control=control,
                peak_bytes=peak, profile=prof, cln_launches=cln_launches,
                cln_entries=cln_entries,
                cln_step_s=min(h["seconds"] for h in cln_hist[1:]))


# ---------------------------------------------------------------- online
ONLINE_DIR = "build/chip_smoke_online"
# the flagship recipe (examples/train_online_scene.sh, tools/long_train.py):
# a formant-synth corpus of 160 speech and 24 noise files of 6 s (seeds of
# tools/e2e_demo.py:38-43), its settings (tools/e2e_demo.py:47-62), 3
# loader workers, batch 16, 12 frozen validation items
ONLINE_SETTINGS = {
    "audio": {"fs": 16000, "rir_method": "hybrid"},
    "room": {"min_dim": [3, 3, 2.5], "max_dim": [10, 10, 3],
             "rt60": [0.05, 0.7]},
    "mic_array": {
        "mics": [{"x": 0.0, "y": round(0.16 - 0.04 * i, 2)}
                 for i in range(9)],
        "ref_mic": 0, "direction": {"x": 0, "y": 1},
        "h": [1, 1.5], "min_dist_to_wall": 0.5,
    },
    "target": {"dist_to_mic_array": [1, 5], "h": [1, 1.5],
               "min_dist_to_wall": 0.5, "fixed_doa": True},
    "noise": {"min_doa_diff_wrt_target": 5, "min_dist_to_mic_array": 0.5,
              "n": [1, 3], "h": [1, 1.5], "SNR": [-5, 5]},
    "noisy_dBFS": [-35, -15],
}
ONLINE_CORPUS = (160, 24, 6.0)  # speech files, noise files, seconds
ONLINE_VAL, ONLINE_BATCH, ONLINE_WORKERS = 12, 16, 3
ONLINE_STEPS = 4        # the flagship run (scene mode)
ONLINE_MODE_STEPS = 3   # each other mode
ONLINE_MODES = (False, "loader", "parts", "scene")
# the JAX data tests' tolerances (tests/test_data.py, test_scene_mix.py)
PARTS_ATOL, PARTS_RTOL, INT16_ATOL = 2e-5, 1e-4, 1e-3
EARLY_ATOL, EARLY_RTOL, TAIL_RTOL, RIR_ENERGY_RTOL = 3e-5, 1e-3, 1e-4, 0.08
NATIVE_ATOL = 1e-5
HOST_VS_PARTS_RTOL = 1e-3  # step-1 losses of modes False and "parts"


def stage_online(root: str) -> dict:
    """The flagship recipe's data, staged the way tools/long_train.py does
    it, with the port's own tools: the corpus, the settings, cli.split's
    lists and a frozen validation set of ONLINE_VAL items from
    cli.datagen (ONLINE_WORKERS spawned workers)."""
    from eabnet_tpu_torch.cli.datagen import main as datagen
    from eabnet_tpu_torch.cli.split import main as split
    from eabnet_tpu_torch.data.synth_speech import synth_noise, synth_utterance
    from eabnet_tpu_torch.utils.audio_io import write_wav

    n_speech, n_noise, seconds = ONLINE_CORPUS
    paths = {k: os.path.join(root, k) for k in ("speech", "noise", "lists",
                                                "val")}
    for k in ("speech", "noise"):
        os.makedirs(paths[k])
    t0 = time.perf_counter()
    for i in range(n_speech):
        write_wav(os.path.join(paths["speech"], f"sp{i:03d}.wav"), 16000,
                  synth_utterance(seconds, 16000, seed=7000 + i))
    for i in range(n_noise):
        write_wav(os.path.join(paths["noise"], f"no{i:03d}.wav"), 16000,
                  synth_noise(seconds, 16000, kind=i, seed=9000 + i))
    paths["settings"] = os.path.join(root, "settings.json")
    with open(paths["settings"], "w") as f:
        json.dump(ONLINE_SETTINGS, f)
    t_corpus = time.perf_counter() - t0
    split(["--speech-root", paths["speech"], "--noise-root", paths["noise"],
           "--out-dir", paths["lists"]])
    t1 = time.perf_counter()
    # --items: the val list of this corpus holds 7 files, and the recipe's
    # --limit 12 would render 7 items
    datagen(["--output-dir", paths["val"], "--speech-root", paths["speech"],
             "--noise-root", paths["noise"],
             "--speech-list", os.path.join(paths["lists"], "speechs_val"),
             "--noise-list", os.path.join(paths["lists"], "noises_val"),
             "--mcse-settings", paths["settings"],
             "--clip-seconds", str(seconds),
             "--workers", str(ONLINE_WORKERS), "--items", str(ONLINE_VAL)])
    say(f"online: staged {n_speech} speech + {n_noise} noise files of "
        f"{seconds:g} s in {t_corpus:.1f} s, the val set of "
        f"{len(os.listdir(os.path.join(paths['val'], 'noisy')))} items in "
        f"{time.perf_counter() - t1:.1f} s ({ONLINE_WORKERS} workers)")
    return paths


def flagship_config(paths: dict, run: str, **data) -> dict:
    """The flagship recipe's config as tools/long_train.py builds it for
    examples/train_online_scene.sh (release-sized EaBNet and GaGNet, cLN
    in both, bf16, batch 16, 6-s clips, online scene mode with int16
    transport, 3 workers), validating once before training; ``data``
    overrides data keys."""
    from eabnet_tpu_torch.config import ExperimentConfig

    d = json.loads(ExperimentConfig().to_json())
    for net in ("eabnet", "gagnet"):
        d["model"][net]["norm_type"] = "cLN"
    d["model"]["eabnet"]["bf_impl"] = "pallas"
    d["data"].update(
        dataset="mcse", train_set="online", speech_root=paths["speech"],
        noise_root=paths["noise"],
        speech_list=os.path.join(paths["lists"], "speechs_train"),
        noise_list=os.path.join(paths["lists"], "noises_train"),
        device_mix="scene", transfer_int16=True,
        mcse_settings=paths["settings"], val_set=paths["val"],
        clip_seconds=ONLINE_CORPUS[2], num_workers=ONLINE_WORKERS)
    d["data"].update(data)
    d["train"].update(
        batch_size=ONLINE_BATCH, wav_len=ONLINE_CORPUS[2],
        total_epoch=10 ** 9, log_every=50, lr=5e-4, valid_interval=1e18,
        saving_interval=1e18, fixed_seed=True, compute_dtype="bfloat16",
        validate_once_before_train=True,
        checkpoint_dir=os.path.join(ONLINE_DIR, run, "ckpt"),
        exp_root=os.path.join(ONLINE_DIR, run))
    return d


def replay_scene(opt: dict, seed: int, n_noise_files: int):
    """The scene synthesize_item draws for ``seed`` (the same RNG prefix)."""
    import numpy as np

    from eabnet_tpu_torch.data.scenes import sample_scene

    rng = np.random.default_rng(seed)
    k = int(rng.integers(opt["noise"]["n"][0], opt["noise"]["n"][1] + 1))
    rng.integers(0, n_noise_files, size=k)
    return sample_scene(opt, rng, n_noises_override=k)


def host_items(ds, n: int) -> dict:
    """Items 0..n-1 of epoch 0 in the three host forms (the same seeds,
    the native RIR engine) and each form's items per second in this
    process."""
    from eabnet_tpu_torch.data.datasets import synthesize_item
    from eabnet_tpu_torch.data.device_mix import synthesize_item_parts
    from eabnet_tpu_torch.data.scene_mix import synthesize_item_scene

    out, rate = {}, {}
    for kind, fn in (("host", synthesize_item),
                     ("parts", synthesize_item_parts),
                     ("scene", synthesize_item_scene)):
        t0 = time.perf_counter()
        items = []
        for i in range(n):
            args = dict(ds.item_args(i, 0), rir_backend="native")
            if kind == "scene":
                args["speech_index"] = i
            items.append(fn(**args))
        rate[kind] = n / (time.perf_counter() - t0)
        out[kind] = items
    return out, rate


def native_check(ds, seeds) -> float:
    """The native engine against the numpy RIRs: the JAX test's room and
    the hybrid RIRs of the given scenes (same RNG for the tails); -> the
    largest difference over the common length."""
    import numpy as np

    from eabnet_tpu_torch.data.rir import inverse_sabine, shoebox_rir
    from eabnet_tpu_torch.data.rir_native import shoebox_rir_native

    room, mics = [6.0, 5.0, 3.0], np.array([[4.0, 3.0, 1.5],
                                            [4.1, 3.0, 1.5]])
    e_abs, order = inverse_sabine(0.3, room)
    cases = [(room, [2, 2, 1.5], mics, e_abs, order, {})]
    for seed in seeds:
        sc = replay_scene(ds.opt, seed, len(ds.noise_list))
        for p in [sc.p_target] + list(sc.p_noises):
            cases.append((sc.room_dim, p, sc.p_mics, sc.e_absorption,
                          sc.max_order, dict(method=sc.rir_method,
                                             rt60=sc.rt60)))
    worst, lengths_ok = 0.0, True
    for room_, src, mics_, e, o, kw in cases:
        a = shoebox_rir(room_, src, mics_, e, o, 16000,
                        rng=np.random.default_rng(1), **kw)
        b = shoebox_rir_native(room_, src, mics_, e, o, 16000,
                               rng=np.random.default_rng(1), **kw)
        n = min(a.shape[1], b.shape[1])
        lengths_ok &= abs(a.shape[1] - b.shape[1]) <= 81 and all(
            h.shape[1] == n or np.abs(h[:, n:]).max() < NATIVE_ATOL
            for h in (a, b))
        worst = max(worst, float(np.abs(a[:, :n] - b[:, :n]).max()))
    say(f"online: native RIR engine vs numpy over {len(cases)} RIRs: "
        f"largest difference {worst:.3e} (limit {NATIVE_ATOL:g})")
    require(worst <= NATIVE_ATOL and lengths_ok,
            f"online: native RIRs within {NATIVE_ATOL:g} of numpy's, "
            f"lengths within the 81-tap filter")
    return worst


def device_mix_checks(ds, items, dims) -> dict:
    """The device halves on the card at the flagship's shapes against the
    host path for the same seeds."""
    import numpy as np
    import torch

    from eabnet_tpu_torch.data.device_mix import (batch_to_device,
                                                  collate_parts, mix_parts)
    from eabnet_tpu_torch.data.rir import (DEFAULT_AIR_ABSORPTION,
                                           ism_early_rir)
    from eabnet_tpu_torch.data.scene_mix import (collate_scenes,
                                                 load_corpus_int16,
                                                 mix_scene,
                                                 scene_early_rirs,
                                                 scene_tails)

    dev = "cuda"
    host = items["host"]
    h_noisy = np.stack([x for x, _ in host])
    h_clean = np.stack([y for _, y in host])
    s_max = 1 + int(ds.opt["noise"]["n"][1])
    res = {}
    f32 = batch_to_device(collate_parts(items["parts"], s_max=s_max,
                                        rir_pad=dims["l_rir"]), dev)
    q16 = batch_to_device(collate_parts(items["parts"], s_max=s_max,
                                        rir_pad=dims["l_rir"],
                                        quantize=True), dev)
    with torch.no_grad():
        n = f32["sources"].shape[-1]
        pn, pc = (x.cpu().numpy() for x in mix_parts(f32, n))
        qn, qc = (x.cpu().numpy() for x in mix_parts(q16, n))
    res["parts_err"] = (float(np.abs(pn - h_noisy).max()
                              / np.abs(h_noisy).max()),
                        float(np.abs(pc - h_clean).max()
                              / np.abs(h_clean).max()))
    say(f"online: mix_parts vs synthesize_item ({len(host)} items, "
        f"{ONLINE_CORPUS[2]:g} s): noisy {res['parts_err'][0]:.3e}, clean "
        f"{res['parts_err'][1]:.3e} of the peak (limit {PARTS_ATOL:g}, rtol "
        f"{PARTS_RTOL:g})")
    require(np.allclose(pn, h_noisy, atol=PARTS_ATOL * np.abs(h_noisy).max(),
                        rtol=PARTS_RTOL)
            and np.allclose(pc, h_clean,
                            atol=PARTS_ATOL * np.abs(h_clean).max(),
                            rtol=PARTS_RTOL),
            "online: mix_parts on the card matches the host path")
    res["int16_err"] = float(max(np.abs(qn - pn).max() / np.abs(pn).max(),
                                 np.abs(qc - pc).max() / np.abs(pc).max()))
    say(f"online: int16 transport vs float32: {res['int16_err']:.3e} of the "
        f"peak (limit {INT16_ATOL:g})")
    require(res["int16_err"] <= INT16_ATOL,
            "online: the int16 transport within 1e-3 of float32")

    batch = collate_scenes(items["scene"], dims)
    t = batch_to_device(batch, dev)
    with torch.no_grad():
        early = scene_early_rirs(t["delays"], t["amps"],
                                 dims["early_pad"]).cpu().numpy()
        tail = scene_tails(t["hist_amp"], batch["tail_seeds"],
                           dims["spb"]).cpu().numpy()
    # the early RIRs against ism_early_rir on the replayed scenes
    worst_early, early_ok = 0.0, True
    full_e = []
    for i, it in enumerate(items["scene"]):
        sc = replay_scene(ds.opt, ds.item_args(i, 0)["seed"],
                          len(ds.noise_list))
        srcs = [sc.p_target] + list(sc.p_noises)
        for s, p in enumerate(srcs):
            ref, _ = ism_early_rir(sc.room_dim, p, sc.p_mics,
                                   sc.e_absorption, 3, 16000,
                                   air_absorption=DEFAULT_AIR_ABSORPTION)
            got = early[i, s, :, :ref.shape[1]]
            scale = np.abs(ref).max()
            early_ok &= bool(np.allclose(
                got, ref, atol=EARLY_ATOL * scale, rtol=EARLY_RTOL)) and (
                np.abs(early[i, s, :, ref.shape[1]:]).max() <= 1e-6 * scale)
            worst_early = max(worst_early,
                              float(np.abs(got - ref).max() / scale))
            full = np.zeros((early.shape[2], dims["l_rir"]))
            full[:, :early.shape[-1]] += early[i, s]
            full[:, :tail.shape[-1]] += tail[i, s]
            host_rir = items["parts"][i][1][s].astype(np.float64)
            full_e.append(((full ** 2).sum(-1),
                           (host_rir ** 2).sum(-1)))
    res["early_err"] = worst_early
    e_dev = np.concatenate([a for a, _ in full_e])
    e_host = np.concatenate([b for _, b in full_e])
    res["rir_energy_rel"] = float(np.abs(e_dev / e_host - 1).max())
    b, s, m, nb = batch["hist_amp"].shape
    energy = (tail.reshape(b, s, m, nb, dims["spb"]).astype(np.float64)
              ** 2).sum(-1)
    want = batch["hist_amp"].astype(np.float64) ** 2
    res["tail_rel"] = float((np.abs(energy - want)
                             / np.maximum(want, 1e-30))[want > 0].max())
    say(f"online: scene early RIRs vs ism_early_rir: {worst_early:.3e} of "
        f"the peak (limit {EARLY_ATOL:g}); per-bin tail energy vs "
        f"hist_amp^2: {res['tail_rel']:.3e} relative (limit {TAIL_RTOL:g}); "
        f"full-RIR energy per (source, mic) vs the host render: "
        f"{res['rir_energy_rel']:.4f} relative at most (limit "
        f"{RIR_ENERGY_RTOL:g})")
    require(early_ok, f"online: every early RIR within {EARLY_ATOL:g} of "
            "ism_early_rir (rtol 1e-3), nothing past it")
    require(res["tail_rel"] <= TAIL_RTOL
            and (energy[want == 0] == 0).all(),
            "online: tail energy per bin is hist_amp^2 (zero where it is)")
    require(res["rir_energy_rel"] <= RIR_ENERGY_RTOL,
            "online: rebuilt RIR energies match the host render")

    corpus = tuple(
        torch.from_numpy(load_corpus_int16(root, names, 16000)).to(dev)
        for root, names in ((ds.speech_root, ds.speech_list),
                            (ds.noise_root, ds.noise_list)))
    with torch.no_grad():
        noisy, clean = mix_scene(t, *corpus, dims)
        clean = clean.cpu().numpy()
        res["clean_err"] = float(np.abs(clean - h_clean).max()
                                 / np.abs(h_clean).max())
        require(noisy.shape == (b, 9, dims["n"])
                and bool(torch.isfinite(noisy).all())
                and np.allclose(clean, h_clean,
                                atol=EARLY_ATOL * np.abs(h_clean).max(),
                                rtol=EARLY_RTOL),
                f"online: scene clean target within {EARLY_ATOL:g} of the "
                f"host direct path ({res['clean_err']:.3e}), noisy finite")
        parts_off = mix_parts(q16, n)
        t0 = time.perf_counter()
        torch.use_deterministic_algorithms(True)
        try:
            twice = [mix_scene(t, *corpus, dims) for _ in range(2)]
            twice_parts = [mix_parts(q16, n) for _ in range(2)]
            torch.cuda.synchronize()
        finally:
            torch.use_deterministic_algorithms(False)
    same = all(torch.equal(a, b_) for pair in (twice, twice_parts)
               for a, b_ in zip(*pair))
    off = torch.equal(twice[0][0], noisy) and torch.equal(
        twice_parts[0][0], parts_off[0])
    say(f"online: the mixes under deterministic algorithms, twice each: "
        f"{time.perf_counter() - t0:.2f} s")
    require(same and off, "online: mix_scene and mix_parts give the same "
            "bits twice under deterministic algorithms, and without them")
    res["corpus_bytes"] = sum(c.numel() * c.element_size() for c in corpus)
    res["corpus"] = corpus
    return res


def kernel_time(fn):
    """fn() once under torch.profiler recording the device alone (a
    train step's host events would cost more to collect than the step)
    -> (kernel ms or None where no device time was recorded, wall ms)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t1) * 1e3
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3
    return (busy or None), wall


def timed_mix(fn, reps: int = 3) -> dict:
    """A mix's time per call: host ms around synchronised calls, device ms
    between CUDA events, and its kernel time (torch.profiler, None where
    it recorded no device time: it has dropped them late in full runs)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / reps
    return dict(ms=ms, device_ms=cuda_ms(fn, reps, warmup=0),
                kernel_ms=kernel_time(fn)[0])


def mode_profiles(cfg_dict: dict, items, dims, corpus, smi: str) -> dict:
    """For each data mode: one train step of the flagship model on a batch
    of the 16 items, profiled after a warm-up (kernel time, idle share),
    the mix alone (its kernel time and host ms), the peak device memory
    and the host-to-device bytes of the batch."""
    import numpy as np
    import torch

    from eabnet_tpu_torch.config import ExperimentConfig
    from eabnet_tpu_torch.data.datasets import _collate
    from eabnet_tpu_torch.data.device_mix import (batch_to_device,
                                                  collate_parts,
                                                  device_mix_batch,
                                                  mix_parts)
    from eabnet_tpu_torch.data.scene_mix import collate_scenes, mix_scene
    from eabnet_tpu_torch.train.step import (create_train_state,
                                             make_train_step)
    from eabnet_tpu_torch.utils.precision import float32_products

    cfg = ExperimentConfig.from_dict(cfg_dict)
    s_max = 1 + int(ONLINE_SETTINGS["noise"]["n"][1])
    out = {}
    with float32_products("cuda"):
        state = create_train_state(cfg, "cuda")
        for mode in ONLINE_MODES:
            if mode == "scene":
                host = collate_scenes(items["scene"], dims)
                batch = batch_to_device(host, "cuda")
                step = make_train_step(cfg, "scene", dims)
                args = (batch, *corpus)
                mix = lambda: mix_scene(batch, *corpus, dims)  # noqa: E731
            elif mode == "parts":
                host = collate_parts(items["parts"], s_max=s_max,
                                     rir_pad=dims["l_rir"], quantize=True)
                batch = batch_to_device(host, "cuda")
                step = make_train_step(cfg, "parts", dims)
                args = (batch,)
                mix = lambda: mix_parts(batch, dims["n"])  # noqa: E731
            else:
                if mode == "loader":
                    noisy, clean = device_mix_batch(items["parts"],
                                                    device="cuda")
                    host = (noisy, clean, np.full((len(noisy),),
                                                  noisy.shape[-1], np.int32))
                    mix = lambda: device_mix_batch(  # noqa: E731
                        items["parts"], device="cuda")
                else:
                    host = _collate(items["host"])
                    mix = None
                step = make_train_step(cfg)
                args = tuple(torch.from_numpy(a).cuda() for a in host)
            nbytes = (sum(v.nbytes for k, v in host.items()
                          if k != "tail_seeds") if isinstance(host, dict)
                      else sum(a.nbytes for a in host))
            with torch.no_grad():
                m = timed_mix(mix) if mix else dict(ms=0.0, device_ms=0.0,
                                                    kernel_ms=0.0)
            if not out:
                step(state, *args)  # warm-up (every mode's model shapes)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            busy, wall = kernel_time(lambda: step(state, *args))
            out[str(mode)] = dict(
                bytes=nbytes, mix_ms=m["ms"], mix_device_ms=m["device_ms"],
                mix_kernel_ms=m["kernel_ms"],
                step_kernel_ms=busy, profiled_wall_ms=wall,
                idle=None if busy is None else max(0.0, 1 - busy / wall),
                peak_bytes=torch.cuda.max_memory_allocated())
            r = out[str(mode)]
            say(f"online {mode}: one profiled step {wall:.1f} ms wall, "
                f"kernel time {busy if busy is None else round(busy, 2)} ms "
                f"(idle {r['idle'] if busy is None else round(r['idle'], 3)})"
                f", the mix alone {m['ms']:.2f} ms host / "
                f"{m['device_ms']:.2f} ms device (CUDA events) / "
                f"{m['kernel_ms']} ms kernel, peak memory "
                f"{r['peak_bytes'] / 2 ** 30:.2f} GiB, host-to-device "
                f"{nbytes / 1e6:.2f} MB a batch ({smi})")
    del state
    return out


def online_phase(smi: str) -> dict:
    """Online synthesis feeding the flagship recipe's training on the card
    (PERF.md §4's online cell): staging, host checks, the device mixes
    against the host path, the flagship run through cli.train (scene
    mode, 3 spawned workers, launches per step), a stopped-and-resumed
    run against an uninterrupted one, the other data modes, and per mode
    the step, the loader's wait, the bytes, the mix's device time, idle
    share and peak memory."""
    import shutil

    import numpy as np
    import torch

    from eabnet_tpu_torch.cli.train import main as train_cli
    from eabnet_tpu_torch.config import ExperimentConfig
    from eabnet_tpu_torch.data.datasets import OnlineMcseDataset
    from eabnet_tpu_torch.data.scene_mix import scene_static_dims
    from eabnet_tpu_torch.train.trainer import train

    shutil.rmtree(ONLINE_DIR, ignore_errors=True)
    paths = stage_online(os.path.join(ONLINE_DIR, "data"))
    cfg_dict = flagship_config(paths, "flagship")
    cfg = ExperimentConfig.from_dict(cfg_dict)
    ds = OnlineMcseDataset(cfg.data, seed=cfg.train.seed)
    dims = scene_static_dims(ds.opt, cfg.data.clip_seconds)
    say(f"online: scene dims {dims}, {len(ds)} training speech files, "
        f"{len(ds.noise_list)} noise files")

    items, rate = host_items(ds, ONLINE_BATCH)
    say(f"online: host items per second in one process (native RIRs): "
        f"full synthesis {rate['host']:.2f}, parts {rate['parts']:.2f}, "
        f"scene parameters {rate['scene']:.2f}")
    native_err = native_check(ds, [ds.item_args(i, 0)["seed"]
                                   for i in range(4)])
    checks = device_mix_checks(ds, items, dims)
    corpus = checks.pop("corpus")

    # the flagship run through the CLI: scene mode, 3 spawned workers
    cfg_path = os.path.join(ONLINE_DIR, "flagship.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg_dict, f, indent=2)
    zero_launches()
    hist = train_cli(["--config", cfg_path, "--max-steps", str(ONLINE_STEPS),
                      "--device", "cuda"])
    launches, entries = read_launches(), read_entries()
    n_val = len(os.listdir(os.path.join(paths["val"], "noisy")))
    say(f"online flagship: losses {[[round(h[k], 6) for k in LOSS_KEYS] for h in hist]}, "
        f"launches {launches}, by C entry {entries}")
    require(len(hist) == ONLINE_STEPS and all(
        np.isfinite(h[k]) for h in hist for k in LOSS_KEYS),
        f"online flagship: {ONLINE_STEPS} finite steps through cli.train")
    want = {"lstm_bf_fwd_train_bf16": ONLINE_STEPS,
            "lstm_bf_bwd_bf16": ONLINE_STEPS, "lstm_bf_fwd": n_val}
    require(entries == want and launches["tcm_chain"] == 0
            and launches["tcm_chain_bwd"] == 0,
            f"online flagship: one bf16 LSTM-BF training forward and "
            f"backward per step, {n_val} float32 forwards validating, no "
            f"TCM-chain launch")

    # a run stopped at an epoch's end and resumed, against one that did not
    # stop: 32 speech files make an epoch of 2 steps (no workers: the
    # batches do not depend on them, tests/test_torch_online_host.py)
    short = os.path.join(ONLINE_DIR, "speechs_32")
    with open(short, "w") as f:
        f.write("\n".join(ds.speech_list[:2 * ONLINE_BATCH]))
    torch.backends.cudnn.deterministic = True
    try:
        runs = {}
        for name, stops in (("stopped", (2, 3)), ("straight", (3,))):
            d = flagship_config(paths, f"resume_{name}", speech_list=short)
            d["data"]["num_workers"] = 0
            d["train"]["validate_once_before_train"] = False
            c = ExperimentConfig.from_dict(d)
            runs[name] = [train(c, max_steps=s, device="cuda",
                                tensorboard=False) for s in stops]
    finally:
        torch.backends.cudnn.deterministic = False
    r, s_ = runs["stopped"][1], runs["straight"][0]
    say(f"online resume: step 3 after stopping at the end of epoch 0 "
        f"{[r[0][k] for k in LOSS_KEYS]} (epoch {r[0]['epoch']}), without "
        f"stopping {[s_[2][k] for k in LOSS_KEYS]} (epoch {s_[2]['epoch']})")
    require(len(r) == 1 and r[0]["step"] == 3 and r[0]["epoch"] == 1
            and all(abs(r[0][k] - s_[2][k]) <= 1e-6 * abs(s_[2][k])
                    for k in LOSS_KEYS),
            "online resume: the resumed step's losses equal the "
            "uninterrupted run's (within 1e-6 relative)")

    # the other modes, a few steps each
    modes = {"scene": hist}
    for mode in ONLINE_MODES[:-1]:
        d = flagship_config(paths, f"mode_{mode}", device_mix=mode)
        d["train"]["validate_once_before_train"] = False
        modes[str(mode)] = train(ExperimentConfig.from_dict(d),
                                 max_steps=ONLINE_MODE_STEPS, device="cuda",
                                 tensorboard=False)
        require(all(np.isfinite(h[k]) for h in modes[str(mode)]
                    for k in LOSS_KEYS),
                f"online {mode}: {ONLINE_MODE_STEPS} finite steps")
    l_host, l_parts = modes["False"][0]["final"], modes["parts"][0]["final"]
    say(f"online: step-1 loss, mode False {l_host!r}, parts {l_parts!r} "
        f"(relative {abs(l_parts - l_host) / abs(l_host):.3e})")
    require(abs(l_parts - l_host) <= HOST_VS_PARTS_RTOL * abs(l_host),
            f"online: modes False and parts see the same audio (step-1 "
            f"losses within {HOST_VS_PARTS_RTOL:g})")

    prof = mode_profiles(cfg_dict, items, dims, corpus, smi)
    summary = {}
    for mode, h in modes.items():
        later = h[1:]
        summary[mode] = dict(
            step_ms=float(np.median([x["seconds"] for x in later])) * 1e3,
            wait_ms=float(np.median([x["wait"] for x in later])) * 1e3,
            first_wait_s=h[0]["wait"], bytes=h[0]["bytes"],
            items_s=ONLINE_BATCH / float(np.median(
                [x["seconds"] + x["wait"] for x in later])),
            **{k: prof[mode][k] for k in ("mix_ms", "mix_device_ms",
                                          "mix_kernel_ms", "step_kernel_ms",
                                          "idle", "peak_bytes")})
        v = summary[mode]
        say(f"online {mode}: step {v['step_ms']:.1f} ms (median of steps 2-"
            f"{len(h)}), waited on the loader {v['wait_ms']:.1f} ms a step "
            f"(first batch {v['first_wait_s']:.1f} s), {v['items_s']:.2f} "
            f"items/s, host-to-device {v['bytes'] / 1e6:.2f} MB a step, the "
            f"mix {v['mix_device_ms']:.2f} ms on the card, idle "
            f"{v['idle']}, peak {v['peak_bytes'] / 2 ** 30:.2f} GiB ({smi})")
    say(f"online: resident corpus {checks['corpus_bytes'] / 1e6:.2f} MB; "
        f"host items/s per worker: full synthesis {rate['host']:.2f}, "
        f"parts {rate['parts']:.2f}, scene {rate['scene']:.2f} ({smi})")
    del corpus
    return dict(entries=entries, launches=launches, modes=summary,
                host_items_s=rate, native_err=native_err,
                checks=checks, paths=paths,
                flagship_step1=hist[0]["final"])


# ------------------------------------------------------------------- ddp
DDP_BATCH, DDP_STEPS, DDP_WORLD = 6, 3, 2
DDP_GRAD_ATOL, DDP_GRAD_RTOL = 1e-5, 1e-3  # tests/test_train_multichip.py
DDP_ONLINE_STEPS, DDP_ONLINE_RTOL = 2, 1e-3
DDP_SERVE_ATOL = 2e-5  # tests/test_inference_mesh.py:75
DDP_RANK_TIMEOUT_S = 300


def rank_settings():
    """What each rank process sets itself (a spawned process inherits none
    of the parent's flags): cuDNN's deterministic algorithms and no TF32
    in convolutions or products."""
    import torch

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def param_digest(model) -> int:
    """A position-weighted sum of the parameters' bit patterns, on the
    device (equal for equal bits; ~a millisecond, so the step walls keep
    it out)."""
    import torch

    bits = torch.cat([p.detach().reshape(-1) for p in model.parameters()]
                     ).view(torch.int32).to(torch.int64)
    weights = torch.arange(bits.numel(), device=bits.device) % 65521 + 1
    return int((bits * weights).sum())


class recorded_steps:
    """Around a train() run: the gradients the first step clips (the
    global batch's, all-reduced in a group), a digest of the parameters
    after every step, and, with ``profile_step``, that step (1-based)
    timed with its all-reduces (``self.profile``: timed_step's)."""

    def __init__(self, profile_step: int = 0):
        self.profile_step = profile_step
        self.profile = None

    def __enter__(self):
        from eabnet_tpu_torch.train import step as P
        from eabnet_tpu_torch.train import trainer as T

        self.grads, self.digests = {}, []
        self._saved = (P.clip_by_global_norm, T.make_train_step)
        clip, make = self._saved

        def first_grads(grads, max_norm):
            if not self.grads:
                self.grads = {k: v.detach().cpu().numpy()
                              for k, v in grads.items()}
            return clip(grads, max_norm)

        def digested(*args, **kwargs):
            step = make(*args, **kwargs)

            def run(state, *batch):
                if len(self.digests) + 1 == self.profile_step:
                    out, self.profile = timed_step(
                        lambda: step(state, *batch))
                else:
                    out = step(state, *batch)
                self.digests.append(param_digest(state.model))
                return out
            return run

        P.clip_by_global_norm, T.make_train_step = first_grads, digested
        return self

    def __exit__(self, *exc):
        from eabnet_tpu_torch.train import step as P
        from eabnet_tpu_torch.train import trainer as T

        P.clip_by_global_norm, T.make_train_step = self._saved
        return False


def timed_step(fn):
    """fn() (a train step) on the host clock, the card synchronised before
    and after, with each all-reduce it makes timed alone (the card
    synchronised around it: from its inputs ready to its result ready)
    -> (its result, {step_ms, allreduce_ms, allreduce_calls})."""
    import torch
    import torch.distributed as dist

    all_reduce, times = dist.all_reduce, []

    def timed(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = all_reduce(*args, **kwargs)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        return out

    dist.all_reduce = timed
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    finally:
        dist.all_reduce = all_reduce
    return out, dict(step_ms=wall, allreduce_ms=sum(times),
                     allreduce_calls=len(times))


def allreduce_alone_ms(numel: int) -> float:
    """A float32 all-reduce of ``numel`` entries on the card, staged as the
    step stages it (to the collective's device and back), host clock, the
    mean of 3 after one."""
    import numpy as np
    import torch

    from eabnet_tpu_torch.parallel.mesh import all_reduced

    buf = torch.zeros(numel, device="cuda")
    times = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        all_reduced(buf)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.mean(times[1:]))


def free_card(label: str) -> None:
    """Give this process's cached device memory back before ranks start on
    the same card (the earlier phases leave the caching allocator holding
    tens of GB; a rank's cuDNN then fails to get its workspace)."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    say(f"{label}: card memory free {free / 2 ** 30:.2f} of "
        f"{total / 2 ** 30:.2f} GiB, this process holds "
        f"{torch.cuda.memory_reserved() / 2 ** 30:.2f} GiB")


def ddp_train_rank(name: str, cfg_dict: dict, max_steps: int, device: str):
    """One rank of a data-parallel run of train() (spawned): its losses,
    step walls (the last step timed with its all-reduces: timed_step),
    launches by C entry, the step-1 gradients (rank 0), the parameters' digest after
    every step, a gradient-sized all-reduce alone, the peak memory, and
    the seconds from the process's start to torch imported, through
    train()."""
    import torch

    from eabnet_tpu_torch.kernels._build import load_library
    from eabnet_tpu_torch.parallel.mesh import process_index
    from eabnet_tpu_torch.utils.precision import float32_products

    rank_settings()
    load_library()
    t_ready = time.perf_counter() - T0
    zero_launches()
    with recorded_steps(DDP_STEPS) as rec, float32_products(device):
        losses, hist = train_run(name, cfg_dict, max_steps, device=device)
    entries = read_entries()
    numel = sum(v.size for v in rec.grads.values()) if rec.grads else 0
    return dict(losses=losses, seconds=[h["seconds"] for h in hist],
                entries=entries, digests=rec.digests,
                grads=rec.grads if process_index() == 0 else None,
                allreduce_alone_ms=allreduce_alone_ms(numel + 3),
                buffer_mb=(numel + 3) * 4 / 1e6,
                peak_bytes=torch.cuda.max_memory_allocated(),
                ready_s=t_ready, trained_s=time.perf_counter() - T0,
                **rec.profile)


def ddp_online_rank(cfg_dict: dict, max_steps: int):
    """One rank of the flagship's online bf16 run (spawned): losses, step
    walls, loader waits, launches by C entry, the corpus bytes it loaded
    onto its card, the peak memory."""
    import torch

    from eabnet_tpu_torch.config import ExperimentConfig
    from eabnet_tpu_torch.data import scene_mix
    from eabnet_tpu_torch.kernels._build import load_library
    from eabnet_tpu_torch.train.trainer import train
    from eabnet_tpu_torch.utils.precision import float32_products

    rank_settings()
    load_library()
    corpus, load = [], scene_mix.load_corpus_int16

    def recorded(*args, **kwargs):
        c = load(*args, **kwargs)
        corpus.append(int(c.nbytes))
        return c

    scene_mix.load_corpus_int16 = recorded
    zero_launches()
    with float32_products("cuda:0"):
        hist = train(ExperimentConfig.from_dict(cfg_dict),
                     max_steps=max_steps, device="cuda:0", tensorboard=False)
    return dict(losses=[[h[k] for k in LOSS_KEYS] for h in hist],
                seconds=[h["seconds"] for h in hist],
                wait=[h["wait"] for h in hist], entries=read_entries(),
                corpus_bytes=corpus,
                peak_bytes=torch.cuda.max_memory_allocated("cuda:0"))


def queued_syncs(enh, rows: int, samples: int) -> list:
    """The host syncs that torch's sync debug mode reports while every
    replica's forward of a batch (``rows`` items of ``samples`` each per
    replica, already on its device) is queued: each one would hold the
    next replica's forward back behind this one's."""
    import warnings

    import torch

    from eabnet_tpu_torch.utils.precision import float32_products

    ins = [torch.zeros((rows, enh.cfg.model.eabnet.M, samples), device=d)
           for d in enh.devices]
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for k, x in enumerate(ins):
                with float32_products(x.device), torch.no_grad():
                    enh._enhance(x, k)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    # the mode's own notice ("a prototype feature") is not a sync
    return [str(w.message)[:120] for w in caught
            if "synchronizing" in str(w.message)
            and "prototype" not in str(w.message)]


def ddp_serving(smi: str) -> dict:
    """Enhancer(mesh=make_mesh(devices=[cuda:0, cuda:0])) against the
    one-replica Enhancer on the 7 val items (padded to 8, 4 per replica),
    both released models in float32 and bf16: outputs within 2e-5, the
    launches per replica, no host sync while the replicas' forwards are
    queued, the walls (min of 3 after a warm-up)."""
    import numpy as np
    import torch

    from eabnet_tpu_torch.inference import load_enhancer
    from eabnet_tpu_torch.parallel import make_mesh

    _, noisy, _ = read_set(VAL)
    mesh = make_mesh(devices=["cuda:0", "cuda:0"])
    out = {}
    for exp, per_forward in ((EXP, (1, 21, 0, 0)), (EXP_CLN, (1, 0, 0, 0))):
        for dtype in ("float32", "bfloat16"):
            label = f"{os.path.basename(exp)} {dtype}"
            walls = {}
            outs = {}
            for kind, kw in (("one", {}), ("mesh", {"mesh": mesh})):
                enh = load_enhancer(exp, compute_dtype=dtype, device="cuda",
                                    **kw)
                enh.enhance_batch(noisy)  # warm-up at the batch shape
                if kind == "mesh":
                    zero_launches()
                    outs[kind] = enh.enhance_batch(noisy)
                    torch.cuda.synchronize()
                    entries = read_entries()
                    samples = -(-(max(x.shape[-1] for x in noisy)
                                  + enh.cfg.stft.fft_num // 2 + 1)
                                // enh.bucket) * enh.bucket
                    syncs = queued_syncs(enh, 4, samples)
                else:
                    outs[kind] = enh.enhance_batch(noisy)
                ws = []
                for _ in range(3):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    enh.enhance_batch(noisy)
                    torch.cuda.synchronize()
                    ws.append(time.perf_counter() - t0)
                walls[kind] = min(ws)
                del enh
            err = max(float(np.abs(a - b).max())
                      for a, b in zip(outs["mesh"], outs["one"]))
            want = {k: 2 * v for k, v in want_entries(
                dict(zip(LAUNCH_KEYS, per_forward)),
                dtype == "bfloat16").items()}
            say(f"ddp serve {label}: 7 items over 2 replicas on cuda:0 "
                f"against one replica: max |diff| {err:.3e}; launches "
                f"{entries} (2 replicas); host syncs while the forwards "
                f"are queued {len(syncs)} {syncs[:2]}; wall "
                f"{walls['mesh'] * 1e3:.2f} ms, one replica "
                f"{walls['one'] * 1e3:.2f} ms ({smi})")
            require(not syncs, f"ddp serve {label}: no host sync while "
                    "the replicas' forwards are queued")
            require(err <= DDP_SERVE_ATOL,
                    f"ddp serve {label}: within {DDP_SERVE_ATOL:g} of one "
                    f"replica")
            require(entries == want, f"ddp serve {label}: launches per "
                    f"replica as one forward's ({want}, 2 replicas)")
            out[label] = dict(err=err, entries=entries, syncs=len(syncs),
                              wall_ms=walls["mesh"] * 1e3,
                              one_wall_ms=walls["one"] * 1e3)
    return out


def ddp_phase(smi: str, online_paths: dict, online_step1: float) -> dict:
    """Data-parallel training and batch serving on the one card (PERF.md
    §4's ddp cell): composed_9mic float32 from 40000.params, global batch
    6 of release/val_set, 3 steps as (a) one process, (b) NCCL at world 1
    and (c) two gloo ranks on cuda:0; the flagship's online bf16 run on
    two gloo ranks; Enhancer(mesh=...) with two replicas on cuda:0."""
    import numpy as np

    from eabnet_tpu_torch.parallel import launch
    from eabnet_tpu_torch.train.checkpoint import load_checkpoint
    from eabnet_tpu_torch.train.step import create_train_state
    from eabnet_tpu_torch.config import ExperimentConfig

    launch.build_once(cuda=True)  # the ranks find the libraries built
    golden = np.load(TRAIN_GOLDEN)
    cfg_dict = json.loads(str(golden["config"]))
    cfg_dict["train"]["batch_size"] = DDP_BATCH
    last = 40000 + DDP_STEPS
    for name in ("ddp_a", "ddp_nccl", "ddp_gloo"):
        stage_train_run(name)

    import torch

    torch.backends.cudnn.deterministic = True
    try:
        zero_launches()
        with recorded_steps() as rec_a:
            a, hist_a = train_run("ddp_a", cfg_dict, last)
        a_entries = read_entries()
        spreads = np.array([
            np.abs(train_run(f"ddp_ulp{seed}", cfg_dict, last,
                             params=one_ulp_params(seed))[0] - a) / np.abs(a)
            for seed in range(TRAIN_ULP_RUNS)])
    finally:
        torch.backends.cudnn.deterministic = False
    tol = loss_tolerance(spreads.max(axis=0))
    want = want_entries(dict(zip(LAUNCH_KEYS, (DDP_STEPS, 21 * DDP_STEPS,
                                               DDP_STEPS, 21 * DDP_STEPS))),
                        False, True)
    say(f"ddp (a) one process: losses {a.tolist()}, step walls "
        f"{[round(h['seconds'] * 1e3, 2) for h in hist_a]} ms, launches "
        f"{a_entries}; one-ulp spread per step {spreads.max(axis=0).tolist()}")
    free_card("ddp: before the NCCL rank")
    (b,) = launch.spawn(ddp_train_rank, 1, ("ddp_nccl", cfg_dict, last,
                                            "cuda"), backend="nccl",
                        timeout_s=DDP_RANK_TIMEOUT_S)
    free_card("ddp: before the gloo ranks")
    c = launch.spawn(ddp_train_rank, DDP_WORLD, ("ddp_gloo", cfg_dict, last,
                                                 "cuda:0"), backend="gloo",
                     timeout_s=DDP_RANK_TIMEOUT_S)
    for label, ranks in (("(b) NCCL world 1", [b]),
                         ("(c) gloo world 2", c)):
        for r, v in enumerate(ranks):
            say(f"ddp {label} rank {r}: losses {v['losses'].tolist()}, step "
                f"walls {[round(x * 1e3, 2) for x in v['seconds']]} ms "
                f"(the last timed with its all-reduces), launches "
                f"{v['entries']}; process start to torch ready "
                f"{v['ready_s']:.1f} s, to trained {v['trained_s']:.1f} s; "
                f"timed step {v['step_ms']:.2f} ms, its "
                f"{v['allreduce_calls']} all-reduces "
                f"{v['allreduce_ms']:.2f} ms "
                f"({v['allreduce_ms'] / v['step_ms']:.3f} of the step), a "
                f"{v['buffer_mb']:.1f} MB "
                f"all-reduce alone {v['allreduce_alone_ms']:.2f} ms, peak "
                f"{v['peak_bytes'] / 2 ** 30:.2f} GiB ({smi})")
            require(v["entries"] == want,
                    f"ddp {label} rank {r}: 1 + 1 LSTM-BF and 21 + 21 "
                    f"TCM-chain launches per step")
    # (b) equals (a) bit for bit: losses and every parameter
    cfg = ExperimentConfig.from_dict(cfg_dict)

    def final_params(name):
        state = load_checkpoint(os.path.join(TRAIN_DIR, name, "ckpt",
                                             f"{last}.ckpt"),
                                create_train_state(cfg, "cuda"), cfg)[0]
        return {k: p.detach().cpu().numpy()
                for k, p in state.model.named_parameters()}

    pa, pb = final_params("ddp_a"), final_params("ddp_nccl")
    same_b = (b["losses"].tobytes() == a.tobytes()
              and all(pa[k].tobytes() == pb[k].tobytes() for k in pa))
    require(same_b, "ddp (b): NCCL at world 1 equals one process bit for "
            f"bit (losses and every parameter after step {DDP_STEPS})")
    require(c[0]["digests"] == c[1]["digests"]
            and len(c[0]["digests"]) == DDP_STEPS,
            "ddp (c): the two ranks hold the same parameters bit for bit "
            "after every step")
    rel = np.abs(c[0]["losses"] - a) / np.abs(a)
    ga, gc = rec_a.grads, c[0]["grads"]
    bad = [k for k in ga if not np.allclose(gc[k], ga[k], atol=DDP_GRAD_ATOL,
                                            rtol=DDP_GRAD_RTOL)]
    worst = max(ga, key=lambda k: float(np.abs(gc[k] - ga[k]).max()))
    say(f"ddp (c): losses relative to (a) per step {rel.tolist()}, limits "
        f"{tol.tolist()}; step-1 gradients outside atol {DDP_GRAD_ATOL:g} "
        f"rtol {DDP_GRAD_RTOL:g}: {bad} of {len(ga)} (largest |diff| "
        f"{float(np.abs(gc[worst] - ga[worst]).max()):.3e} in {worst})")
    require(bool((rel[0] <= TRAIN_LOSS_RTOL).all()) and not bad,
            f"ddp (c): step-1 loss within {TRAIN_LOSS_RTOL:g} and gradients "
            f"within atol {DDP_GRAD_ATOL:g}, rtol {DDP_GRAD_RTOL:g} of one "
            f"process")
    require(bool((rel[1:] <= tol[1:DDP_STEPS]).all()),
            f"ddp (c): step 2-{DDP_STEPS} losses within "
            f"{TRAIN_SPREAD_MARGIN:g} x the one-ulp spread at batch "
            f"{DDP_BATCH}")

    # the flagship's online bf16 config on two gloo ranks, 1 worker each
    d = flagship_config(online_paths, "ddp_online", num_workers=1)
    d["train"]["validate_once_before_train"] = False
    free_card("ddp: before the online ranks")
    online = launch.spawn(ddp_online_rank, DDP_WORLD,
                          (d, DDP_ONLINE_STEPS), backend="gloo",
                          timeout_s=DDP_RANK_TIMEOUT_S)
    want_online = {"lstm_bf_fwd_train_bf16": DDP_ONLINE_STEPS,
                   "lstm_bf_bwd_bf16": DDP_ONLINE_STEPS}
    for r, v in enumerate(online):
        say(f"ddp online rank {r}: losses {v['losses']}, step walls "
            f"{[round(x * 1e3, 1) for x in v['seconds']]} ms, loader waits "
            f"{[round(x * 1e3, 1) for x in v['wait']]} ms, launches "
            f"{v['entries']}, corpus on its card {v['corpus_bytes']} bytes, "
            f"peak {v['peak_bytes'] / 2 ** 30:.2f} GiB ({smi})")
        require(v["entries"] == want_online,
                f"ddp online rank {r}: 1 + 1 bf16 LSTM-BF training launches "
                f"per step")
        require(len(v["corpus_bytes"]) == 2 and min(v["corpus_bytes"]) > 0,
                f"ddp online rank {r}: its own resident corpus")
    l1 = online[0]["losses"][0][2]
    say(f"ddp online: step-1 loss {l1!r}, one process at batch "
        f"{ONLINE_BATCH} {online_step1!r} (relative "
        f"{abs(l1 - online_step1) / abs(online_step1):.3e})")
    require(abs(l1 - online_step1) <= DDP_ONLINE_RTOL * abs(online_step1)
            and online[0]["losses"] == online[1]["losses"],
            f"ddp online: step-1 loss within {DDP_ONLINE_RTOL:g} of one "
            f"process, the same on both ranks")

    serving = ddp_serving(smi)
    keep = ("seconds", "step_ms", "allreduce_ms", "allreduce_calls",
            "allreduce_alone_ms", "buffer_mb", "peak_bytes", "ready_s",
            "trained_s")
    return dict(
        a=dict(losses=a.tolist(), seconds=[h["seconds"] for h in hist_a]),
        spread=spreads.max(axis=0).tolist(), rel=rel.tolist(),
        grads_outside=bad,
        nccl=[{k: b[k] for k in keep}],
        gloo=[{k: v[k] for k in keep} for v in c],
        online=[{k: v[k] for k in ("losses", "seconds", "wait",
                                   "corpus_bytes", "peak_bytes")}
                for v in online],
        serving=serving,
        entries={"ddp_a": a_entries, "ddp_nccl": b["entries"],
                 **{f"ddp_gloo_rank{r}": v["entries"]
                    for r, v in enumerate(c)},
                 **{f"ddp_online_rank{r}": v["entries"]
                    for r, v in enumerate(online)},
                 **{f"ddp_serve {k}": v["entries"]
                    for k, v in serving.items()}})


# ------------------------------------------------------------------- freq
FREQ_ATOL = 2e-5  # tests/test_inference_mesh.py:103
FREQ_RANK_TIMEOUT_S = 300
# (experiment, compute dtype, stages) served on item 00000 by each world
FREQ_CASES = {2: ((EXP, "float32", ("esti", "esti0")),
                  (EXP_CLN, "float32", ("esti",)),
                  (EXP, "bfloat16", ("esti",))),
              4: ((EXP, "float32", ("esti",)),)}


def freq_rank(world: int, cases) -> dict:
    """One rank of a 1 x ``world`` ('data', 'freq') mesh on cuda:0
    (spawned, gloo): item 00000 through Enhancer(shard_freq=True) for each
    (experiment, dtype, stages): the output, the launches by C entry and
    the LSTM-BF forward's lanes in one forward (the counts zeroed just
    before it), its collectives and bytes by kind; and the host wall of
    one sharded forward of the first stage (min of 2, the card
    synchronised)."""
    import torch

    from eabnet_tpu_torch.inference import load_enhancer
    from eabnet_tpu_torch.kernels._build import load_library
    from eabnet_tpu_torch.models import eabnet as E
    from eabnet_tpu_torch.parallel import freq, make_mesh
    from eabnet_tpu_torch.utils.audio_io import read_wav

    load_library()
    lanes, lstm = [], E.double_lstm

    def recorded(xw1, *args):
        lanes.append(int(xw1.shape[1]))
        return lstm(xw1, *args)

    E.double_lstm = recorded
    mesh = make_mesh(("data", "freq"), ["cuda:0"] * world, sizes=(1, -1))
    _, noisy0 = read_wav(os.path.join(VAL, "noisy", "00000.wav"))
    out = {}
    for exp, dtype, stages in cases:
        enh = load_enhancer(exp, compute_dtype=dtype, device="cuda:0",
                            mesh=mesh, shard_freq=True)
        enh(noisy0)  # warm-up (cuDNN's choice, the allocator)
        for stage in stages:
            enh.output = stage
            torch.cuda.synchronize()
            zero_launches()
            freq.zero_counts()
            lanes.clear()
            y = enh(noisy0)
            torch.cuda.synchronize()
            out[f"{os.path.basename(exp)} {dtype} {stage}"] = dict(
                out=y, entries=read_entries(), lanes=list(lanes),
                counts={k: dict(v) for k, v in freq.counts.items()})
        enh.output, walls = stages[0], []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            enh(noisy0)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        out[f"{os.path.basename(exp)} {dtype} wall_ms"] = min(walls)
        del enh
    return out


def freq_phase(smi: str, one: dict) -> dict:
    """Frequency-axis model parallelism on the one card (PERF.md §4's freq
    cell): 2 gloo ranks on cuda:0 (NCCL refuses two ranks on one device)
    serve item 00000 through Enhancer(shard_freq=True): composed_9mic
    float32 at both stages and eabnet_9mic_cln float32 esti, each >= 40 dB
    against the JAX golden and within 2e-5 of the one-process output
    (``one``: the slice and cln phases', by experiment and stage);
    composed_9mic bf16 at R - 6 dB against one process in bf16, R its SNR
    against float32; each rank launching one LSTM-BF forward at its B·F_r
    lanes (81 and 80) and 21 TCM-chain forwards for composed_9mic, the
    ranks' outputs the same bits. Then 4 ranks for composed_9mic float32
    (41 + 40 + 40 + 40 lanes). The collectives and bytes by kind and the
    walls are printed: ranks share one card and stage every collective
    through the host, so a wall is a record, not a latency result."""
    import numpy as np
    import torch

    from eabnet_tpu_torch.inference import load_enhancer
    from eabnet_tpu_torch.parallel import launch
    from eabnet_tpu_torch.utils.audio_io import read_wav

    _, noisy0 = read_wav(os.path.join(VAL, "noisy", "00000.wav"))
    # one process in bf16 (R) and the one-process wall, before the ranks
    enh = load_enhancer(EXP, compute_dtype="bfloat16", device="cuda")
    enh(noisy0)
    one[EXP, "bfloat16", "esti"] = enh(noisy0)
    del enh
    enh = load_enhancer(EXP, device="cuda")
    enh(noisy0)
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        enh(noisy0)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    one_wall = min(walls)
    del enh
    goldens = {EXP: np.load(GOLDEN), EXP_CLN: np.load(GOLDEN_CLN)}
    res, entries = {}, {}
    for world, cases in FREQ_CASES.items():
        free_card(f"freq: before the {world} ranks")
        t0 = time.perf_counter()
        ranks = launch.spawn(freq_rank, world, (world, cases),
                             backend="gloo", timeout_s=FREQ_RANK_TIMEOUT_S)
        say(f"freq 1x{world}: {world} gloo ranks on cuda:0 in "
            f"{time.perf_counter() - t0:.1f} s")
        # B·F_r lanes at B = 1: the rank's share of 161 bins
        want_lanes = [[161 // world + (f < 161 % world)]
                      for f in range(world)]
        for exp, dtype, stages in cases:
            name = os.path.basename(exp)
            per_forward = (1, 21, 0, 0) if exp == EXP else (1, 0, 0, 0)
            want = want_entries(dict(zip(LAUNCH_KEYS, per_forward)),
                                dtype == "bfloat16")
            for stage in stages:
                label = f"{name} {dtype} {stage}"
                recs = [r[label] for r in ranks]
                y = recs[0]["out"]
                same = all(np.array_equal(r["out"], y) for r in recs[1:])
                if dtype == "float32":
                    snr = snr_db(goldens[exp][stage], y)
                    err = float(np.abs(y - one[exp, dtype, stage]).max())
                    say(f"freq 1x{world} {label}: SNR vs the JAX golden "
                        f"{snr:.2f} dB, max |sharded - one process| "
                        f"{err:.3e}")
                    require(snr >= GOLDEN_MIN_SNR_DB and err <= FREQ_ATOL,
                            f"freq 1x{world} {label}: >= "
                            f"{GOLDEN_MIN_SNR_DB:g} dB vs golden, within "
                            f"{FREQ_ATOL:g} of one process")
                    check = dict(snr=snr, err=err)
                else:
                    ref32 = one[exp, "float32", stage]
                    ref16 = one[exp, dtype, stage]
                    r = snr_db(ref32, ref16)
                    got = snr_db(ref16, y)
                    say(f"freq 1x{world} {label}: SNR vs one process in "
                        f"{dtype} {got:.2f} dB, R {r:.2f} dB (needs "
                        f"{r - LOWP_MODEL_DB:.2f})")
                    require(got >= r - LOWP_MODEL_DB,
                            f"freq 1x{world} {label}: within R - "
                            f"{LOWP_MODEL_DB:g} dB of one process")
                    check = dict(snr=got, r=r)
                require(same, f"freq 1x{world} {label}: every rank returns "
                        "the same output")
                for f, rec in enumerate(recs):
                    c = rec["counts"]
                    say(f"freq 1x{world} {label} rank {f}: launches "
                        f"{rec['entries']}, LSTM-BF lanes {rec['lanes']}; "
                        "collectives " + ", ".join(
                            f"{k} {v['calls']} ({v['bytes'] / 1e6:.3f} MB)"
                            for k, v in c.items()))
                    require(rec["entries"] == want
                            and rec["lanes"] == want_lanes[f],
                            f"freq 1x{world} {label} rank {f}: "
                            f"{want} per forward, the LSTM-BF at "
                            f"{want_lanes[f][0]} lanes")
                    entries[f"freq 1x{world} rank{f} {label}"] = \
                        rec["entries"]
                res[f"1x{world} {label}"] = dict(
                    **check, lanes=[r["lanes"] for r in recs],
                    counts=[r["counts"] for r in recs])
            walls = [r[f"{name} {dtype} wall_ms"] for r in ranks]
            say(f"freq 1x{world} {name} {dtype}: host wall of one sharded "
                f"forward per rank {['%.2f' % w for w in walls]} ms (gloo "
                f"ranks sharing one card), one process (float32) "
                f"{one_wall:.2f} ms ({smi})")
            res[f"1x{world} {name} {dtype} wall_ms"] = walls
    return dict(cases=res, one_wall_ms=one_wall, entries=entries)


# ------------------------------------------------------------------ heads
HEAD_SEED = 16
HEADS = {"cnn": {"bf_type": "cnn"}, "miso": {"topo_type": "miso"}}
HEADS_GOLDEN = "tests/golden/torch_port_heads_00000.npz"
HEADS_STREAM_FRAMES = 64
L3DAS_GOLDEN = "tests/golden/torch_port_train_l3das.npz"
L3DAS_DIR = "build/chip_smoke_l3das"
L3DAS_MICS = 4
L3DAS_STEPS = 3


def head_experiment(exp: str, head: str):
    """(config dict, params tree) of the released model ``exp`` with its
    LSTM head replaced by ``head``'s Dense ``bf_map``: the cnn head maps
    embed_dim to 2M channels, the miso one to 2; kernel (in, out) drawn
    normal from ``default_rng(HEAD_SEED)`` and scaled by 1/sqrt(embed_dim),
    bias zero. The rest of the tree is the released one."""
    import numpy as np

    from eabnet_tpu_torch.checkpoint import latest_checkpoint, load_params

    with open(os.path.join(exp, "config.json")) as f:
        d = json.load(f)
    d["model"]["eabnet"].update(HEADS[head])
    dim, m = d["model"]["eabnet"]["embed_dim"], d["model"]["eabnet"]["M"]
    out = 2 if head == "miso" else 2 * m
    rng = np.random.default_rng(HEAD_SEED)
    tree = load_params(latest_checkpoint(exp))
    tree["eabnet"]["bf_map"] = {
        "kernel": (rng.standard_normal((dim, out)) / np.sqrt(dim)
                   ).astype(np.float32),
        "bias": np.zeros(out, np.float32)}
    return d, tree


def restrict_mics(tree: dict, mics: int) -> dict:
    """A composed-model params tree cut to its first ``mics`` microphones.
    M enters the parameters in two places, both folding (mic, ri)
    mic-major as channel 2m + ri (the models reshape (..., M, 2) to 2M):
    the first encoder conv's input channels (flax HWIO kernel, axis 2;
    ``weights.py`` maps it to OIHW's axis 1) and the LSTM head's fc2
    outputs (flax Dense (in, out) kernel, axis 1, and its bias). So mics
    0..mics-1 are the first 2 * mics entries along those axes."""
    conv = tree["eabnet"]["en"]["unet_0"]["in_conv"]["conv"]
    conv["kernel"] = conv["kernel"][:, :, :2 * mics].copy()
    fc2 = tree["eabnet"]["bf_map"]["fc2"]
    fc2["kernel"] = fc2["kernel"][:, :2 * mics].copy()
    fc2["bias"] = fc2["bias"][:2 * mics].copy()
    return tree


def write_l3das_pickles(root: str, mics: int = L3DAS_MICS) -> dict:
    """release/val_set as an L3DAS23 pickle pair under ``root``:
    predictors the noisy wavs' mics 0..mics-1 as (mics, N), targets the
    clean wavs as (1, N), float32, in file order. Returns the data
    config's path keys; training and validation name the same pair."""
    import pickle

    import numpy as np

    from eabnet_tpu_torch.utils.audio_io import read_wav

    names = sorted(os.path.basename(p) for p in
                   glob.glob(os.path.join(VAL, "noisy", "*.wav")))
    preds = [read_wav(os.path.join(VAL, "noisy", n))[1][:mics]
             for n in names]
    targets = [read_wav(os.path.join(VAL, "clean", n))[1][None]
               for n in names]
    os.makedirs(root, exist_ok=True)
    paths = l3das_paths(root)
    for kind, obj in (("predictors", preds), ("target", targets)):
        with open(paths[f"training_{kind}_path"], "wb") as f:
            pickle.dump([np.asarray(a, np.float32) for a in obj], f)
    return paths


def l3das_paths(root: str) -> dict:
    """The data config's L3DAS23 path keys for the pickle pair under
    ``root`` (``write_l3das_pickles``)."""
    return {f"{split}_{kind}_path": os.path.join(root, f"val_{kind}.pkl")
            for split in ("training", "validation")
            for kind in ("predictors", "target")}


def l3das_config(paths: dict, run: str = "") -> dict:
    """composed_9mic's release config for L3DAS23 training: M = 4, the
    pickles at ``paths``, batch 7 (the 6-s items), float32, jointly at lr
    5e-4 with clip 1.0 (the train golden's settings), no validation; the
    checkpoints under ``run``."""
    with open(os.path.join(EXP, "config.json")) as f:
        d = json.load(f)
    d["model"]["eabnet"]["M"] = L3DAS_MICS
    d["model"]["freeze_eabnet"] = False
    d["data"].update(dataset="l3das23", num_workers=0, **paths)
    d["train"].update(compute_dtype="float32", lr=5e-4, grad_clip=1.0,
                      batch_size=7, log_every=1, total_epoch=1000,
                      checkpoint_dir=os.path.join(run, "ckpt") if run else "",
                      exp_root=run)
    return d


def l3das_params() -> dict:
    """The release 40000.params restricted to mics 0..3."""
    from eabnet_tpu_torch.checkpoint import load_params

    return restrict_mics(load_params(os.path.join(EXP, "40000.params")),
                         L3DAS_MICS)


def heads_serving(smi: str) -> dict:
    """(a) of the heads phase: composed_9mic with the seeded cnn and miso
    heads through the Enhancer with torch's default TF32 flags, item
    00000 at both stages against the JAX golden, 0 LSTM-BF and 21
    TCM-chain launches per float32 forward; the cnn head in bf16 and
    int8w by the lowp phase's rules."""
    import numpy as np
    import torch

    from eabnet_tpu_torch.config import ExperimentConfig
    from eabnet_tpu_torch.inference import Enhancer

    golden = np.load(HEADS_GOLDEN)
    want = dict(zip(LAUNCH_KEYS, (0, 21, 0, 0)))
    r = snr_db(golden["esti_cnn"], golden["esti_cnn_bfloat16"])
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    snrs, f32 = {}, {}

    def lowp_check(mode, label):
        def check(stage, y):
            to_ref = snr_db(golden[f"esti_cnn_{mode}"], y)
            to_f32 = snr_db(golden["esti_cnn"], y)
            say(f"{label}{stage}: vs JAX {mode} {to_ref:.2f} dB (R {r:.2f}, "
                f"needs {r - LOWP_MODEL_DB:.2f}), vs JAX float32 "
                f"{to_f32:.2f} dB")
            require(to_ref >= r - LOWP_MODEL_DB, f"{label}{stage}: >= R - "
                    f"{LOWP_MODEL_DB:g} dB vs JAX {mode}")
            if mode == "bfloat16":
                require(to_f32 >= r - LOWP_F32_DB, f"{label}{stage}: >= R "
                        f"- {LOWP_F32_DB:g} dB vs JAX float32")
            else:
                ref = f32["cnn"][stage]
                err = float(np.linalg.norm(y - ref) / np.linalg.norm(ref))
                corr = float(np.corrcoef(y, ref)[0, 1])
                say(f"{label}{stage}: vs the port's float32: relative "
                    f"error {err:.4f}, correlation {corr:.5f}")
                require(err < INT8W_MAX_ERR and corr > INT8W_MIN_CORR,
                        f"{label}{stage}: relative error < {INT8W_MAX_ERR}, "
                        f"correlation > {INT8W_MIN_CORR} vs float32")
            snrs[f"cnn {mode}"] = dict(snr=to_ref, r=r, snr_f32=to_f32)
        return check

    try:
        for head in HEADS:
            d, tree = head_experiment(EXP, head)
            cfg = ExperimentConfig.from_dict(d)
            ref = {s: golden[f"{s}_{head}"] for s in ("esti", "esti0")}
            _, entries, f32[head] = serve_item(
                Enhancer(cfg, tree, device="cuda"), ref, want,
                f"heads {head} ")
            snrs[head] = {s: snr_db(ref[s], f32[head][s]) for s in ref}
            if head != "cnn":
                continue
            heads_entries = entries
            for mode in LOWP_MODES:
                label = f"heads cnn {mode} "
                serve_item(Enhancer(cfg, tree, compute_dtype=mode,
                                    device="cuda"),
                           {"esti": ref["esti"]}, want, label,
                           lowp_check(mode, label), lowp=True,
                           stages=("esti",))
    finally:
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = flags
    torch.cuda.empty_cache()
    say(f"heads: item 00000 SNR vs the JAX golden (dB) {snrs}, on {smi}")
    return dict(entries=heads_entries, snr=snrs)


def heads_stream() -> dict:
    """(b) of the heads phase: eabnet_9mic_cln with each seeded head,
    StreamingComposed over item 00000's first HEADS_STREAM_FRAMES frames
    against the offline model on the same frames (within STREAM_TOL), no
    kernel launched, no head state, the state's bytes constant."""
    import torch

    from eabnet_tpu_torch.config import ExperimentConfig
    from eabnet_tpu_torch.dsp import prepare_data
    from eabnet_tpu_torch.models.composed import build_model
    from eabnet_tpu_torch.streaming import StreamingComposed, state_bytes
    from eabnet_tpu_torch.utils.audio_io import read_wav
    from eabnet_tpu_torch.utils.precision import float32_products
    from eabnet_tpu_torch.weights import load_jax_params

    _, noisy0 = read_wav(os.path.join(VAL, "noisy", "00000.wav"))
    wav = torch.from_numpy(noisy0[None]).cuda()
    err, all_entries, step_ms = {}, {}, {}
    for head in HEADS:
        d, tree = head_experiment(EXP_CLN, head)
        cfg = ExperimentConfig.from_dict(d)
        model = load_jax_params(build_model(cfg.model), tree).cuda().eval()
        s = StreamingComposed(model)
        with float32_products("cuda"), torch.inference_mode():
            frames = prepare_data(wav, None, cfg.stft)[0][
                :, :HEADS_STREAM_FRAMES]
            offline = model(frames)
            zero_launches()
            state = s.init_state(1)
            outs, sizes = [], []
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            for t in range(frames.shape[1]):
                state, out = s.step(state, frames[:, t])
                outs.append(out)
                if t == 7:
                    sizes.append(state_bytes(state))
            torch.cuda.synchronize()
            step_ms[head] = (time.perf_counter() - t1) * 1e3 / len(outs)
            sizes.append(state_bytes(state))
            launches, entries = read_launches(), read_entries()
        all_entries.update(entries)
        require(not any(launches.values()) and not entries,
                f"heads stream {head}: no kernel of the port on the frame "
                f"step ({launches})")
        require(not any("bf_map" in k for k in state),
                f"heads stream {head}: the state holds no head leaves")
        for k in ("esti0", "esti"):
            got = torch.stack([o[k] for o in outs], dim=1)
            err[f"{head} {k}"] = (got - offline[k]).abs().max().item()
        say(f"heads stream {head}: {len(outs)} frames, max|stream - "
            f"offline| esti0 {err[f'{head} esti0']:.3e}, esti "
            f"{err[f'{head} esti']:.3e} (tolerance {STREAM_TOL:g}); state "
            f"{sizes[0]} bytes after 8 frames, {sizes[-1]} after "
            f"{len(outs)}; {step_ms[head]:.2f} ms per frame")
        require(max(err[f"{head} esti0"], err[f"{head} esti"]) <= STREAM_TOL
                and sizes[0] == sizes[-1], f"heads stream {head}: within "
                f"{STREAM_TOL:g} of offline, state bytes constant")
        del model, s
    return dict(entries=all_entries, err=err, step_ms=step_ms)


def heads_l3das(smi: str) -> dict:
    """(c) of the heads phase: train() on the card from 40000.params cut
    to mics 0-3, on release/val_set written as L3DAS23 pickles (M = 4,
    batch 7, float32): launches per step, the step-1 loss against the JAX
    golden, steps 2-3 beside JAX's, step wall, loader wait, items/s."""
    import shutil

    import numpy as np

    from eabnet_tpu_torch.checkpoint import msgpack_serialize
    from eabnet_tpu_torch.config import ExperimentConfig
    from eabnet_tpu_torch.train.trainer import train

    shutil.rmtree(L3DAS_DIR, ignore_errors=True)
    paths = write_l3das_pickles(L3DAS_DIR)
    golden = np.load(L3DAS_GOLDEN)
    require(json.loads(str(golden["config"])) == l3das_config(paths),
            "l3das: the run's config is the golden's")
    run = os.path.join(L3DAS_DIR, "run")
    os.makedirs(os.path.join(run, "ckpt"))
    with open(os.path.join(run, "ckpt", "40000.params"), "wb") as f:
        f.write(msgpack_serialize({"params": l3das_params()}))
    zero_launches()
    hist = train(ExperimentConfig.from_dict(l3das_config(paths, run)),
                 max_steps=40000 + L3DAS_STEPS, device="cuda",
                 tensorboard=False)
    launches, entries = read_launches(), read_entries()
    n = L3DAS_STEPS
    want = dict(zip(LAUNCH_KEYS, (n, 21 * n, n, 21 * n)))
    say(f"l3das: launches over {n} steps: {launches}, by C entry {entries}")
    require(launches == want and entries == want_entries(want, False, True),
            "l3das: 1 + 1 LSTM-BF (L = 7 x 161 = 1,127) and 21 + 21 "
            "TCM-chain (B = 7) launches per step, all of the float32 "
            "training kernels")
    losses = np.array([[h[k] for k in LOSS_KEYS] for h in hist])
    ref = golden["losses"]
    rel = np.abs(losses - ref) / np.abs(ref)
    for i in range(n):
        say(f"l3das step {i + 1}: port {losses[i].tolist()}, JAX "
            f"{ref[i].tolist()}, relative {rel[i].tolist()}")
    require(bool(np.isfinite(losses).all()) and rel[0].max() <= TRAIN_LOSS_RTOL,
            f"l3das: step-1 losses within {TRAIN_LOSS_RTOL:g} relative of "
            "the JAX golden")
    step_s = min(h["seconds"] for h in hist[1:])
    wait = [h["wait"] for h in hist]
    say(f"l3das: step wall {step_s * 1e3:.2f} ms (min of steps 2-{n}: "
        f"{[round(h['seconds'] * 1e3, 2) for h in hist[1:]]}; step 1 "
        f"{hist[0]['seconds'] * 1e3:.2f} ms), loader wait "
        f"{[round(w * 1e3, 2) for w in wait]} ms, {7 / step_s:.2f} items/s "
        f"at batch 7, M = {L3DAS_MICS}, on {smi}")
    return dict(entries=entries, losses=losses.tolist(),
                rel=rel.tolist(), step_s=step_s, wait=wait,
                items_s=7 / step_s)


def heads_phase(smi: str) -> dict:
    """The heads phase (module doc, 9a): serving, streaming and L3DAS23
    training with the cnn and miso heads."""
    t_phase = time.perf_counter()
    served = heads_serving(smi)
    t_serve = time.perf_counter() - t_phase
    streamed = heads_stream()
    t_stream = time.perf_counter() - t_phase - t_serve
    trained = heads_l3das(smi)
    walls = dict(serve=t_serve, stream=t_stream,
                 l3das=time.perf_counter() - t_phase - t_serve - t_stream)
    say(f"heads: phase {sum(walls.values()):.1f} s ({walls})")
    return dict(served=served, streamed=streamed, trained=trained,
                walls=walls)


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
    from eabnet_tpu_torch.models.composed import build_model
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
            "lstm_8": lstm_case(bf_map, 8 * 161, t, seed=7),
            "lstm_16": lstm_case(bf_map, 16 * 161, t, seed=8),
            # one item's lanes on each of 2 and 4 freq ranks (freq phase)
            "lstm_81": lstm_case(bf_map, 81, t, seed=25),
            "lstm_41": lstm_case(bf_map, 41, t, seed=26),
            "twin_1": tcm_case(twin_group, 1, t, seed=3),
            "twin_7": tcm_case(twin_group, 7, t, seed=4),
            "single_1": tcm_case(single_group, 1, t, seed=5),
            "single_7": tcm_case(single_group, 7, t, seed=6),
            # the batches the released configs (8) and recipes (16) take
            "twin_8": tcm_case(twin_group, 8, t, seed=9),
            "twin_16": tcm_case(twin_group, 16, t, seed=10),
            "single_8": tcm_case(single_group, 8, t, seed=19),
            "single_16": tcm_case(single_group, 16, t, seed=20),
        }
        del model
        bad = [k for k, v in res.items() if not v["err"] <= KERNEL_ATOL]
        require(not bad, f"every kernel within {KERNEL_ATOL:g} of its plain "
                f"version (outside: {bad})")
        lstm_keys = ("lstm_1", "lstm_7", "lstm_8", "lstm_16")
        serve_keys = lstm_keys + ("lstm_81", "lstm_41")
        require(all(res[k]["same"] for k in serve_keys),
                "lstm_bf: a second launch gives the same bits at every shape")
        tcm_keys = [k for k in res if k.startswith(("twin", "single"))]
        require(all(res[k]["same"] for k in tcm_keys),
                "tcm_chain: a second launch gives the same bits at every "
                "shape")
        g7, g16 = res["lstm_7"]["geometry"], res["lstm_16"]["geometry"]
        require(g7["blocks"] >= 120 * g7["sms"] // 132 and g16["waves"] == 1,
                f"lstm_bf: L=1,127 runs on {g7['blocks']} of {g7['sms']} SMs "
                f"(at least 120 of 132), L=2,576 in {g16['waves']} wave(s) "
                f"(one)")

    # serving runs with torch's default flags (cuDNN's TF32 on, matmul's
    # off), as a user's process has them: the Enhancer must turn TF32 off
    # for its own convolutions and leave the flags as it found them
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    default_flags = (torch.backends.cudnn.allow_tf32,
                     torch.backends.cuda.matmul.allow_tf32)
    with Phase("slice"):
        enh = load_enhancer(EXP, device="cuda")
        _, main_entries, main_out = serve_item(
            enh, GOLDEN, dict(zip(LAUNCH_KEYS, (1, 21, 0, 0))))
        served = serve_batch(enh, smi)
        require((torch.backends.cudnn.allow_tf32,
                 torch.backends.cuda.matmul.allow_tf32) == default_flags,
                "the Enhancer left torch's TF32 flags as it found them")

    with Phase("profile"):
        served["profile"] = profile_run(
            lambda: enh.enhance_batch(served["noisy"]))
    del enh

    with Phase("cln"):
        # the second shipped model, cLN in both nets, through the same
        # entry point and with torch's default flags: its TCN groups take
        # the per-TCM route (the TCM-chain kernel is causal IN only)
        t_phase = time.perf_counter()
        enh = load_enhancer(EXP_CLN, device="cuda")
        _, cln_entries, cln_out = serve_item(
            enh, GOLDEN_CLN, dict(zip(LAUNCH_KEYS, (1, 0, 0, 0))), "cln ")
        cln = serve_batch(enh, smi, "cln ")
        say(f"cln: mean SI-SDR gain {cln['gain']:+.3f} dB over the "
            f"{len(cln['noisy'])} val items, composed_9mic "
            f"{served['gain']:+.3f} dB in the slice phase of this run")
        cln["profile"] = profile_run(lambda: enh.enhance_batch(cln["noisy"]))
        require((torch.backends.cudnn.allow_tf32,
                 torch.backends.cuda.matmul.allow_tf32) == default_flags,
                "cln: the Enhancer left torch's TF32 flags as it found them")
        say(f"cln: phase {time.perf_counter() - t_phase:.1f} s")
    torch.backends.cudnn.allow_tf32 = False

    with Phase("stream"):
        t_phase = time.perf_counter()
        streamed = stream_phase(enh, smi)
        say(f"stream: phase {time.perf_counter() - t_phase:.1f} s")
    del enh

    with Phase("lowp"):
        # bfloat16 and int8w serving: the bf16 kernels against their plain
        # versions, then both models through load_enhancer
        t_phase = time.perf_counter()
        cfg = ExperimentConfig.load(os.path.join(EXP, "config.json"))
        model = load_jax_params(build_model(cfg.model),
                                load_params(latest_checkpoint(EXP))).cuda()
        t = 701
        low = {
            "lstm_1": lstm_lowp_case(model.eabnet.bf_map, 161, t, seed=31),
            "lstm_7": lstm_lowp_case(model.eabnet.bf_map, 7 * 161, t, 32),
            "twin_1": tcm_lowp_case(model.eabnet.stcn_0, 1, t, seed=33),
            "twin_7": tcm_lowp_case(model.eabnet.stcn_0, 7, t, seed=34),
            "single_1": tcm_lowp_case(model.postnet.gag_0.glance.tcn_0, 1, t,
                                      seed=35),
            "single_7": tcm_lowp_case(model.postnet.gag_0.glance.tcn_0, 7, t,
                                      seed=36),
        }
        del model
        bad = [k for k, v in low.items() if not v["ok"]]
        require(not bad, f"every bf16 kernel within R + {LOWP_KERNEL_DB:g} "
                "dB of its plain version (the TCM chain: each TCM; the "
                f"whole chain at min(R + {LOWP_KERNEL_DB:g}, D - "
                f"{LOWP_SPREAD_DB:g})) (outside: {bad})")
        require(all(v["same"] for v in low.values()),
                "bf16 kernels: a second launch gives the same bits")
        f32_runs = {EXP: (main_out, served), EXP_CLN: (cln_out, cln)}
        lowp = {}
        for exp, golden, want in LOWP_MODELS:
            for mode in LOWP_MODES:
                lowp[f"{os.path.basename(exp)} {mode}"] = lowp_serving(
                    exp, golden, want, mode, *f32_runs[exp], smi)
        say(f"lowp: phase {time.perf_counter() - t_phase:.1f} s")

    with Phase("eval"):
        evaluated = eval_phase(smi)

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
            # the batches of the released configs (8) and recipes (16):
            # more lanes than 9 per SM, so the walk takes two and three
            # waves
            "lstm_8": lstm_bwd_case(model.eabnet.bf_map, 8 * 161, t, 17),
            "lstm_16": lstm_bwd_case(model.eabnet.bf_map, 16 * 161, t, 18),
            "twin_7": tcm_bwd_case(model.eabnet.stcn_0, 7, t, 13),
            "twin_1": tcm_bwd_case(model.eabnet.stcn_0, 1, t, 14),
            "single_7": tcm_bwd_case(
                model.postnet.gag_0.glance.tcn_0, 7, t, 15),
            "single_1": tcm_bwd_case(
                model.postnet.gag_0.glance.tcn_0, 1, t, 16),
            "twin_8": tcm_bwd_case(model.eabnet.stcn_0, 8, t, 21),
            "twin_16": tcm_bwd_case(model.eabnet.stcn_0, 16, t, 22),
            "single_8": tcm_bwd_case(
                model.postnet.gag_0.glance.tcn_0, 8, t, 23),
            "single_16": tcm_bwd_case(
                model.postnet.gag_0.glance.tcn_0, 16, t, 24),
        }
        del model
        bad = [k for k, v in bwd.items() if not v["ok"]]
        require(not bad, "every backward kernel within the JAX "
                f"gradient tests' tolerances of its plain version, and the "
                f"TCM chain's the same bits on a second launch (outside: "
                f"{bad})")

    with Phase("train"):
        # part 2: the trainer on the card, the slice's main path
        trained = train_phase()

    with Phase("lowp_train"):
        # bf16 training's kernels alone at the training shapes: the LSTM-BF
        # training forward and backward, the TCM-chain backward
        cfg = ExperimentConfig.load(os.path.join(EXP, "config.json"))
        model = load_jax_params(build_model(cfg.model),
                                load_params(latest_checkpoint(EXP))).cuda()
        t = TRAIN_T
        bf_map, twin_group = model.eabnet.bf_map, model.eabnet.stcn_0
        single_group = model.postnet.gag_0.glance.tcn_0
        lbw = {
            "lstm_7": lstm_train_lowp_case(bf_map, 7 * 161, t, 41),
            "lstm_1": lstm_train_lowp_case(bf_map, 161, t, 42),
            "lstm_8": lstm_train_lowp_case(bf_map, 8 * 161, t, 43),
            "lstm_16": lstm_train_lowp_case(bf_map, 16 * 161, t, 44),
        }
        for key, group, b, seed in (
                ("twin_7", twin_group, 7, 45), ("twin_1", twin_group, 1, 46),
                ("twin_8", twin_group, 8, 47), ("twin_16", twin_group, 16, 48),
                ("single_7", single_group, 7, 49),
                ("single_1", single_group, 1, 50),
                ("single_8", single_group, 8, 51),
                ("single_16", single_group, 16, 52)):
            lbw[key] = tcm_bwd_lowp_case(group, b, t, seed)
        del model
        bad = [k for k, v in lbw.items() if not v["ok"]]
        require(not bad, "every bf16 training kernel against its plain bf16 "
                f"version: the LSTM-BF forward's sequences, the TCM-chain "
                f"backward's recomputed trunk and each TCM's cotangent at R "
                f"+ {LOWP_KERNEL_DB:g} dB, every other backward output (each "
                f"TCM's weight gradients; the whole chain's at D - "
                f"{LOWP_CHAIN_BWD_SPREAD_DB:g}) at min(R + "
                f"{LOWP_KERNEL_DB:g}, D - {LOWP_SPREAD_DB:g}) with D from "
                f"plain probes alone, each TCM's dwo summed once "
                f"({LOWP_SUM_DB:g} dB), the same bits on a second launch "
                f"(outside: {bad})")

    with Phase("train_bf16"):
        trained16 = train_bf16_phase(
            json.loads(str(np.load(TRAIN_GOLDEN)["config"])),
            trained["losses"])

    with Phase("heads"):
        heads = heads_phase(smi)

    with Phase("online"):
        t_phase = time.perf_counter()
        online = online_phase(smi)
        say(f"online: phase {time.perf_counter() - t_phase:.1f} s")

    with Phase("ddp"):
        t_phase = time.perf_counter()
        ddp = ddp_phase(smi, online["paths"], online["flagship_step1"])
        say(f"ddp: phase {time.perf_counter() - t_phase:.1f} s")

    with Phase("freq"):
        t_phase = time.perf_counter()
        sharded = freq_phase(smi, {
            (EXP, "float32", stage): main_out[stage]
            for stage in ("esti", "esti0")} | {
            (EXP_CLN, "float32", "esti"): cln_out["esti"]})
        say(f"freq: phase {time.perf_counter() - t_phase:.1f} s")

    def per_forward(twin, single):
        """Both variants as one forward runs them: 3 twin + 18 single."""
        return {k: 3 * res[twin][k] + 18 * res[single][k]
                for k in ("ms", "plain_ms", "bound_ms", "tc_bound_ms")}

    # the LSTM-BF forward at every shape: serving (T=701) and the training
    # variant (T=601), kernel and nn.LSTM (with grad on for training)
    fwd_shapes = {}
    for use, rows, ms_key, lib_key, plain_key, geo_key in (
            ("serve", [res[k] for k in serve_keys], "ms", "library_ms",
             "plain_ms", "geometry"),
            ("train", [bwd[k] for k in lstm_keys], "fwd_ms",
             "library_fwd_ms", "plain_fwd_ms", "fwd_geometry")):
        for r in rows:
            g = r[geo_key]
            fwd_shapes[f"{use} T={g['t']} L={g['lanes']}"] = dict(
                ms=r[ms_key], library_ms=r[lib_key], plain_ms=r[plain_key],
                **g)
    def tcm_shapes(cases, t):
        """Every TCM-chain case of a phase: its numbers and launch."""
        return {f"{k.split('_')[0]} T={t} B={k.split('_')[1]}": {
            f: v[f] for f in ("ms", "plain_ms", "bound_ms", "tc_bound_ms",
                              "geometry", "split_ms") if f in v}
            for k, v in cases.items() if k.startswith(("twin", "single"))}

    tcm = per_forward("twin_1", "single_1")
    tcm_step = {k: 3 * bwd["twin_7"][k] + 18 * bwd["single_7"][k]
                for k in ("ms", "plain_ms", "bound_ms", "tc_bound_ms")}
    record = {"kernels": [
        {"name": "lstm_bf_fwd", "route": "cuda",
         "source": "eabnet_tpu_torch/csrc/lstm_bf.cu",
         "replaces": "eabnet_tpu/kernels/lstm_bf.py:57",
         "max_abs_err": max([res[k]["err"] for k in serve_keys]
                            + [bwd[k]["fwd_err"] for k in lstm_keys]),
         "ms": res["lstm_1"]["ms"], "plain_ms": res["lstm_1"]["plain_ms"],
         "bound_ms": res["lstm_1"]["bound_ms"],
         "bound_by": res["lstm_1"]["bound_by"],
         "library_ms": res["lstm_1"]["library_ms"],
         "shapes": fwd_shapes},
        {"name": "tcm_chain_fwd", "route": "cuda",
         "source": "eabnet_tpu_torch/csrc/tcm_chain.cu",
         "replaces": "eabnet_tpu/kernels/tcm_chain.py:175",
         "max_abs_err": max(res[k]["err"] for k in tcm_keys),
         "ms": tcm["ms"], "plain_ms": tcm["plain_ms"],
         "bound_ms": tcm["bound_ms"],
         "bound_by": res["twin_1"]["bound_by"],
         "library_ms": None, "tc_bound_ms": tcm["tc_bound_ms"],
         "shapes": tcm_shapes(res, 701)},
        {"name": "lstm_bf_bwd", "route": "cuda",
         "source": "eabnet_tpu_torch/csrc/lstm_bf.cu",
         "replaces": "eabnet_tpu/kernels/lstm_bf.py:107",
         "max_abs_err": max(bwd[k]["err"] for k in
                            ("lstm_1", "lstm_7", "lstm_8", "lstm_16")),
         "ms": bwd["lstm_7"]["ms"], "plain_ms": bwd["lstm_7"]["plain_ms"],
         "bound_ms": bwd["lstm_7"]["bound_ms"],
         "bound_by": bwd["lstm_7"]["bound_by"],
         "library_ms": bwd["lstm_7"]["library_ms"],
         "split_ms": bwd["lstm_7"]["split_ms"],
         "tc_bound_ms": bwd["lstm_7"]["tc_bound_ms"]},
        {"name": "tcm_chain_bwd", "route": "cuda",
         "source": "eabnet_tpu_torch/csrc/tcm_chain.cu",
         "replaces": "eabnet_tpu/kernels/tcm_chain.py:187",
         "max_abs_err": max(bwd[k]["err"] for k in tcm_keys),
         "ms": tcm_step["ms"], "plain_ms": tcm_step["plain_ms"],
         "bound_ms": tcm_step["bound_ms"],
         "bound_by": bwd["twin_7"]["bound_by"],
         "library_ms": None, "tc_bound_ms": tcm_step["tc_bound_ms"],
         "split_ms": {part: 3 * bwd["twin_7"]["split_ms"][part]
                      + 18 * bwd["single_7"]["split_ms"][part]
                      for part in ("walk", "wgrad", "sum")}
         if bwd["twin_7"]["split_ms"] and bwd["single_7"]["split_ms"]
         else None, "shapes": tcm_shapes(bwd, TRAIN_T)},
    ]}
    # the bf16 serving variants: launches of one bf16 forward of each
    # model (int8w runs the same bf16 kernels), times per forward of one
    # item as above
    low_lstm = ("lstm_1", "lstm_7")
    low_tcm = ("twin_1", "twin_7", "single_1", "single_7")
    low_fwd = {k: 3 * low["twin_1"][k] + 18 * low["single_1"][k]
               for k in ("ms", "plain_ms", "bound_ms", "f32_bound_ms")}
    for name, keys, row in (
            ("lstm_bf_fwd_bf16", low_lstm, dict(
                replaces="eabnet_tpu/kernels/lstm_bf.py:57",
                source="eabnet_tpu_torch/csrc/lstm_bf.cu",
                ms=low["lstm_1"]["ms"], plain_ms=low["lstm_1"]["plain_ms"],
                bound_ms=low["lstm_1"]["bound_ms"],
                bound_by=low["lstm_1"]["bound_by"],
                library_ms=low["lstm_1"]["library_ms"],
                f32_bound_ms=low["lstm_1"]["f32_bound_ms"])),
            ("tcm_chain_fwd_bf16", low_tcm, dict(
                replaces="eabnet_tpu/kernels/tcm_chain.py:175",
                source="eabnet_tpu_torch/csrc/tcm_chain.cu",
                ms=low_fwd["ms"], plain_ms=low_fwd["plain_ms"],
                bound_ms=low_fwd["bound_ms"],
                bound_by=low["twin_1"]["bound_by"], library_ms=None,
                f32_bound_ms=low_fwd["f32_bound_ms"]))):
        record["kernels"].append(dict(
            name=name, route="cuda",
            max_abs_err=max(low[k]["err"] for k in keys), **row,
            snr_db={k: low[k]["snr"] for k in keys},
            need_db={k: low[k]["need"] for k in keys},
            shapes={k: {f: low[k][f] for f in (
                "ms", "plain_ms", "bound_ms", "f32_bound_ms", "library_ms",
                "geometry") if f in low[k]} for k in keys}))
    # bf16 training: per train step of 7 items (T = 601), L = 1,127 and
    # 3 EaBNet + 18 GaGNet TCM groups at B = 7, as the f32 backward rows
    lt = ("lstm_1", "lstm_7", "lstm_8", "lstm_16")
    tt = [k for k in lbw if k.startswith(("twin", "single"))]
    step16 = {k: 3 * lbw["twin_7"][k] + 18 * lbw["single_7"][k]
              for k in ("ms", "plain_ms", "bound_ms", "f32_bound_ms")}
    lstm_names = ("h1", "c1", "h2", "c2")
    grad_names = ("dxw1", "dw_hh1", "dw_ih2", "dw_hh2", "db2")
    record["kernels"] += [
        dict(name="lstm_bf_fwd_train_bf16", route="cuda",
             source="eabnet_tpu_torch/csrc/lstm_bf.cu",
             replaces="eabnet_tpu/kernels/lstm_bf.py:57",
             max_abs_err=max(lbw[k]["fwd_err"] for k in lt),
             ms=lbw["lstm_7"]["fwd_ms"], plain_ms=lbw["lstm_7"]["plain_fwd_ms"],
             bound_ms=lbw["lstm_7"]["fwd_bound_ms"],
             bound_by=lbw["lstm_7"]["fwd_bound_by"],
             f32_bound_ms=lbw["lstm_7"]["fwd_f32_bound_ms"],
             library_ms=lbw["lstm_7"]["library_fwd_ms"],
             snr_db={k: dict(zip(lstm_names, (r["snr"] for r in lbw[k]["fwd"])))
                     for k in lt},
             need_db={k: dict(zip(lstm_names, (r["need"] for r in lbw[k]["fwd"])))
                      for k in lt},
             shapes={k: {f: lbw[k][f] for f in (
                 "fwd_ms", "plain_fwd_ms", "fwd_bound_ms", "fwd_f32_bound_ms",
                 "library_fwd_ms")} for k in lt}),
        dict(name="lstm_bf_bwd_bf16", route="cuda",
             source="eabnet_tpu_torch/csrc/lstm_bf.cu",
             replaces="eabnet_tpu/kernels/lstm_bf.py:107",
             max_abs_err=max(max(r["err"] for r in lbw[k]["bwd"]) for k in lt),
             ms=lbw["lstm_7"]["ms"], plain_ms=lbw["lstm_7"]["plain_ms"],
             bound_ms=lbw["lstm_7"]["bound_ms"],
             bound_by=lbw["lstm_7"]["bound_by"],
             f32_bound_ms=lbw["lstm_7"]["f32_bound_ms"],
             library_ms=lbw["lstm_7"]["library_ms"],
             split_ms=lbw["lstm_7"]["split_ms"],
             snr_db={k: dict(zip(grad_names, (r["snr"] for r in lbw[k]["bwd"])))
                     for k in lt},
             need_db={k: dict(zip(grad_names, (r["need"] for r in lbw[k]["bwd"])))
                      for k in lt},
             shapes={k: {f: lbw[k][f] for f in (
                 "ms", "plain_ms", "bound_ms", "f32_bound_ms", "library_ms",
                 "split_ms")} for k in lt}),
        dict(name="tcm_chain_bwd_bf16", route="cuda",
             source="eabnet_tpu_torch/csrc/tcm_chain.cu",
             replaces="eabnet_tpu/kernels/tcm_chain.py:187",
             max_abs_err=max(lbw[k]["err"] for k in tt),
             ms=step16["ms"], plain_ms=step16["plain_ms"],
             bound_ms=step16["bound_ms"],
             bound_by=lbw["twin_7"]["bound_by"],
             f32_bound_ms=step16["f32_bound_ms"], library_ms=None,
             split_ms={part: 3 * lbw["twin_7"]["split_ms"][part]
                       + 18 * lbw["single_7"]["split_ms"][part]
                       for part in ("walk", "wgrad", "sum")}
             if lbw["twin_7"]["split_ms"] and lbw["single_7"]["split_ms"]
             else None,
             snr_db={k: dict(lbw[k]["snr"], each_dx_margin=lbw[k][
                 "each_margins"], each_wgrad_margin=lbw[k][
                 "each_wgrad_margins"], trunk_margin=lbw[k][
                 "trunk_margins"]) for k in tt},
             need_db={k: lbw[k]["need"] for k in tt},
             shapes={k: {f: lbw[k][f] for f in (
                 "ms", "plain_ms", "bound_ms", "f32_bound_ms", "split_ms",
                 "geometry")} for k in tt}),
    ]
    record["train_bf16"] = {f: trained16[f] for f in (
        "step_s", "items_s", "rule", "peak_bytes", "cln_step_s")}
    record["train_bf16"]["f32_step_s"] = trained["step_s"]
    record["eval"] = {f: evaluated[f] for f in (
        "wall", "enhance_s", "score_s", "cli_s", "workers", "n_scored",
        "items_per_s", "lowp")}
    record["online"] = {f: online[f] for f in (
        "modes", "host_items_s", "native_err", "checks")}
    record["ddp"] = {k: v for k, v in ddp.items() if k != "entries"}
    record["freq"] = {k: v for k, v in sharded.items() if k != "entries"}
    record["heads"] = dict(
        walls=heads["walls"], snr=heads["served"]["snr"],
        stream_err=heads["streamed"]["err"],
        stream_ms=heads["streamed"]["step_ms"],
        **{f"l3das_{k}": v for k, v in heads["trained"].items()
           if k != "entries"})
    record["lowp"] = {p: {f: v[f] for f in (
        "gain", "gain_f32", "wall", "rtf", "peak_bytes", "param_bytes",
        "idle", "item")} for p, v in lowp.items()}
    # each path's launches by C entry, every counter zeroed just before
    # that path's run and read just after it: one forward of composed_9mic
    # (slice) and of eabnet_9mic_cln (cln), every frame of the cLN stream,
    # the float32 train steps, one forward of each model in each
    # low-precision mode, the bf16 train steps of both models
    paths = {"slice": main_entries, "cln": cln_entries,
             "stream": streamed["entries"], "train": trained["entries"],
             **{p: v["entries"] for p, v in lowp.items()},
             "eval": evaluated["entries"],
             "eval lowp": evaluated["lowp_entries"],
             "train_bf16": trained16["entries"],
             "train_bf16_cln": trained16["cln_entries"],
             "online": online["entries"], **ddp["entries"],
             **sharded["entries"],
             "heads": heads["served"]["entries"],
             "heads_stream": heads["streamed"]["entries"],
             "l3das": heads["trained"]["entries"]}
    for k in record["kernels"]:
        entries, main_path = ROW_ENTRIES[k["name"]]
        k["launches_by_path"] = {p: sum(e.get(n, 0) for n in entries)
                                 for p, e in paths.items()}
        k["launches"] = k["launches_by_path"][main_path]
        require(k["launches"] > 0, f"{k['name']}: launched on its path "
                f"({main_path})")
    say("kernel times above are per forward of one 6-s item (B=1, T=701): "
        "lstm_bf one launch at L=161, tcm_chain 3 EaBNet + 18 GaGNet "
        "group launches; the backward ones per train step of 7 items (T="
        f"{TRAIN_T}): lstm_bf one launch at L=1,127, tcm_chain 3 + 18 group "
        f"launches at B=7; launches: one enhancement forward for the "
        f"serving rows, the {TRAIN_STEPS} train steps for the training "
        "rows (launches_by_path: every path, by C entry)")
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
