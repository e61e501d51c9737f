"""Long-horizon training drive of the port: thousands of steps on the card
with metric curves, exercising checkpoint-resume continuously, as the
repo's ``tools/long_train.py`` drives the JAX package.

It stages a formant-synth corpus, renders an offline train set + frozen
val set, then trains in chunks: every chunk boundary saves a checkpoint,
RE-ENTERS training through the auto-resume path (so resume is exercised
at every chunk, not once), scores both model stages (esti0 = bare EaBNet,
esti = composed GaGNet output) on the frozen val set, and appends one JSON
line per stage to ``curves.jsonl``, key for key the JAX tool's rows, so
``tools/curves_report.py`` and ``tools/plot_curves.py`` read a port run.
The checkpoints are the JAX package's format: one run may switch packages
at a chunk boundary.

Two-phase composed recipe (reference: EaBNet.py:150-155 freeze_eabnet,
train_distributed.py:221-230): pass ``--freeze-after N`` to freeze the
beamformer once step N is reached and train only the post-filter after.
``--steps-per-process N`` exits with code 75 after N steps; an outer loop
starts a fresh process that resumes at the newest checkpoint (README).

    python -m eabnet_tpu_torch.tools.long_train --workdir longrun \\
        --max-steps 30000 --chunk 1000

Every flag and default is the JAX tool's, except ``--workdir`` (default
``longrun`` in the working directory) and ``--platform`` (``default`` is
the card, ``cpu`` the CPU). ``--bf-impl`` is written into the config and
not acted on: the tensor's device picks the kernel. ``--tiny`` is the
reduced model of wiring dry runs (TCN widths 16 and 12, which the
TCM-chain kernels take zero-padded to their 64).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import sys
import time

# What the last ``main`` call did, also when it ended by recycling (exit
# 75): ``staged_s``, the staging seconds; ``chunks``, one record per chunk
# trained ({"step", "frozen", "seconds", "it_per_sec", "score_s",
# "losses"}: ``losses`` holds the chunk's steps' {"eabnet", "postnet",
# "final"} losses, each before its step's update).
RUN: dict = {"staged_s": None, "chunks": []}
EXIT_RECYCLE = 75  # EX_TEMPFAIL


def stage_data(root, n_speech, n_noise, seconds, train_items, val_items,
               workers, settings, render_train=True):
    """Corpus -> split -> offline train render (offline mode only) ->
    frozen val render. Every stage is skipped if its output already
    exists (resumable). Online mode trains straight off the corpus
    (per-item scenes synthesized on the fly), so only the frozen val set
    is rendered."""
    from eabnet_tpu_torch.tools.e2e_demo import make_corpus

    sp_dir = os.path.join(root, "speech")
    done = os.path.join(root, ".staged")
    settings_path = os.path.join(root, "settings.json")
    if os.path.exists(done):
        return settings_path
    make_corpus(root, n_speech=n_speech, n_noise=n_noise, seconds=seconds)
    no_dir = os.path.join(root, "noise")
    with open(settings_path, "w") as f:
        json.dump(settings, f)

    from eabnet_tpu_torch.cli.datagen import main as datagen_main
    from eabnet_tpu_torch.cli.split import main as split_main

    lists = os.path.join(root, "lists")
    split_main(["--speech-root", sp_dir, "--noise-root", no_dir,
                "--out-dir", lists])
    if render_train:
        datagen_main([
            "--output-dir", os.path.join(root, "train_set"),
            "--speech-root", sp_dir, "--noise-root", no_dir,
            "--speech-list", os.path.join(lists, "speechs_train"),
            "--noise-list", os.path.join(lists, "noises_train"),
            "--mcse-settings", settings_path,
            "--clip-seconds", str(seconds),
            "--workers", str(workers), "--items", str(train_items),
        ])
    datagen_main([
        "--output-dir", os.path.join(root, "val"),
        "--speech-root", sp_dir, "--noise-root", no_dir,
        "--speech-list", os.path.join(lists, "speechs_val"),
        "--noise-list", os.path.join(lists, "noises_val"),
        "--mcse-settings", settings_path, "--clip-seconds", str(seconds),
        "--workers", str(workers), "--limit", str(val_items),
    ])
    with open(done, "w") as f:
        f.write("ok\n")
    return settings_path


def score_stage(cfg, params, val, output, device="cuda"):
    """Means of the metric battery over the val set, rounded to 4 places:
    ``output`` "noisy" (the reference mic), or the Enhancer's "esti0" /
    "esti" (float32, on ``device``)."""
    from eabnet_tpu_torch.eval import evaluate_dataset
    from eabnet_tpu_torch.inference import Enhancer
    from eabnet_tpu_torch.tools.e2e_demo import METRICS, val_items

    if output == "noisy":
        acc, _ = evaluate_dataset(lambda n: n[0], val_items(val),
                                  sr=cfg.stft.sr)
    else:
        acc, _ = evaluate_dataset(
            Enhancer(cfg, params, output=output, device=device),
            val_items(val), sr=cfg.stft.sr)
    return {k: round(acc.mean_std(k)[0], 4) for k in METRICS}


def prune_checkpoints(ckpt_dir, keep_last=2, keep_every=10000):
    """Bound disk: keep the newest ``keep_last`` checkpoints plus every
    ``keep_every``-step milestone."""
    if not os.path.isdir(ckpt_dir):
        return
    ckpts = []
    for name in os.listdir(ckpt_dir):
        m = re.fullmatch(r"(\d+)\.ckpt", name)
        if m:
            ckpts.append((int(m.group(1)), os.path.join(ckpt_dir, name)))
    ckpts.sort()
    for it, path in ckpts[:-keep_last]:
        if keep_every and it % keep_every == 0:
            continue
        os.remove(path)


def parse_args(argv=None):
    from eabnet_tpu_torch.tools.e2e_demo import add_platform

    ap = argparse.ArgumentParser()
    ap.add_argument("--workdir", default="longrun")
    ap.add_argument("--max-steps", type=int, default=30000)
    ap.add_argument("--chunk", type=int, default=1000)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--dtype", default="bfloat16",
                    choices=["bfloat16", "float32"])
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--train-items", type=int, default=6000)
    ap.add_argument("--val-items", type=int, default=12)
    ap.add_argument("--corpus-speech", type=int, default=160)
    ap.add_argument("--corpus-noise", type=int, default=24)
    ap.add_argument("--seconds", type=float, default=6.0)
    ap.add_argument("--freeze-after", type=int, default=None,
                    help="freeze the EaBNet beamformer from this step on "
                    "and train only the GaGNet post-filter "
                    "(reference: EaBNet.py:150-155)")
    ap.add_argument("--steps-per-process", type=int, default=None,
                    help="exit with code 75 (EX_TEMPFAIL) after advancing "
                    "this many steps, so an outer loop starts a fresh "
                    "process that resumes from the latest checkpoint; "
                    "bounds what a process gathers over a very long run "
                    "(host memory, allocator state)")
    ap.add_argument("--lr", type=float, default=5e-4)
    ap.add_argument("--train-set", default="offline",
                    choices=["offline", "online"],
                    help="offline = pre-rendered pairs (train_wbh.sh "
                    "regime); online = per-item on-the-fly synthesis, "
                    "the reference's DEFAULT data mode "
                    "(train_zc.sh:27-41, dataset/mcse_dataset.py:52-260)")
    ap.add_argument("--device-mix", default="none",
                    choices=["none", "loader", "parts", "scene"],
                    help="online-mode synthesis offload "
                    "(DataConfig.device_mix): 'scene' ships scene "
                    "parameters only and mixes against the "
                    "device-resident corpus inside the train step")
    ap.add_argument("--bf-impl", default=None,
                    choices=["scan", "pallas"],
                    help="LSTM-BF head implementation of the JAX package, "
                    "written into the config; the port reads it and does "
                    "not act on it (on the card the LSTM-BF kernel runs)")
    ap.add_argument("--norm-type", default=None,
                    choices=["IN", "BN", "cLN"],
                    help="override the norm for BOTH nets; cLN trains the "
                    "causal-norm variant that the streaming engine can "
                    "run frame-by-frame (IN cannot stream by "
                    "construction, reference EaBNet.py:46-48)")
    ap.add_argument("--tiny", action="store_true",
                    help="reduced model (wiring dry-runs)")
    add_platform(ap)
    return ap.parse_args(argv)


def make_config(args, root: str, settings_path: str, frozen: bool):
    """The experiment of one chunk, as the JAX tool builds it."""
    from eabnet_tpu_torch.config import (ComposedConfig, DataConfig,
                                         EaBNetConfig, ExperimentConfig,
                                         GaGNetConfig, TrainConfig)

    if args.tiny:
        eab = EaBNetConfig(M=9, c=16, embed_dim=16, cd1=16, p=2, q=1)
        gag = GaGNetConfig(c=12, cd1=12, p=1, q=1, dilas=(1, 2))
    else:
        eab, gag = EaBNetConfig(M=9), GaGNetConfig()
    if args.norm_type is not None:
        eab = dataclasses.replace(eab, norm_type=args.norm_type)
        gag = dataclasses.replace(gag, norm_type=args.norm_type)
    if args.bf_impl is not None:
        eab = dataclasses.replace(eab, bf_impl=args.bf_impl)
    if args.train_set == "online":
        lists = os.path.join(root, "lists")
        data = DataConfig(
            dataset="mcse", train_set="online",
            speech_root=os.path.join(root, "speech"),
            noise_root=os.path.join(root, "noise"),
            speech_list=os.path.join(lists, "speechs_train"),
            noise_list=os.path.join(lists, "noises_train"),
            device_mix=(False if args.device_mix == "none"
                        else args.device_mix),
            transfer_int16=True,
            mcse_settings=settings_path,
            val_set=os.path.join(root, "val"),
            clip_seconds=args.seconds, num_workers=args.workers,
        )
    else:
        data = DataConfig(
            dataset="mcse", train_set="offline",
            # offline mcse training reads paired clean/ + noisy/ dirs
            # from speech_root (data/datasets.py::make_dataset)
            speech_root=os.path.join(root, "train_set"),
            transfer_int16=True,
            mcse_settings=settings_path,
            val_set=os.path.join(root, "val"),
            clip_seconds=args.seconds, num_workers=args.workers,
        )
    return ExperimentConfig(
        model=ComposedConfig(eabnet=eab, gagnet=gag, freeze_eabnet=frozen),
        data=data,
        train=TrainConfig(
            batch_size=args.batch, wav_len=args.seconds,
            total_epoch=10**9, log_every=50, lr=args.lr,
            valid_interval=1e18, saving_interval=1e18,
            checkpoint_dir=os.path.join(root, "ckpt"),
            exp_root=root, fixed_seed=True,
            compute_dtype=args.dtype,
        ),
    )


def main(argv=None) -> None:
    """Stage, then train chunk by chunk to ``--max-steps``; raises
    ``SystemExit(75)`` once ``--steps-per-process`` steps are done in this
    call (more remain)."""
    from eabnet_tpu_torch.tools.e2e_demo import SETTINGS, device_for

    args = parse_args(argv)
    device = device_for(args.platform)
    RUN.update(staged_s=None, chunks=[])

    root = args.workdir
    os.makedirs(root, exist_ok=True)
    t0 = time.time()
    settings_path = stage_data(
        root, args.corpus_speech, args.corpus_noise, args.seconds,
        args.train_items, args.val_items, args.workers, SETTINGS,
        render_train=args.train_set == "offline",
    )
    RUN["staged_s"] = time.time() - t0
    print(f"[long_train] data staged in {RUN['staged_s']:.1f}s", flush=True)

    from eabnet_tpu_torch.checkpoint import latest_checkpoint, load_params
    from eabnet_tpu_torch.data.datasets import OfflineMcseDataset
    from eabnet_tpu_torch.train.trainer import train

    val = OfflineMcseDataset(os.path.join(root, "val"))
    curves = os.path.join(root, "curves.jsonl")

    # constant noisy baseline row (step -1) once per run file
    if not os.path.exists(curves):
        base = score_stage(make_config(args, root, settings_path, False),
                           None, val, "noisy")
        with open(curves, "a") as f:
            f.write(json.dumps({"step": -1, "stage": "noisy", **base})
                    + "\n")
        print(f"[long_train] noisy baseline: {base}", flush=True)

    done = 0
    ck = latest_checkpoint(os.path.join(root, "ckpt"))
    if ck is not None:
        done = int(os.path.basename(ck).split(".")[0])
        print(f"[long_train] resuming at step {done}", flush=True)

    start = done
    while done < args.max_steps:
        if (args.steps_per_process is not None
                and done - start >= args.steps_per_process):
            print(f"[long_train] recycling process at step {done} "
                  f"(+{done - start} this process; exit "
                  f"{EXIT_RECYCLE}, resume in a fresh one)", flush=True)
            sys.exit(EXIT_RECYCLE)
        target = min(done + args.chunk, args.max_steps)
        frozen = args.freeze_after is not None and done >= args.freeze_after
        cfg = make_config(args, root, settings_path, frozen)
        t1 = time.time()
        hist = train(cfg, max_steps=target, device=device)
        dt = time.time() - t1
        done = target
        sps = args.chunk / max(dt, 1e-9)
        print(f"[long_train] step {done} chunk took {dt:.1f}s "
              f"({sps:.2f} it/s, frozen={frozen})", flush=True)

        t2 = time.time()
        params = load_params(latest_checkpoint(cfg.train.checkpoint_dir))
        for stage in ("esti0", "esti"):
            row = {"step": done, "stage": stage, "frozen": frozen,
                   "it_per_sec": round(sps, 3),
                   **score_stage(cfg, params, val, stage, device)}
            with open(curves, "a") as f:
                f.write(json.dumps(row) + "\n")
            print(f"[long_train] {row}", flush=True)
        RUN["chunks"].append(dict(
            step=done, frozen=frozen, seconds=dt, it_per_sec=sps,
            score_s=time.time() - t2,
            losses=[{k: h[k] for k in ("eabnet", "postnet", "final")}
                    for h in hist]))
        prune_checkpoints(cfg.train.checkpoint_dir,
                          keep_every=10 * args.chunk)
    print("[long_train] done", flush=True)


if __name__ == "__main__":
    main()
