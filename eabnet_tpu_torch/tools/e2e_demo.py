"""End-to-end demonstration of the port on one card, as the repo's
``tools/e2e_demo.py`` runs the JAX package.

Builds a synthetic speech/noise corpus, splits it (seeded 20:1), renders a
frozen validation set, trains the default 9-mic model with online
room-acoustics synthesis for --steps optimizer steps, then scores the
checkpoint against the noisy baseline with the metric battery.

This is the whole stack: data synthesis, loader, train step,
checkpointing, inference, metrics, driven end to end. Pass --workdir to
keep the artifacts; ``--platform cpu`` runs on the CPU (the kernels'
plain versions), else the card.

    python -m eabnet_tpu_torch.tools.e2e_demo --steps 300

``make_corpus`` and ``SETTINGS`` are the JAX tool's (the same seeds give
the same wav bytes); ``tools/long_train.py`` stages its data with them.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

import numpy as np

KEYS = ("si_sdr", "pesq", "estoi", "stoi", "seg_snr", "lsd")  # printed
# the means long_train's curves and release_report's tables hold
METRICS = ("si_sdr", "pesq", "nb_pesq", "stoi", "estoi", "seg_snr", "lsd")


def make_corpus(root: str, n_speech=64, n_noise=16, seconds=3.0, sr=16000):
    """Synthesize a speech/noise corpus with the formant speech
    synthesizer (``data/synth_speech.py``): speech ``sp<i>.wav`` from seed
    7000 + i, noise ``no<i>.wav`` of kind i from seed 9000 + i."""
    from eabnet_tpu_torch.data.synth_speech import synth_noise, synth_utterance
    from eabnet_tpu_torch.utils.audio_io import write_wav

    sp_dir = os.path.join(root, "speech")
    no_dir = os.path.join(root, "noise")
    os.makedirs(sp_dir, exist_ok=True)
    os.makedirs(no_dir, exist_ok=True)
    for i in range(n_speech):
        x = synth_utterance(seconds, sr, seed=7000 + i)
        write_wav(os.path.join(sp_dir, f"sp{i:03d}.wav"), sr, x)
    for i in range(n_noise):
        x = synth_noise(seconds, sr, kind=i, seed=9000 + i)
        write_wav(os.path.join(no_dir, f"no{i:03d}.wav"), sr, x)
    return sp_dir, no_dir


SETTINGS = {
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


def add_platform(parser: argparse.ArgumentParser) -> None:
    """The tools' ``--platform``: the card unless ``cpu`` is asked for."""
    parser.add_argument("--platform", default="default",
                        choices=["default", "cpu"],
                        help="default = the CUDA card (the hand-written "
                        "kernels); cpu = the CPU (their plain versions)")


def device_for(platform: str) -> str:
    return "cpu" if platform == "cpu" else "cuda"


def val_items(val):
    """(noisy (M, N), clean (N,)) pairs of an offline set."""
    for i in range(len(val)):
        noisy, clean = val[i]
        yield np.atleast_2d(noisy), np.asarray(clean).reshape(-1)


def restore(cfg, ckpt: str, device: str = "cpu"):
    """A train state on ``device`` restored from ``ckpt`` (``.ckpt``,
    ``.params`` or a reference ``.pth``), its step included, as the JAX
    tools restore one (``create_train_state`` + ``load_checkpoint``)."""
    from eabnet_tpu_torch.train.checkpoint import load_checkpoint
    from eabnet_tpu_torch.train.step import create_train_state

    state, _ = load_checkpoint(ckpt, create_train_state(cfg, device), cfg)
    return state


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=300)
    parser.add_argument("--workdir", default=None)
    parser.add_argument("--workers", type=int, default=8)
    parser.add_argument("--val-items", type=int, default=5)
    add_platform(parser)
    args = parser.parse_args(argv)
    device = device_for(args.platform)

    root = args.workdir or tempfile.mkdtemp(prefix="eabnet_e2e_")
    print(f"workdir: {root}")
    sp_dir, no_dir = make_corpus(root)
    settings_path = os.path.join(root, "settings.json")
    with open(settings_path, "w") as f:
        json.dump(SETTINGS, f)

    # seeded split (cli.split) + list files
    from eabnet_tpu_torch.cli.split import main as split_main

    split_main(["--speech-root", sp_dir, "--noise-root", no_dir,
                "--out-dir", os.path.join(root, "lists")])

    # frozen val set (cli.datagen on the val lists)
    from eabnet_tpu_torch.cli.datagen import main as datagen_main

    datagen_main([
        "--output-dir", os.path.join(root, "val"),
        "--speech-root", sp_dir, "--noise-root", no_dir,
        "--speech-list", os.path.join(root, "lists", "speechs_val"),
        "--noise-list", os.path.join(root, "lists", "noises_val"),
        "--mcse-settings", settings_path, "--clip-seconds", "6",
        "--workers", "4", "--limit", str(args.val_items),
    ])

    # train
    from eabnet_tpu_torch.config import (ComposedConfig, DataConfig,
                                         EaBNetConfig, ExperimentConfig,
                                         GaGNetConfig, TrainConfig)
    from eabnet_tpu_torch.train.trainer import train

    cfg = ExperimentConfig(
        model=ComposedConfig(eabnet=EaBNetConfig(M=9),
                             gagnet=GaGNetConfig()),
        data=DataConfig(
            dataset="mcse", train_set="online",
            speech_root=sp_dir, noise_root=no_dir,
            speech_list=os.path.join(root, "lists", "speechs_train"),
            noise_list=os.path.join(root, "lists", "noises_train"),
            mcse_settings=settings_path,
            val_set=os.path.join(root, "val"),
            clip_seconds=6.0, num_workers=args.workers,
        ),
        train=TrainConfig(
            batch_size=8, total_epoch=10000, log_every=10,
            valid_interval=1e9, saving_interval=1e9,
            checkpoint_dir=os.path.join(root, "ckpt"),
            exp_root=root, fixed_seed=True,
        ),
    )
    train(cfg, max_steps=args.steps, device=device)

    # evaluate: trained model vs noisy baseline
    from eabnet_tpu_torch.checkpoint import latest_checkpoint, load_params
    from eabnet_tpu_torch.data.datasets import OfflineMcseDataset
    from eabnet_tpu_torch.eval import evaluate_dataset, write_report
    from eabnet_tpu_torch.inference import Enhancer

    params = load_params(latest_checkpoint(cfg.train.checkpoint_dir))
    val = OfflineMcseDataset(os.path.join(root, "val"))

    # the bare EaBNet beamformer is what the reference's eval battery
    # scores; the composed output is also reported: the GaGNet
    # refinement only helps after much longer training
    accs = {}
    for stage, fn in (
            ("model", Enhancer(cfg, params, output="esti0", device=device)),
            ("composed", Enhancer(cfg, params, output="esti",
                                  device=device)),
            ("noisy", lambda noisy: noisy[0])):
        accs[stage], rows = evaluate_dataset(fn, val_items(val), sr=16000)
        write_report(accs[stage], rows, os.path.join(root, f"scores_{stage}"))

    print("\n=== noisy -> EaBNet -> composed (mean ± std) ===")
    for metric in KEYS:
        m0, m1, m2 = (accs[s].mean_std(metric)
                      for s in ("noisy", "model", "composed"))
        print(f"{metric:8s}: {m0[0]:7.3f} ± {m0[1]:5.3f}  ->  "
              f"{m1[0]:7.3f} ± {m1[1]:5.3f}  ->  "
              f"{m2[0]:7.3f} ± {m2[1]:5.3f}")
    return {stage: {k: acc.mean_std(k)[0] for k in KEYS}
            for stage, acc in accs.items()}


if __name__ == "__main__":
    main()
