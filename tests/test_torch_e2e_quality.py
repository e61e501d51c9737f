"""The port's end-to-end quality gate, the counterpart of
``tests/test_e2e_quality.py``: the same gate settings, corpus, reduced
model, 120 steps and margins, run through the port on the CPU and, with
the ``gpu`` marker, on the card (its TCN widths 24 and 16 run through the
TCM-chain kernels zero-padded to their 64). Slow-marked like the JAX
gate; run with --run-slow here, and on the card with
``python -m pytest -m gpu --noconftest tests/test_torch_e2e_quality.py``.

The corpus and settings come from the port's
``eabnet_tpu_torch.tools.e2e_demo``: a formant-synth corpus (24 speech, 8
noise files of 2 s), the seeded 20:1 split, a frozen val set of 2 items,
online room-acoustics synthesis in 2 spawned workers, batch 4. The
trained bare EaBNet (``esti0``) must beat the noisy reference mic by the
JAX gate's margins: SI-SDR +4.5 dB, PESQ +0.20, STOI +0.02, ESTOI +0.03.
The port's initial weights are drawn from the JAX package's initialisers
with PyTorch's generator, so they are not the JAX gate's numbers, and
neither are its results.
"""

import copy
import json
import os

import numpy as np
import pytest

from eabnet_tpu_torch.tools.e2e_demo import SETTINGS, make_corpus, val_items

GATE_SETTINGS = copy.deepcopy(SETTINGS)
GATE_SETTINGS["room"]["min_dim"] = [3, 3, 2.5]
GATE_SETTINGS["room"]["max_dim"] = [5, 5, 3]
GATE_SETTINGS["room"]["rt60"] = [0.1, 0.2]
GATE_SETTINGS["target"]["dist_to_mic_array"] = [0.5, 1.5]
GATE_SETTINGS["noise"]["SNR"] = [-10, -5]


@pytest.mark.slow
def test_training_improves_si_sdr_over_noisy(tmp_path):
    gate(str(tmp_path), "cpu")


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")


@pytest.mark.slow
@pytest.mark.gpu
def test_training_improves_si_sdr_over_noisy_on_card(cuda, tmp_path):
    gate(str(tmp_path), "cuda")


def gate(root, device):
    """Stage, train 120 steps on ``device``, score esti0 against the noisy
    reference mic at the JAX gate's margins."""
    from eabnet_tpu_torch.checkpoint import latest_checkpoint, load_params
    from eabnet_tpu_torch.cli.datagen import main as datagen_main
    from eabnet_tpu_torch.cli.split import main as split_main
    from eabnet_tpu_torch.config import (ComposedConfig, DataConfig,
                                         EaBNetConfig, ExperimentConfig,
                                         GaGNetConfig, TrainConfig)
    from eabnet_tpu_torch.data.datasets import OfflineMcseDataset
    from eabnet_tpu_torch.eval import evaluate_dataset
    from eabnet_tpu_torch.inference import Enhancer
    from eabnet_tpu_torch.train.trainer import train

    sp_dir, no_dir = make_corpus(root, n_speech=24, n_noise=8, seconds=2.0)
    settings_path = os.path.join(root, "settings.json")
    with open(settings_path, "w") as f:
        json.dump(GATE_SETTINGS, f)
    split_main(["--speech-root", sp_dir, "--noise-root", no_dir,
                "--out-dir", os.path.join(root, "lists")])
    datagen_main([
        "--output-dir", os.path.join(root, "val"),
        "--speech-root", sp_dir, "--noise-root", no_dir,
        "--speech-list", os.path.join(root, "lists", "speechs_val"),
        "--noise-list", os.path.join(root, "lists", "noises_val"),
        "--mcse-settings", settings_path, "--clip-seconds", "2",
        "--workers", "2", "--limit", "2",
    ])

    cfg = ExperimentConfig(
        model=ComposedConfig(
            eabnet=EaBNetConfig(M=9, c=24, embed_dim=24, cd1=24, p=3, q=2),
            gagnet=GaGNetConfig(c=16, cd1=16, p=1, q=1, dilas=(1, 2, 5)),
        ),
        data=DataConfig(
            dataset="mcse", train_set="online",
            speech_root=sp_dir, noise_root=no_dir,
            speech_list=os.path.join(root, "lists", "speechs_train"),
            noise_list=os.path.join(root, "lists", "noises_train"),
            mcse_settings=settings_path,
            val_set=os.path.join(root, "val"),
            clip_seconds=2.0, num_workers=2,
        ),
        train=TrainConfig(
            batch_size=4, wav_len=2.0, total_epoch=10000, log_every=50,
            valid_interval=1e9, saving_interval=1e9,
            checkpoint_dir=os.path.join(root, "ckpt"),
            exp_root=root, fixed_seed=True,
        ),
    )
    train(cfg, max_steps=120, device=device)

    ckpt = latest_checkpoint(cfg.train.checkpoint_dir)
    assert ckpt is not None and ckpt.endswith("120.ckpt")
    params = load_params(ckpt)
    val = OfflineMcseDataset(os.path.join(root, "val"))
    acc_model, _ = evaluate_dataset(
        Enhancer(cfg, params, output="esti0", device=device), val_items(val),
        sr=16000)
    acc_noisy, _ = evaluate_dataset(lambda n: n[0], val_items(val),
                                    sr=16000)

    def m(acc, key):
        return acc.mean_std(key)[0]

    print(f"gate means on {device} (noisy -> esti0): " + ", ".join(
        f"{k} {m(acc_noisy, k):.4f} -> {m(acc_model, k):.4f}"
        for k in ("si_sdr", "pesq", "stoi", "estoi")))
    # the JAX gate's margins: energy AND intelligibility AND perceptual
    # quality
    assert m(acc_model, "si_sdr") > m(acc_noisy, "si_sdr") + 4.5, (
        m(acc_model, "si_sdr"), m(acc_noisy, "si_sdr"))
    assert m(acc_model, "pesq") > m(acc_noisy, "pesq") + 0.20, (
        m(acc_model, "pesq"), m(acc_noisy, "pesq"))
    assert m(acc_model, "stoi") > m(acc_noisy, "stoi") + 0.02, (
        m(acc_model, "stoi"), m(acc_noisy, "stoi"))
    assert m(acc_model, "estoi") > m(acc_noisy, "estoi") + 0.03, (
        m(acc_model, "estoi"), m(acc_noisy, "estoi"))

    # the composed (postnet) output, for plumbing: finite audio
    composed = Enhancer(cfg, params, output="esti", device=device)
    noisy0, _ = val[0]
    assert np.isfinite(composed(np.atleast_2d(noisy0))).all()
