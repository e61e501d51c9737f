"""The cnn and miso heads and L3DAS23 training at full width on the CPU,
against the JAX goldens that ``chip_smoke.py``'s heads phase holds the
card to.

- tests/golden/torch_port_heads_00000.npz (``python
  tests/golden/torch_port_heads_00000.py``): the JAX Enhancer's outputs
  of val item 00000 for composed_9mic with the seeded cnn and miso heads
  of ``chip_smoke.head_experiment``. The port's CPU forward must reach
  ``tests/test_torch_release.py``'s MIN_SNR_DB (80 dB) at both stages;
  its bf16 and int8w forwards of the cnn head the lowp rule (R - 6 dB
  against the JAX output of the same mode).
- tests/golden/torch_port_train_l3das.npz (``python
  tests/golden/torch_port_train_l3das.py``): the JAX losses of 3 steps on
  release/val_set written as L3DAS23 pickles, 40000.params cut to mics
  0-3. Its config is ``chip_smoke.l3das_config``'s, and the port's step-1
  losses of item 0 match its first item at
  ``tests/test_torch_train_golden.py``'s FIRST_STEP_RTOL.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as C  # noqa: E402
from tests.test_torch_release import MIN_SNR_DB  # noqa: E402
from tests.test_torch_train_golden import FIRST_STEP_RTOL  # noqa: E402

STAGES = ("esti", "esti0")
MODEL_BF16_DB = 6.0  # tests/test_torch_lowp.py: R - this vs JAX's mode
LOSS_KEYS = ("eabnet", "postnet", "final")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for the port: on a host that other test workers
    load, more threads mostly wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def golden():
    return np.load(os.path.join(ROOT, C.HEADS_GOLDEN))


@pytest.fixture(scope="module")
def noisy():
    from eabnet_tpu_torch.utils.audio_io import read_wav

    return read_wav(os.path.join(ROOT, C.VAL, "noisy", "00000.wav"))[1]


def snr_db(ref, est):
    with np.errstate(divide="ignore"):  # identical signals: +inf dB
        return 10 * np.log10(np.sum(ref ** 2) / np.sum((ref - est) ** 2))


def enhancer(head, compute_dtype="float32"):
    from eabnet_tpu_torch.config import ExperimentConfig
    from eabnet_tpu_torch.inference import Enhancer

    cwd = os.getcwd()
    os.chdir(ROOT)  # the release paths are relative to the root
    try:
        d, tree = C.head_experiment(C.EXP, head)
    finally:
        os.chdir(cwd)
    return Enhancer(ExperimentConfig.from_dict(d), tree,
                    compute_dtype=compute_dtype, device="cpu")


def test_heads_golden_holds_both_heads(golden):
    assert sorted(golden.files) == sorted(
        [f"{s}_{h}" for s in STAGES for h in C.HEADS]
        + ["esti_cnn_bfloat16", "esti_cnn_int8w"])
    for k in golden.files:
        assert golden[k].dtype == np.float32 and golden[k].shape == (96000,)
        assert np.isfinite(golden[k]).all() and np.std(golden[k]) > 0
    # the heads and the stages are different functions
    assert snr_db(golden["esti_cnn"], golden["esti_miso"]) < 20
    assert snr_db(golden["esti0_cnn"], golden["esti_cnn"]) < 40


@pytest.mark.parametrize("head", list(C.HEADS))
def test_port_matches_heads_golden_on_cpu(golden, noisy, head):
    enh = enhancer(head)
    for stage in STAGES:
        enh.output = stage
        out = enh(noisy)
        assert out.shape == (96000,) and np.isfinite(out).all()
        snr = snr_db(golden[f"{stage}_{head}"], out)
        assert snr >= MIN_SNR_DB, (stage, snr)


@pytest.mark.parametrize("mode", ["bfloat16", "int8w"])
def test_port_cnn_head_low_precision_on_cpu(golden, noisy, mode):
    out = enhancer("cnn", mode)(noisy)
    r = snr_db(golden["esti_cnn"], golden["esti_cnn_bfloat16"])
    assert snr_db(golden[f"esti_cnn_{mode}"], out) >= r - MODEL_BF16_DB


def test_l3das_golden_matches_its_config():
    g = np.load(os.path.join(ROOT, C.L3DAS_GOLDEN))
    assert json.loads(str(g["config"])) == C.l3das_config(
        C.l3das_paths(C.L3DAS_DIR))
    assert g["losses"].shape == (C.L3DAS_STEPS, 3)
    assert g["first_items"].shape == (7, 3)
    assert np.isfinite(g["losses"]).all()
    np.testing.assert_allclose(g["losses"][0], g["first_items"].mean(axis=0),
                               rtol=1e-6)


def test_port_first_l3das_item_matches_golden_on_cpu(tmp_path):
    """The port's losses of item 0 (4 mics of val item 00000) through the
    restricted release params, before any update, against JAX's."""
    from eabnet_tpu_torch.config import ExperimentConfig
    from eabnet_tpu_torch.data.datasets import make_dataset
    from eabnet_tpu_torch.models import build_model
    from eabnet_tpu_torch.train.step import TrainState, make_eval_step
    from eabnet_tpu_torch.weights import load_jax_params

    g = np.load(os.path.join(ROOT, C.L3DAS_GOLDEN))
    cwd = os.getcwd()
    os.chdir(ROOT)
    try:
        paths = C.write_l3das_pickles(str(tmp_path))
        params = C.l3das_params()
    finally:
        os.chdir(cwd)
    cfg = ExperimentConfig.from_dict(C.l3das_config(paths))
    ds, _ = make_dataset(cfg.data, mics=cfg.model.eabnet.M)
    noisy, target = ds[0]
    assert noisy.shape == (4, 96000) and target.shape == (1, 96000)
    model = load_jax_params(build_model(cfg.model), params)
    losses, _ = make_eval_step(cfg)(TrainState(0, model, None),
                                    torch.from_numpy(noisy[None]),
                                    torch.from_numpy(target))
    np.testing.assert_allclose([float(losses[k]) for k in LOSS_KEYS],
                               g["first_items"][0], rtol=FIRST_STEP_RTOL)
