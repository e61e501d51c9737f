"""L3DAS23 data in the port against the JAX package: every function of
``data/l3das.py`` on seeded inputs (equal arrays, equal files),
``make_dataset("l3das23")`` item for item, the collation of its (1, N)
targets and the loader's rank shards, one train step of the JAX package
against the port's on a collated batch of the fake 4-channel pickles
(losses within 1e-5 relative, ``tests/test_torch_train_step.py``'s
LOSS_RTOL), and the port's ``train()`` and ``cli.train`` on those
pickles, with validation.
"""

import json
import os
import pickle

import jax
import numpy as np
import pytest
import torch

from eabnet_tpu.config import ComposedConfig as JComposed
from eabnet_tpu.config import DataConfig as JData
from eabnet_tpu.config import EaBNetConfig as JEaB
from eabnet_tpu.config import ExperimentConfig as JExperiment
from eabnet_tpu.config import GaGNetConfig as JGaG
from eabnet_tpu.config import TrainConfig as JTrain
from eabnet_tpu.data import datasets as JD
from eabnet_tpu.data import l3das as JL
from eabnet_tpu.train.step import create_train_state as j_create_state
from eabnet_tpu.train.step import make_train_step as j_make_step
from eabnet_tpu_torch.config import DataConfig, ExperimentConfig
from eabnet_tpu_torch.data import datasets as PD
from eabnet_tpu_torch.data import l3das as PL
from eabnet_tpu_torch.models import build_model
from eabnet_tpu_torch.train import step as P
from eabnet_tpu_torch.train.trainer import train
from eabnet_tpu_torch.weights import load_jax_params

LOSS_RTOL = 1e-5
CHANNELS, N_ITEMS, N = 4, 4, 16000
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
def fake(tmp_path_factory):
    """The port's fake L3DAS23 pickles (4 channels, 1 s), and the JAX
    package's in another directory."""
    ours = tmp_path_factory.mktemp("port_fake")
    ref = tmp_path_factory.mktemp("jax_fake")
    PL.gen_fake_l3das_dataset(str(ours), n_items=N_ITEMS,
                              channels=CHANNELS, n=N)
    JL.gen_fake_l3das_dataset(str(ref), n_items=N_ITEMS, channels=CHANNELS,
                              n=N)
    return str(ours), str(ref)


def data_kw(root):
    return dict(
        dataset="l3das23",
        training_predictors_path=os.path.join(root, "training_predictors.pkl"),
        training_target_path=os.path.join(root, "training_target.pkl"),
        validation_predictors_path=os.path.join(
            root, "validation_predictors.pkl"),
        validation_target_path=os.path.join(root, "validation_target.pkl"))


def same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and \
        a.tobytes() == b.tobytes()


# ------------------------------------------------ l3das.py, function by
def test_fake_dataset_files_equal_jax(fake):
    ours, ref = fake
    names = sorted(os.listdir(ref))
    assert sorted(os.listdir(ours)) == names and len(names) == 6
    for name in names:
        with open(os.path.join(ours, name), "rb") as f:
            a = pickle.load(f)
        with open(os.path.join(ref, name), "rb") as f:
            b = pickle.load(f)
        assert len(a) == len(b) == N_ITEMS
        assert all(same(x, y) for x, y in zip(a, b)), name


def test_dummy_waveforms_equal_jax(tmp_path):
    PL.gen_dummy_waveforms(3, str(tmp_path / "p"),
                           rng=np.random.default_rng(4))
    JL.gen_dummy_waveforms(3, str(tmp_path / "j"),
                           rng=np.random.default_rng(4))
    for i in range(3):
        assert same(np.load(tmp_path / "p" / f"{i}.npy"),
                    np.load(tmp_path / "j" / f"{i}.npy"))


@pytest.mark.parametrize("kw", [dict(), dict(output_phase=False),
                                dict(cut_dc=False, cut_last_timeframe=False),
                                dict(nperseg=256, noverlap=64,
                                     window="hann")],
                         ids=["default", "magnitude", "uncut", "hann256"])
def test_spectrum_fast_equals_jax(kw):
    x = np.random.default_rng(2).standard_normal((4, 8000))
    a, b = PL.spectrum_fast(x, **kw), JL.spectrum_fast(x, **kw)
    assert same(a, b)


def test_seld_codecs_equal_jax(tmp_path):
    frames, classes, overlaps = 30, 14, 3
    rng = np.random.default_rng(3)
    sed = (rng.random((frames, classes * overlaps)) > 0.9).astype(float)
    doa = rng.random((frames, classes * overlaps * 3))
    a = PL.gen_submission_list_task2(sed, doa, num_frames=frames)
    assert len(a) > 5 and same(a, JL.gen_submission_list_task2(
        sed, doa, num_frames=frames))
    rows = ["Start,End,Class,rho,theta,z"]
    for _ in range(12):
        start = rng.random() * 5
        rows.append(f"{start:.2f},{start + rng.random():.2f},"
                    f"{PL.SELD_CLASSES[rng.integers(14)]},"
                    f"{rng.random() * 3:.3f},{rng.random() * 360:.2f},"
                    f"{rng.random() - 0.5:.3f}")
    csv = tmp_path / "labels.csv"
    csv.write_text("\n".join(rows) + "\n")
    cls = {c: i for i, c in enumerate(PL.SELD_CLASSES)}
    assert PL.SELD_CLASSES == JL.SELD_CLASSES
    for kw in (dict(), dict(no_overlaps=True), dict(dur=10.0, step=0.05)):
        assert same(PL.csv_to_matrix_task2(str(csv), cls, **kw),
                    JL.csv_to_matrix_task2(str(csv), cls, **kw)), kw


def test_seld_out_and_segments_equal_jax():
    a = PL.gen_seld_out(20, rng=np.random.default_rng(5))
    b = JL.gen_seld_out(20, rng=np.random.default_rng(5))
    assert a.shape == b.shape and (a == b).all()
    rng = np.random.default_rng(6)
    x, y = rng.standard_normal((4, 2500)), rng.standard_normal((1, 2500))
    for length in (1000, 2500, 4000):
        (xa, ya), (xb, yb) = (PL.segment_waveforms(x, y, length),
                              JL.segment_waveforms(x, y, length))
        assert len(xa) == len(xb) == -(-2500 // length)
        assert all(same(p, q) for p, q in zip(xa + ya, xb + yb))


def test_audio_visual_items_equal_jax(tmp_path):
    """The image modality: the CSV map, ``load_image`` (PIL, imported only
    there) and the dataset's ((audio, image), target) items."""
    from PIL import Image

    rng = np.random.default_rng(8)
    img = (rng.random((6, 5, 3)) * 255).astype(np.uint8)
    Image.fromarray(img).save(tmp_path / "a.png")
    csv = tmp_path / "map.csv"
    csv.write_text("0,a.png\n1,a.png\n\n")
    assert PL.audio_image_csv_to_dict(str(csv)) == \
        JL.audio_image_csv_to_dict(str(csv)) == {"0": "a.png", "1": "a.png"}
    for resize in (None, 4):
        assert same(PL.load_image(str(tmp_path / "a.png"), resize),
                    JL.load_image(str(tmp_path / "a.png"), resize))
    preds = [rng.standard_normal((4, 300)) for _ in range(2)]
    with open(tmp_path / "p.pkl", "wb") as f:
        pickle.dump((preds, ["0", "1"]), f)  # (audio, paths) form
    with open(tmp_path / "t.pkl", "wb") as f:
        pickle.dump([rng.standard_normal((1, 300)) for _ in range(2)], f)
    args = [str(tmp_path / "p.pkl"), str(tmp_path / "t.pkl"),
            str(tmp_path), str(csv)]
    a, b = PL.L3dasDataset(*args), JL.L3dasDataset(*args)
    assert len(a) == len(b) == 2 and a.audio_paths == b.audio_paths
    for i in range(2):
        ((xa, ia), ya), ((xb, ib), yb) = a[i], b[i]
        assert same(xa, xb) and same(ia, ib) and same(ya, yb)


# --------------------------------------------------------- make_dataset
def test_make_dataset_l3das23_items_equal_jax(fake):
    ours, _ = fake
    a = PD.make_dataset(DataConfig(**data_kw(ours)), mics=CHANNELS)
    b = JD.make_dataset(JData(**data_kw(ours)), mics=CHANNELS)
    ns = argparse_like(ours)
    c = PL.load_l3das_datasets(ns)
    for split in (0, 1):
        assert len(a[split]) == len(b[split]) == len(c[split]) == N_ITEMS
        for i in range(N_ITEMS):
            for x, y, z in zip(a[split][i], b[split][i], c[split][i]):
                assert same(x, y) and same(x, z)
    x, y = a[0][0]
    assert x.shape == (CHANNELS, N) and y.shape == (1, N)


def argparse_like(root):
    import types

    kw = data_kw(root)
    return types.SimpleNamespace(**{k: v for k, v in kw.items()
                                    if k != "dataset"})


def test_targets_collate_and_shard_like_jax(fake):
    """A (1, N) target collates into clean (B, N) as the JAX package's
    numpy broadcasting does, and the loader's two rank shards are the
    halves of each global batch."""
    ours, _ = fake
    ds = PD.make_dataset(DataConfig(**data_kw(ours)), mics=CHANNELS)[0]
    items = [ds[i] for i in range(3)]
    items[1] = (items[1][0][:, :N - 900], items[1][1][:, :N - 900])
    got, ref = PD._collate(items, 1000), JD._collate(items, 1000)
    assert got[1].shape == (3, N) and got[0].shape == (3, CHANNELS, N)
    assert all(same(a, b) for a, b in zip(got, ref))
    whole = list(PD.BatchLoader(ds, 4, seed=3).epoch(0))
    halves = [list(PD.BatchLoader(ds, 4, seed=3, rank=r, world=2).epoch(0))
              for r in (0, 1)]
    assert len(whole) == 1
    for k in range(3):
        assert same(np.concatenate([halves[0][0][k], halves[1][0][k]]),
                    whole[0][k])


# ------------------------------------------------------------- training
def small_cfg(root, tmp=None):
    return JExperiment(
        model=JComposed(
            eabnet=JEaB(c=8, M=CHANNELS, embed_dim=8, cd1=8, p=2, q=1),
            gagnet=JGaG(c=8, cd1=8, p=1, q=1, dilas=(1, 2))),
        data=JData(clip_seconds=1.0, num_workers=0, **data_kw(root)),
        train=JTrain(batch_size=2, wav_len=1.0, lr=5e-4, grad_clip=1.0,
                     total_epoch=2, log_every=1,
                     checkpoint_dir=str(tmp / "ckpt") if tmp else "",
                     exp_root=str(tmp) if tmp else ""))


def test_train_step_on_l3das_batch_matches_jax(fake):
    ours, _ = fake
    jcfg = small_cfg(ours)
    ds = PD.make_dataset(DataConfig(**data_kw(ours)), mics=CHANNELS)[0]
    noisy, clean, n = PD._collate([ds[i] for i in range(N_ITEMS)])
    _, jstate = j_create_state(jcfg, jax.random.key(0))
    params = jax.tree.map(np.asarray, jstate.params)
    _, jlosses = j_make_step(jcfg, donate=False)(jstate, noisy, clean, n)
    cfg = ExperimentConfig.from_dict(json.loads(jcfg.to_json()))
    state = P.TrainState(0, load_jax_params(build_model(cfg.model), params),
                         None)
    state.opt_state = P.adam_init(state.model)
    state, losses = P.make_train_step(cfg)(
        state, *(torch.from_numpy(a) for a in (noisy, clean, n)))
    np.testing.assert_allclose([float(losses[k]) for k in LOSS_KEYS],
                               [float(jlosses[k]) for k in LOSS_KEYS],
                               rtol=LOSS_RTOL)


def test_train_runs_on_l3das_pickles(fake, tmp_path, monkeypatch):
    """The port's train() on the pickles: M from the model config, 2 steps
    of batch 2, validation on the 4 validation items before training and
    after each step, a checkpoint."""
    from eabnet_tpu_torch.train import trainer

    ours, _ = fake
    d = json.loads(small_cfg(ours, tmp_path).to_json())
    d["train"].update(valid_interval=0.5, validate_once_before_train=True)
    cfg = ExperimentConfig.from_dict(d)
    valid = []
    validate = trainer.validate
    monkeypatch.setattr(trainer, "validate", lambda *a: valid.append(
        validate(*a)) or valid[-1])
    hist = train(cfg, max_steps=2, device="cpu", tensorboard=False)
    assert [h["step"] for h in hist] == [1, 2]
    assert all(np.isfinite(h[k]) for h in hist for k in LOSS_KEYS)
    # noisy (2, 4, N) and clean (2, N) float32, the lengths int32
    assert hist[0]["bytes"] == 2 * (CHANNELS + 1) * N * 4 + 2 * 4
    assert len(valid) == 3 and np.isfinite(valid).all()
    assert "2.ckpt" in os.listdir(cfg.train.checkpoint_dir)


def test_cli_train_runs_on_l3das_pickles(fake, tmp_path):
    """``cli.train`` as a user runs it on an l3das23 config, with the
    pickle paths given through ``--set``."""
    from eabnet_tpu_torch.cli import train as cli_train

    ours, _ = fake
    d = json.loads(small_cfg(ours, tmp_path).to_json())
    for k in data_kw(ours):
        if k != "dataset":
            d["data"][k] = ""
    path = tmp_path / "exp.json"
    path.write_text(json.dumps(d))
    sets = [a for k, v in data_kw(ours).items() if k != "dataset"
            for a in ("--set", f"data.{k}={v}")]
    hist = cli_train.main(["--config", str(path), "--max-steps", "1",
                           "--device", "cpu", *sets])
    assert [h["step"] for h in hist] == [1]
    assert np.isfinite(hist[0]["final"])
