"""The port's trainer, CLI, data loader and training guard on the CPU at a
small width: checkpoints written and resumed from, batches as the JAX
package's loader makes them, and what the slice refuses."""

import json
import os

import numpy as np
import pytest
import torch

from eabnet_tpu.data import datasets as JD
from eabnet_tpu_torch.config import (ComposedConfig, DataConfig,
                                     EaBNetConfig, ExperimentConfig,
                                     GaGNetConfig, TrainConfig,
                                     require_training)
from eabnet_tpu_torch.data import datasets as PD
from eabnet_tpu_torch.train.trainer import train

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VAL = os.path.join(ROOT, "release", "val_set")


def tiny_cfg(tmp_path, **train_kw):
    return ExperimentConfig(
        model=ComposedConfig(
            eabnet=EaBNetConfig(c=8, M=3, embed_dim=8, cd1=8, p=2, q=1),
            gagnet=GaGNetConfig(c=8, cd1=8, p=1, q=1, dilas=(1, 2))),
        data=DataConfig(dataset="fake", clip_seconds=0.1, num_workers=0,
                        pad_to_seconds=0.1),
        train=TrainConfig(**{"batch_size": 2, "wav_len": 0.1,
                             "total_epoch": 2, "log_every": 1,
                             "checkpoint_dir": str(tmp_path / "ckpt"),
                             "exp_root": str(tmp_path), **train_kw}))


def test_train_writes_and_resumes(tmp_path, capsys):
    cfg = tiny_cfg(tmp_path)
    hist = train(cfg, max_steps=2, device="cpu", tensorboard=False)
    out = capsys.readouterr().out
    assert "model parameters" in out and "iter 2 epoch 0 loss" in out
    assert [h["step"] for h in hist] == [1, 2]
    assert all(np.isfinite(h[k]) for h in hist
               for k in ("eabnet", "postnet", "final"))
    assert sorted(os.listdir(cfg.train.checkpoint_dir)) == ["2.ckpt"]
    assert ExperimentConfig.load(str(tmp_path / "config.json")) == cfg
    hist = train(cfg, max_steps=3, device="cpu", tensorboard=False)
    assert "resumed from" in capsys.readouterr().out
    assert [h["step"] for h in hist] == [3]
    assert "3.ckpt" in os.listdir(cfg.train.checkpoint_dir)


def test_resume_is_the_uninterrupted_run(tmp_path, monkeypatch):
    """Steps 1-2, a checkpoint, step 3 after a restart == steps 1-3 in one
    run (one batch per epoch, so the resumed epoch is the one an
    uninterrupted run takes)."""

    def two_items(cfg, mics=9, seed=0):
        return PD.FakeDataset(2, mics, cfg.clip_seconds, seed=seed), None

    monkeypatch.setattr("eabnet_tpu_torch.train.trainer.make_dataset",
                        two_items)
    a = tiny_cfg(tmp_path / "a", total_epoch=5)
    train(a, max_steps=2, device="cpu", tensorboard=False)
    resumed = train(a, max_steps=3, device="cpu", tensorboard=False)
    b = tiny_cfg(tmp_path / "b", total_epoch=5)
    straight = train(b, max_steps=3, device="cpu", tensorboard=False)
    for k in ("eabnet", "postnet", "final"):
        assert resumed[-1][k] == pytest.approx(straight[-1][k], rel=1e-6)


def test_resume_from_params_file(tmp_path, capsys):
    cfg = tiny_cfg(tmp_path)
    train(cfg, max_steps=1, device="cpu", tensorboard=False)
    from eabnet_tpu_torch.train.checkpoint import (load_checkpoint,
                                                   save_params)
    from eabnet_tpu_torch.train.step import create_train_state

    state = create_train_state(cfg, "cpu")
    state, _ = load_checkpoint(os.path.join(cfg.train.checkpoint_dir,
                                            "1.ckpt"), state, cfg)
    save_params(state.model, cfg.train.checkpoint_dir, 5)
    capsys.readouterr()
    with pytest.warns(UserWarning, match="params-only"):
        hist = train(cfg, max_steps=6, device="cpu", tensorboard=False)
    assert "5.params (iter 5, epoch 0)" in capsys.readouterr().out
    assert [h["step"] for h in hist] == [6]


def test_cli_train(tmp_path, capsys):
    from eabnet_tpu_torch.cli import train as cli

    cfg = tiny_cfg(tmp_path)
    path = tmp_path / "exp.json"
    path.write_text(cfg.to_json())
    cli.main(["--config", str(path), "--max-steps", "1", "--device", "cpu"])
    assert "iter 1 epoch 0" in capsys.readouterr().out
    assert os.path.exists(os.path.join(cfg.train.checkpoint_dir, "1.ckpt"))


OVERRIDES = ["train.compute_dtype=float32", "train.lr=1e-4",
             "model.eabnet.M=8", "data.dataset=fake",
             "train.mesh_axes=[\"data\"]", "train.new_level.key=text"]


def test_cli_overrides_match_jax():
    """The port's --set gives the dict the JAX package's CLI gives."""
    import dataclasses

    from eabnet_tpu.cli.common import _apply_overrides
    from eabnet_tpu_torch.cli.common import apply_overrides

    d = dataclasses.asdict(ExperimentConfig())
    ours = apply_overrides(json.loads(json.dumps(d)), OVERRIDES)
    assert ours == _apply_overrides(json.loads(json.dumps(d)), OVERRIDES)
    assert ours["train"]["lr"] == 1e-4 and ours["model"]["eabnet"]["M"] == 8
    assert ours["train"]["new_level"] == {"key": "text"}


def test_cli_train_set_trains_a_bfloat16_config(tmp_path, capsys):
    """A config that records bfloat16 compute (as the released ones do)
    trains in bf16 mixed precision as recorded, and in float32 through
    --set."""
    from eabnet_tpu_torch.cli import train as cli

    cfg = tiny_cfg(tmp_path / "bf16", compute_dtype="bfloat16")
    path = tmp_path / "exp.json"
    path.write_text(cfg.to_json())
    cli.main(["--config", str(path), "--max-steps", "1", "--device", "cpu"])
    assert "iter 1 epoch 0" in capsys.readouterr().out
    saved = ExperimentConfig.load(str(tmp_path / "bf16" / "config.json"))
    assert saved.train.compute_dtype == "bfloat16"
    cli.main(["--config", str(path), "--max-steps", "1", "--device", "cpu",
              "--set", "train.compute_dtype=float32", "--set",
              "train.lr=1e-4", "--set",
              f"train.checkpoint_dir={tmp_path / 'f32' / 'ckpt'}", "--set",
              f"train.exp_root={tmp_path / 'f32'}"])
    assert "iter 1 epoch 0" in capsys.readouterr().out
    saved = ExperimentConfig.load(str(tmp_path / "f32" / "config.json"))
    assert (saved.train.compute_dtype, saved.train.lr) == ("float32", 1e-4)


def test_loader_batches_match_jax():
    ds_p = PD.FakeDataset(5, 3, 0.05, seed=3)
    ds_j = JD.FakeDataset(5, 3, 0.05, seed=3)
    lp = PD.BatchLoader(ds_p, 2, shuffle=True, seed=7, pad_multiple=300)
    lj = JD.BatchLoader(ds_j, 2, shuffle=True, seed=7, pad_multiple=300)
    assert len(lp) == len(lj) == 2
    for epoch in (0, 3):
        for bp, bj in zip(lp.epoch(epoch), lj.epoch(epoch)):
            for a, b in zip(bp, bj):
                assert a.dtype == b.dtype and a.shape == b.shape
                np.testing.assert_array_equal(a, b)


def test_collate_pads_and_keeps_lengths():
    items = [(np.ones((2, 7), np.float32), np.ones(7, np.float32)),
             (np.ones((2, 4), np.float32), np.ones(4, np.float32))]
    for ours, ref in zip(PD._collate(items, 5), JD._collate(items, 5)):
        np.testing.assert_array_equal(ours, ref)
    noisy, clean, n = PD._collate(items, 5)
    assert noisy.shape == (2, 2, 10) and list(n) == [7, 4]
    assert not noisy[1, :, 4:].any()


@pytest.mark.parametrize("int16", [False, True])
def test_offline_dataset_matches_jax(int16):
    ours, ref = (PD.OfflineMcseDataset(VAL, int16),
                 JD.OfflineMcseDataset(VAL, int16))
    assert ours.names == ref.names and len(ours) == 7
    for a, b in zip(ours[2], ref[2]):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_train_step_dequantizes_int16():
    from eabnet_tpu_torch.train.step import _dequant

    x = torch.tensor([-32768, 0, 16384], dtype=torch.int16)
    np.testing.assert_array_equal(_dequant(x).numpy(), [-1.0, 0.0, 0.5])


@pytest.mark.parametrize("change", [
    {"train": {"compute_dtype": "bfloat16"}},
    {"train": {"mesh_axes": ["model", "data"]}},
    {"data": {"device_mix": "parts"}},
    {"model": {"gagnet": {"norm_type": "BN"}}},
], ids=["bf16", "mesh", "device_mix", "bn"])
def test_training_guard_refuses(tmp_path, change):
    """The guard refuses a mesh that gives an axis other than 'data' more
    than one rank (the JAX trainer's mesh), compute dtypes other than
    float32 and bfloat16, and an unknown device_mix mode with ValueError; a bf16
    config, a device_mix mode (on the fake dataset, which is not online,
    the loader gives wav batches) and a batch-norm model pass it and
    train: one step on the CPU, and for the batch norm its running
    statistics moved, which the checkpoint carries as batch_stats."""
    d = json.loads(tiny_cfg(tmp_path).to_json())
    for section, kv in change.items():
        for k, v in kv.items():
            if isinstance(v, dict):
                d[section][k].update(v)
            else:
                d[section][k] = v
    cfg = ExperimentConfig.from_dict(d)
    bf16 = cfg.train.compute_dtype == "bfloat16"
    if tuple(cfg.train.mesh_axes) != ("data",):
        # the JAX trainer's mesh: "model" leads, so over two ranks it is
        # the wide axis; alone it has extent 1 and the config trains
        with pytest.raises(NotImplementedError):
            require_training(cfg, world=2)
        require_training(cfg)
        return
    require_training(cfg)
    if bf16:
        d["train"]["compute_dtype"] = "float16"
        with pytest.raises(NotImplementedError):
            require_training(ExperimentConfig.from_dict(d))
    if cfg.data.device_mix:
        bad = json.loads(json.dumps(d))
        bad["data"]["device_mix"] = "everything"
        with pytest.raises(ValueError):
            require_training(ExperimentConfig.from_dict(bad))
    from eabnet_tpu_torch.checkpoint import msgpack_restore

    hist = train(cfg, max_steps=1, device="cpu", tensorboard=False)
    assert [h["step"] for h in hist] == [1]
    assert all(np.isfinite(hist[0][k]) for k in ("eabnet", "postnet",
                                                 "final"))
    if cfg.model.gagnet.norm_type != "BN":
        return
    with open(os.path.join(cfg.train.checkpoint_dir, "1.ckpt"), "rb") as f:
        stats = msgpack_restore(f.read())["state"]["batch_stats"]
    norm = stats["postnet"]["en"]["unet_0"]["in_norm"]["norm"]
    assert set(stats) == {"postnet"}
    assert np.abs(norm["mean"]).max() > 0 and not np.allclose(norm["var"],
                                                              1.0)


@pytest.mark.parametrize("what", ["online", "l3das23"])
def test_make_dataset_refuses_what_it_does_not_load(tmp_path, what):
    """l3das23 loads its pickles (tests/test_torch_l3das.py), and without
    them fails to open them; online synthesis loads: an OnlineMcseDataset
    over the lists, with a packaged settings file, seeded per item."""
    if what == "l3das23":
        with pytest.raises(FileNotFoundError):
            PD.make_dataset(DataConfig(dataset="l3das23"))
        return
    (tmp_path / "sp").write_text("a.wav\nb.wav\nc.wav\n")
    (tmp_path / "no").write_text("n.wav")
    train, val = PD.make_dataset(DataConfig(
        dataset="mcse", train_set="online", mcse_settings="v2",
        speech_list=str(tmp_path / "sp"), noise_list=str(tmp_path / "no"),
        speech_root="/s", noise_root="/n"), seed=4)
    assert isinstance(train, PD.OnlineMcseDataset) and val is None
    assert len(train) == 3 and len(train.opt["mic_array"]["mics"]) == 9
    args = train.item_args(2, epoch=1)
    assert args["speech_path"] == "/s/c.wav" and args["noise_paths"] == [
        "/n/n.wav"] and args["seed"] == 4 * 1_000_003 + 7_919 + 2
