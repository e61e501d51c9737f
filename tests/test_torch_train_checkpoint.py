"""Training checkpoints between the two packages: the port's msgpack writer
against flax byte for byte, the port's ``.ckpt`` read by the JAX package's
``load_checkpoint`` and the JAX package's read by the port's, the same
``latest_checkpoint`` ranking, and an exact parameter round trip."""

import os
from contextlib import nullcontext

import jax
import numpy as np
import pytest
import torch
from flax import serialization

from eabnet_tpu.config import (ComposedConfig, EaBNetConfig,
                               ExperimentConfig, GaGNetConfig)
from eabnet_tpu.train import checkpoint as JC
from eabnet_tpu.train.step import create_train_state
from eabnet_tpu_torch.checkpoint import (load_params, msgpack_restore,
                                         msgpack_serialize)
from eabnet_tpu_torch.config import ExperimentConfig as PExperimentConfig
from eabnet_tpu_torch.models import build_model
from eabnet_tpu_torch.train import checkpoint as PC
from eabnet_tpu_torch.train.step import TrainState, adam_init
from eabnet_tpu_torch.weights import (flatten_tree, load_jax_params,
                                      to_jax_params, to_jax_tree)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def small_cfg(norm="IN"):
    return ExperimentConfig(model=ComposedConfig(
        eabnet=EaBNetConfig(c=8, M=3, embed_dim=8, cd1=8, p=2, q=1,
                            norm_type=norm),
        gagnet=GaGNetConfig(c=8, cd1=8, p=1, q=1, dilas=(1, 2),
                            norm_type=norm)))


@pytest.fixture(scope="module")
def jax_state():
    _, state = create_train_state(small_cfg(), jax.random.key(0))
    return jax.tree.map(np.asarray, state)


def port_state(jstate, step=7, count=5):
    """A port state carrying the JAX params and seeded moments."""
    cfg = PExperimentConfig.from_json(small_cfg().to_json())
    model = load_jax_params(build_model(cfg.model), jstate.params)
    g = torch.Generator().manual_seed(0)
    opt = adam_init(model)
    for d in (opt.mu, opt.nu):
        for k, v in d.items():
            d[k] = torch.rand(v.shape, generator=g)
    opt.count = count
    return TrainState(step, model, opt)


def test_writer_matches_flax_bytes(jax_state):
    tree = {"state": serialization.to_state_dict(jax_state),
            "epoch": np.int64(3)}
    assert msgpack_serialize(tree) == serialization.to_bytes(tree)
    other = {"a": {"b": np.ones((0, 3), np.float64), "c": {}},
             "s" * 40: np.arange(70000, dtype=np.int16),
             "n": np.float32(2.5), "m": np.ones((2,) * 16, np.uint8)}
    assert msgpack_serialize(other) == serialization.to_bytes(other)
    assert msgpack_restore(msgpack_serialize(other))["n"] == np.float32(2.5)


def test_port_ckpt_reads_in_jax(tmp_path, jax_state):
    pstate = port_state(jax_state)
    path = PC.save_checkpoint(pstate, 2, str(tmp_path))
    assert os.path.basename(path) == "7.ckpt"
    template = jax.tree.map(np.asarray, jax_state)
    state, epoch = JC.load_checkpoint(path, template, small_cfg())
    assert epoch == 2 and int(state.step) == 7
    adam = state.opt_state[1][0]
    assert int(adam.count) == 5
    m = pstate.model
    for got, want in ((state.params, dict(m.named_parameters())),
                      (adam.mu, pstate.opt_state.mu),
                      (adam.nu, pstate.opt_state.nu)):
        want = flatten_tree(to_jax_tree(m, want))
        got = flatten_tree(jax.tree.map(np.asarray, got))
        assert got.keys() == want.keys()
        for k in got:
            assert got[k].tobytes() == want[k].tobytes(), k


def test_jax_ckpt_reads_in_port(tmp_path, jax_state):
    rng = np.random.default_rng(0)
    state = jax_state.replace(
        step=np.asarray(11, np.int32),
        opt_state=jax.tree.map(
            lambda v: rng.random(v.shape).astype(v.dtype)
            if v.dtype == np.float32 else np.asarray(4, np.int32),
            jax_state.opt_state))
    path = JC.save_checkpoint(state, 6, str(tmp_path))
    pstate = port_state(jax_state, step=0, count=0)
    pstate, epoch = PC.load_checkpoint(path, pstate, None)
    assert (pstate.step, epoch, pstate.opt_state.count) == (11, 6, 4)
    adam = state.opt_state[1][0]
    m = pstate.model
    for got, want in ((dict(m.named_parameters()), state.params),
                      (pstate.opt_state.mu, adam.mu),
                      (pstate.opt_state.nu, adam.nu)):
        got = flatten_tree(to_jax_tree(m, got))
        for k, v in flatten_tree(jax.tree.map(np.asarray, want)).items():
            assert got[k].tobytes() == v.tobytes(), k


def test_params_files_both_ways(tmp_path, jax_state):
    pstate = port_state(jax_state)
    path = PC.save_params(pstate.model, str(tmp_path), 40)
    jstate, epoch = JC.load_checkpoint(path, jax_state, small_cfg())
    assert int(jstate.step) == 40 and epoch == 0
    JC.save_params(jax_state.params, str(tmp_path / "j"), 9)
    fresh = port_state(jax_state, step=0, count=0)
    fresh, epoch = PC.load_checkpoint(str(tmp_path / "j" / "9.params"),
                                      fresh, None)
    assert fresh.step == 9 and epoch == 0
    assert fresh.opt_state.count == 0
    got = flatten_tree(to_jax_params(fresh.model))
    for k, v in flatten_tree(jax_state.params).items():
        assert got[k].tobytes() == v.tobytes(), k
    with pytest.raises(FileNotFoundError):  # a .pth is read, not refused
        PC.load_checkpoint(str(tmp_path / "3.pth"), fresh, small_cfg())


def test_batch_norm_ckpt_round_trips_bit_for_bit(tmp_path):
    """A BN train state with moved running statistics: written by the JAX
    package, read by the port, written by the port, read by the JAX
    package; the batch_stats and params come back bit for bit, and a
    batch_stats leaf no buffer takes is refused."""
    cfg = small_cfg("BN")
    _, state = create_train_state(cfg, jax.random.key(1))
    rng = np.random.default_rng(2)
    state = jax.tree.map(np.asarray, state).replace(
        step=np.asarray(3, np.int32),
        batch_stats=jax.tree.map(
            lambda v: rng.random(v.shape).astype(v.dtype),
            jax.tree.map(np.asarray, state.batch_stats)))
    jpath = JC.save_checkpoint(state, 1, str(tmp_path / "jax"))
    pcfg = PExperimentConfig.from_json(cfg.to_json())
    model = build_model(pcfg.model)
    assert len(list(model.named_buffers())) == len(
        flatten_tree(state.batch_stats)) > 0
    pstate, epoch = PC.load_checkpoint(
        jpath, TrainState(0, model, adam_init(model)), None)
    ppath = PC.save_checkpoint(pstate, epoch, str(tmp_path / "port"))
    back, _ = JC.load_checkpoint(ppath, state, cfg)
    for got, want in ((back.batch_stats, state.batch_stats),
                      (back.params, state.params)):
        want = flatten_tree(want)
        got = flatten_tree(jax.tree.map(np.asarray, got))
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].tobytes() == want[k].tobytes(), k
    with pytest.raises(KeyError, match="batch_stats"):
        with open(jpath, "rb") as f:
            tree = msgpack_restore(f.read())
        tree["state"]["batch_stats"]["eabnet"]["en"]["extra"] = np.ones(2)
        other = tmp_path / "extra.ckpt"
        other.write_bytes(msgpack_serialize(tree))
        PC.load_checkpoint(str(other), pstate, None)


@pytest.mark.parametrize("files,want", [
    (["1.ckpt", "2.params", "2.ckpt", "notes.params"], "2.ckpt"),
    (["5.params", "3.ckpt"], "5.params"),
    (["4.pth", "4.params", "3.ckpt"], "4.pth"),
    (["10.ckpt", "9.ckpt", "10.pth"], "10.ckpt"),
    ([], None),
])
def test_latest_checkpoint_ranks_like_jax(tmp_path, files, want):
    for f in files:
        (tmp_path / f).write_bytes(b"")
    with pytest.warns() if want == "5.params" else nullcontext():
        ours = PC.latest_checkpoint(str(tmp_path))
    ref = JC.latest_checkpoint(str(tmp_path))
    name = lambda p: None if p is None else os.path.basename(p)  # noqa: E731
    assert name(ours) == name(ref) == want


def test_release_params_round_trip_exactly():
    path = os.path.join(ROOT, "release", "composed_9mic", "40000.params")
    tree = load_params(path)
    cfg = PExperimentConfig.load(os.path.join(ROOT, "release",
                                              "composed_9mic", "config.json"))
    back = flatten_tree(to_jax_params(load_jax_params(build_model(cfg.model),
                                                      tree)))
    ref = flatten_tree(tree)
    assert back.keys() == ref.keys() and len(ref) == 1313
    for k, v in ref.items():
        assert back[k].dtype == v.dtype and back[k].tobytes() == v.tobytes()

