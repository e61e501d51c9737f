"""The port's pure-Python reader of the JAX package's msgpack checkpoints
against flax.serialization.msgpack_restore, leaf for leaf and bit for bit,
and the port's config loader against the JAX package's."""

import dataclasses
import os

import numpy as np
import pytest
from flax import serialization

from eabnet_tpu.config import ExperimentConfig as JExperimentConfig
from eabnet_tpu_torch import checkpoint
from eabnet_tpu_torch.config import (EaBNetConfig, ExperimentConfig,
                                     GaGNetConfig)
from eabnet_tpu_torch.weights import flatten_tree

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RELEASES = ["composed_9mic", "eabnet_9mic_cln"]


@pytest.mark.parametrize("name", RELEASES)
def test_reader_matches_flax_bit_for_bit(name):
    path = checkpoint.latest_checkpoint(os.path.join(ROOT, "release", name))
    with open(path, "rb") as f:
        data = f.read()
    ours = flatten_tree(checkpoint.msgpack_restore(data))
    ref = flatten_tree(serialization.msgpack_restore(data))
    assert ours.keys() == ref.keys() and len(ours) == 1313
    for k, v in ref.items():
        assert ours[k].dtype == v.dtype and ours[k].shape == v.shape, k
        assert ours[k].tobytes() == v.tobytes(), k


def test_reader_decodes_every_type_flax_writes():
    tree = {"a": np.arange(6, dtype=np.int32).reshape(2, 3),
            "b": {"c": np.float32(1.5), "d": np.zeros((0, 4), np.float64)},
            "e": [1, -3, 300, -70000, 2 ** 40, 1.25, True, False, None],
            "s": "x" * 40, "t": b"\x00\x01", "big": list(range(20)),
            "f": np.linspace(-1, 1, 70000, dtype=np.float32)}
    ours = checkpoint.msgpack_restore(serialization.msgpack_serialize(tree))
    np.testing.assert_array_equal(ours["a"], tree["a"])
    assert ours["b"]["c"] == np.float32(1.5)
    assert ours["b"]["d"].shape == (0, 4)
    assert ours["e"] == tree["e"] and ours["s"] == tree["s"]
    assert ours["t"] == tree["t"] and ours["big"] == tree["big"]
    np.testing.assert_array_equal(ours["f"], tree["f"])


def test_reader_decodes_bfloat16_as_flax_does():
    """A bf16 tree written by flax.serialization (arrays and a scalar,
    with inf, nan and -0) decodes to float32 arrays of flax's values,
    exactly: a bf16 value is the high half of that float32."""
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    tree = {"w": np.asarray(jnp.asarray(rng.standard_normal((3, 70)),
                                        jnp.bfloat16)),
            "edge": np.asarray(jnp.asarray([np.inf, -np.inf, np.nan, -0.0,
                                            1e-40, 3.0e38], jnp.bfloat16)),
            "s": np.asarray(jnp.bfloat16(-1.5))[()],
            "n": {"empty": np.asarray(jnp.zeros((0, 2), jnp.bfloat16))}}
    data = serialization.msgpack_serialize(tree)
    ours = flatten_tree(checkpoint.msgpack_restore(data))
    ref = flatten_tree(serialization.msgpack_restore(data))
    assert ours.keys() == ref.keys()
    for k, v in ref.items():
        assert ours[k].dtype == np.float32 and ours[k].shape == v.shape, k
        np.testing.assert_array_equal(ours[k], np.asarray(v, np.float32),
                                      err_msg=k)
        # bit for bit, -0 and nan included
        assert ours[k].tobytes() == np.asarray(v, np.float32).tobytes(), k


def test_reader_rejects_damaged_data():
    data = serialization.msgpack_serialize({"w": np.ones(8, np.float32)})
    with pytest.raises(ValueError):
        checkpoint.msgpack_restore(data[:-3])
    with pytest.raises(ValueError):
        checkpoint.msgpack_restore(data + b"\x00")


def test_load_params_from_params_and_ckpt(tmp_path):
    params = {"eabnet": {"w": np.ones((2, 3), np.float32)}}
    (tmp_path / "10.params").write_bytes(
        serialization.msgpack_serialize({"params": params}))
    (tmp_path / "10.ckpt").write_bytes(serialization.msgpack_serialize(
        {"state": {"step": np.int32(10), "params": params}, "epoch": 1}))
    (tmp_path / "9.ckpt").write_bytes(b"")
    (tmp_path / "notes.params").write_bytes(b"")
    best = checkpoint.latest_checkpoint(str(tmp_path))
    assert os.path.basename(best) == "10.ckpt"  # .ckpt wins a tie
    for name in ("10.params", "10.ckpt"):
        got = checkpoint.load_params(str(tmp_path / name))
        np.testing.assert_array_equal(got["eabnet"]["w"], params["eabnet"]["w"])
    with pytest.raises(ValueError):  # a .pth is converted for a config
        checkpoint.load_params(str(tmp_path / "1.pth"))
    assert checkpoint.latest_checkpoint(str(tmp_path / "empty")) is None


@pytest.mark.parametrize("name", RELEASES)
def test_release_configs_load_like_jax(name):
    path = os.path.join(ROOT, "release", name, "config.json")
    ours, ref = ExperimentConfig.load(path), JExperimentConfig.load(path)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)


def test_config_refuses_unknown_values():
    with pytest.raises(ValueError):
        EaBNetConfig(norm_type="LN")
    with pytest.raises(ValueError):
        GaGNetConfig(acti_type="gelu")
