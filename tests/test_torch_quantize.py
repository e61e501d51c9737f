"""Weights-only int8 serving in the port (utils/quantize.py and
Enhancer(compute_dtype="int8w")) against the JAX package's
(eabnet_tpu/utils/quantize.py), on the CPU."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eabnet_tpu.config import (ComposedConfig as JComposed,
                               EaBNetConfig as JEaB,
                               ExperimentConfig as JExperimentConfig,
                               GaGNetConfig as JGaG)
from eabnet_tpu.utils import quantize as jq
from eabnet_tpu_torch.checkpoint import latest_checkpoint, load_params
from eabnet_tpu_torch.config import ExperimentConfig
from eabnet_tpu_torch.inference import Enhancer
from eabnet_tpu_torch.models import build_model
from eabnet_tpu_torch.utils import quantize as tq
from eabnet_tpu_torch.weights import flatten_tree, from_jax_tree

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXP = os.path.join(ROOT, "release", "composed_9mic")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for the port: on a host that other test workers
    load, more threads mostly wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def release():
    cfg = ExperimentConfig.load(os.path.join(EXP, "config.json"))
    return cfg, load_params(latest_checkpoint(EXP))


def small_tree():
    rng = np.random.default_rng(0)
    return {
        "conv": {"kernel": rng.standard_normal((3, 3, 8, 16)).astype(
            np.float32) * 0.1,
                 "bias": rng.standard_normal(16).astype(np.float32)},
        "norm": {"gain": np.ones(8, np.float32)},
        "zero": {"kernel": np.zeros((4, 5), np.float32)},
    }


def test_quantize_roundtrip_error_bound():
    """tests/test_quantize.py's round trip, in the port."""
    params = small_tree()
    packed = tq.quantize_weights_int8(params)
    assert packed["conv"]["kernel"]["w"].dtype == np.int8
    assert packed["conv"]["bias"]["w"].dtype == np.float32  # 1-D kept
    k = params["conv"]["kernel"]
    back = tq.dequantize(torch.from_numpy(packed["conv"]["kernel"]["w"]),
                         torch.from_numpy(packed["conv"]["kernel"]["s"]),
                         torch.float32).numpy()
    absmax = np.abs(k).max(axis=(0, 1, 2))
    assert np.all(np.abs(back - k) <= absmax / 254.0 + 1e-7)
    bias = packed["conv"]["bias"]
    np.testing.assert_array_equal(
        tq.dequantize(torch.from_numpy(bias["w"]),
                      torch.tensor(bias["s"]), torch.float32).numpy(),
        params["conv"]["bias"])
    # an all-zero kernel gets scale 1 and stays zero
    np.testing.assert_array_equal(packed["zero"]["kernel"]["s"], 1.0)
    f32_bytes = sum(v.nbytes for v in flatten_tree(params).values())
    assert tq.packed_nbytes(packed) < 0.45 * f32_bytes


def test_quantize_matches_jax_leaf_for_leaf(release):
    _, params = release
    ours = flatten_tree(tq.quantize_weights_int8(params))
    ref = flatten_tree(jax.tree.map(np.asarray,
                                    jq.quantize_weights_int8(params)))
    assert ours.keys() == ref.keys()
    for k, v in ref.items():
        assert ours[k].dtype == v.dtype and ours[k].shape == v.shape, k
        assert ours[k].tobytes() == v.tobytes(), k
    assert tq.packed_nbytes(tq.quantize_weights_int8(params)) == \
        jq.packed_nbytes(jq.quantize_weights_int8(params))


def test_dequantized_release_weights_equal_jax_bit_for_bit(release):
    """Every parameter of the released model, packed, mapped to the
    port's layout and dequantized to bf16, equals the JAX package's
    dequantized bf16 parameter mapped the same way, bit for bit."""
    cfg, params = release
    model = build_model(cfg.model)
    ours = tq.PackedWeights(tq.pack_for_module(
        model, tq.quantize_weights_int8(params)), "cpu").dequantize(
            torch.bfloat16)
    ref_tree = jq.dequantize_weights(jq.quantize_weights_int8(params),
                                     jnp.bfloat16)
    # bf16 -> float32 is exact, and the layout change only moves values
    ref = from_jax_tree(model, jax.tree.map(
        lambda a: np.asarray(a.astype(jnp.float32)), ref_tree))
    assert ours.keys() == ref.keys()
    n_int8 = 0
    for name, r in ref.items():
        assert ours[name].dtype == torch.bfloat16
        np.testing.assert_array_equal(ours[name].float().numpy(), r,
                                      err_msg=name)
        n_int8 += ours[name].dim() >= 2
    assert n_int8 > 100


def test_packed_weights_dequantize_in_few_groups_as_each_parameter(release):
    """The resident form dequantizes the released model in a few
    broadcast multiplies, and every parameter equals ``dequantize`` of its
    own packed values, bit for bit, in its own shape."""
    cfg, params = release
    model = build_model(cfg.model)
    packed = tq.pack_for_module(model, tq.quantize_weights_int8(params))
    resident = tq.PackedWeights(packed, "cpu")
    assert resident.n_groups() <= 40, resident.n_groups()
    n_int8 = sum(q.dtype == torch.int8 for q, _ in packed.values())
    assert n_int8 > 10 * resident.n_groups()
    got = resident.dequantize(torch.bfloat16)
    assert got.keys() == packed.keys()
    for name, (q, s) in packed.items():
        ref = tq.dequantize(q, s, torch.bfloat16)
        assert got[name].shape == ref.shape, name
        assert torch.equal(got[name], ref), name


def test_packed_release_is_under_045_of_float32(release):
    cfg, params = release
    packed = tq.quantize_weights_int8(params)
    f32_bytes = sum(v.nbytes for v in flatten_tree(params).values())
    assert tq.packed_nbytes(packed) < 0.45 * f32_bytes
    enh = Enhancer(cfg, params, compute_dtype="int8w", device="cpu")
    assert enh.param_bytes() == tq.packed_nbytes(packed)
    # the model's own parameters hold no values: only the packed ones do
    assert all(p.device.type == "meta" for p in enh.model.parameters())


def test_pack_for_module_refuses_another_tree(release):
    cfg, params = release
    model = build_model(cfg.model)
    tree = dict(params)
    tree["extra"] = {"kernel": np.ones((2, 2), np.float32)}
    with pytest.raises(KeyError):
        tq.pack_for_module(model, tq.quantize_weights_int8(tree))


def tiny_cfg(norm):
    return JExperimentConfig(model=JComposed(
        eabnet=JEaB(M=3, c=16, embed_dim=16, cd1=16, p=2, q=1,
                    norm_type=norm),
        gagnet=JGaG(c=12, cd1=12, p=1, q=1, dilas=(1, 2), norm_type=norm)))


def snr_db(ref, est):
    with np.errstate(divide="ignore"):  # identical signals: +inf dB
        return 10 * np.log10(np.sum(ref ** 2) / np.sum((ref - est) ** 2))


@pytest.mark.parametrize("norm", ["cLN", "IN"])
def test_int8w_enhancer_against_jax(norm):
    """The port's int8w Enhancer against the JAX package's int8w Enhancer
    by the model-level rule with R of bf16 (tests/test_torch_lowp.py), and
    against the port's own float32 output by tests/test_quantize.py's
    criteria (relative error < 0.15, correlation > 0.99)."""
    from eabnet_tpu.inference import Enhancer as JEnhancer
    from eabnet_tpu.train.step import create_train_state

    jcfg = tiny_cfg(norm)
    _, state = create_train_state(jcfg, jax.random.key(0))
    params = jax.tree.map(np.asarray, state.params)
    cfg = ExperimentConfig.from_dict(json.loads(jcfg.to_json()))
    rng = np.random.default_rng(5)
    wav = (rng.standard_normal((3, 8000)) * 0.05).astype(np.float32)
    j = {d: np.asarray(JEnhancer(jcfg, params, compute_dtype=d)(wav))
         for d in ("float32", "bfloat16", "int8w")}
    ours = {d: Enhancer(cfg, params, compute_dtype=d, device="cpu")(wav)
            for d in ("float32", "int8w")}
    r = snr_db(j["float32"], j["bfloat16"])
    assert snr_db(j["int8w"], ours["int8w"]) >= r - 6.0
    err = np.linalg.norm(ours["int8w"] - ours["float32"]) / (
        np.linalg.norm(ours["float32"]) + 1e-12)
    assert err < 0.15, err
    assert np.corrcoef(ours["int8w"], ours["float32"])[0, 1] > 0.99
