"""The port's norms and blocks against the JAX package's flax modules: the
same flax-initialised parameters are loaded into the port through
weights.load_jax_params, the same seeded numpy input goes through both.

JAX maps are channel-last (B, T, F, C); the port's are channel-first
(B, C, T, F). Tolerance 1e-5 unless stated: float32 rounding of
differently ordered sums at these widths."""

import jax
import numpy as np
import pytest
import torch

from eabnet_tpu.nn import blocks as jb
from eabnet_tpu.nn import norms as jn
from eabnet_tpu_torch.nn import blocks as tb
from eabnet_tpu_torch.nn import norms as tn
from eabnet_tpu_torch.weights import load_jax_params

ATOL = 1e-5


def run_both(jmod, tmod, x_cl, *extra, atol=ATOL, channel_first=True):
    """Init jmod on x_cl (channel-last numpy), load its params into tmod,
    run both; compare in the channel-last layout."""
    variables = jmod.init(jax.random.key(0), x_cl, *extra)
    ref = np.asarray(jmod.apply(variables, x_cl, *extra))
    load_jax_params(tmod, jax.tree.map(np.asarray, variables["params"]))
    xt = torch.from_numpy(x_cl)
    if channel_first:
        xt = xt.movedim(-1, 1)
    with torch.no_grad():
        out = tmod(xt)
    if channel_first:
        out = out.movedim(1, -1)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, atol=atol)
    return variables


def data(shape, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def test_prelu_matches():
    jmod = jn.PReLU(6)
    tmod = tn.PReLU(6)
    variables = jmod.init(jax.random.key(0), data((2, 5, 6)))
    variables = {"params": {"alpha": np.linspace(-1, 1, 6, dtype=np.float32)}}
    x = data((2, 5, 7, 6))
    ref = np.asarray(jmod.apply(variables, x))
    load_jax_params(tmod, variables["params"])
    with torch.no_grad():
        out = tmod(torch.from_numpy(x).movedim(-1, 1)).movedim(1, -1)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL)


@pytest.mark.parametrize("shape", [(2, 9, 6), (2, 9, 7, 6)],
                         ids=["1d", "2d"])
def test_instance_norm_matches(shape):
    x = data(shape, scale=3.0) + 1.5
    jmod, tmod = jn.InstanceNorm(6), tn.InstanceNorm(6)
    params = {"scale": np.linspace(0.5, 2, 6, dtype=np.float32),
              "bias": np.linspace(-1, 1, 6, dtype=np.float32)}
    ref = np.asarray(jmod.apply({"params": params}, x))
    load_jax_params(tmod, params)
    with torch.no_grad():
        out = tmod(torch.from_numpy(x).movedim(-1, 1)).movedim(1, -1)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL)


def test_norm_switch_refuses_other_norms():
    tn.NormSwitch("IN", 4)
    for norm in ("cLN", "cLN-ref", "BN"):
        with pytest.raises(NotImplementedError):
            tn.NormSwitch(norm, 4)


@pytest.mark.parametrize("kernel", [(2, 3), (2, 5), (1, 3)])
def test_gate_conv2d_matches(kernel):
    x = data((2, 6, 21, 5))
    run_both(jb.GateConv2d(4, kernel, (1, 2)),
             tb.GateConv2d(5, 4, kernel, (1, 2)), x)


@pytest.mark.parametrize("kernel", [(2, 3), (2, 5), (1, 3)])
def test_gate_conv_transpose2d_matches(kernel):
    x = data((2, 6, 9, 5))
    run_both(jb.GateConvTranspose2d(4, kernel, (1, 2)),
             tb.GateConvTranspose2d(5, 4, kernel, (1, 2)), x)


def test_conv_units_match():
    x = data((2, 5, 19, 4))
    run_both(jb.Conv2dUnit((1, 3), 6, "IN"), tb.Conv2dUnit(4, (1, 3), 6, "IN"),
             x)
    run_both(jb.Deconv2dUnit((1, 3), 6, "IN"),
             tb.Deconv2dUnit(4, (1, 3), 6, "IN"), x)


@pytest.mark.parametrize("is_deconv", [False, True], ids=["conv", "deconv"])
@pytest.mark.parametrize("connect", ["cat", "add"])
def test_en_unet_module_matches(is_deconv, connect):
    x = data((2, 5, 39 if not is_deconv else 9, 6))
    run_both(jb.EnUnetModule(8, (2, 3), (1, 3), connect, "IN", 2,
                             is_deconv=is_deconv),
             tb.EnUnetModule(6, 8, (2, 3), (1, 3), connect, "IN", 2,
                             is_deconv=is_deconv), x)


def test_u2net_encoder_decoder_match():
    """Encoder at F=161 (-> 4 bins), then the decoder on its skips."""
    x = data((1, 4, 161, 18), scale=0.5)
    jen = jb.U2NetEncoder(8, (2, 3), (1, 3), "cat", "IN")
    ten = tb.U2NetEncoder(18, 8, (2, 3), (1, 3), "cat", "IN")
    v_en = jen.init(jax.random.key(1), x)
    feat, skips = jen.apply(v_en, x)
    load_jax_params(ten, jax.tree.map(np.asarray, v_en["params"]))
    with torch.no_grad():
        tfeat, tskips = ten(torch.from_numpy(x).movedim(-1, 1))
    np.testing.assert_allclose(tfeat.movedim(1, -1).numpy(),
                               np.asarray(feat), atol=ATOL)
    assert len(tskips) == len(skips) == 5
    for a, b in zip(tskips, skips):
        np.testing.assert_allclose(a.movedim(1, -1).numpy(), np.asarray(b),
                                   atol=ATOL)

    jde = jb.U2NetDecoder(16, 8, (2, 3), (1, 3), "cat", "IN")
    tde = tb.U2NetDecoder(16, 8, (2, 3), (1, 3), "cat", "IN")
    v_de = jde.init(jax.random.key(2), feat, skips)
    ref = np.asarray(jde.apply(v_de, feat, skips))
    load_jax_params(tde, jax.tree.map(np.asarray, v_de["params"]))
    with torch.no_grad():
        out = tde(tfeat, tskips).movedim(1, -1).numpy()
    assert out.shape == ref.shape == (1, 4, 161, 16)
    np.testing.assert_allclose(out, ref, atol=ATOL)


@pytest.mark.parametrize("twin,kd1,dil", [(True, 5, 4), (False, 3, 9)],
                         ids=["twin", "single"])
def test_squeezed_tcm_matches(twin, kd1, dil):
    x = data((2, 23, 32))
    run_both(jb.SqueezedTCM(kd1, 16, 32, dil, twin_gate=twin),
             tb.SqueezedTCM(kd1, 16, 32, dil, twin_gate=twin), x,
             channel_first=False)


@pytest.mark.parametrize("twin,kd1,dils", [(True, 5, (1, 2, 4)),
                                          (False, 3, (1, 2, 5, 9))],
                         ids=["twin", "single"])
def test_squeezed_tcn_group_matches(twin, kd1, dils):
    """The group as the port runs it (the TCM-chain wrapper's plain path
    on CPU) against the flax module chain."""
    x = data((2, 33, 128), seed=1)
    run_both(jb.SqueezedTCNGroup(kd1, 64, 128, dils, twin_gate=twin),
             tb.SqueezedTCNGroup(kd1, 64, 128, dils, twin_gate=twin), x,
             atol=2e-5, channel_first=False)


def test_tcn_group_refuses_non_causal():
    with pytest.raises(NotImplementedError):
        tb.SqueezedTCNGroup(3, 8, 16, (1, 2), is_causal=False)


def test_load_jax_params_refuses_partial_trees():
    jmod = jb.GateConv2d(4, (2, 3), (1, 2))
    params = jax.tree.map(np.asarray, jmod.init(
        jax.random.key(0), data((1, 3, 9, 5)))["params"])
    tmod = tb.GateConv2d(5, 4, (2, 3), (1, 2))
    load_jax_params(tmod, params)
    with pytest.raises(KeyError):
        load_jax_params(tmod, {"conv": {"kernel": params["conv"]["kernel"]}})
    with pytest.raises(KeyError):
        load_jax_params(tmod, {"conv": dict(params["conv"], extra=1.0)})
    with pytest.raises(ValueError):
        load_jax_params(tb.GateConv2d(6, 4, (2, 3), (1, 2)), params)
