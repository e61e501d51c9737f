"""The TCM chain at the squeezed widths the JAX package's configs and tests
run besides 64 (12, 16, 24: ``long_train --tiny``, the quality gate's
model, the mesh and freq tests), and the port's fresh initialisation.

- The plain chain against the JAX package's Pallas kernel in interpret
  mode for each causal IN group of those configs (widths 16 and 12, 24
  and 16), forward and gradients, at tests/test_tcm_chain.py's
  tolerances (2e-5; 6e-5 with rtol 1e-3).
- The CUDA kernels are built for C = 64 and take a narrower chain
  zero-padded to it (``kernels.tcm_chain.pad_weights``). That padding,
  applied to the plain version in float64, changes nothing: the output
  within 1e-6 of the unpadded chain, the gradients of the real entries
  within 1e-6 and those of the padded entries 0, by autograd and by the
  hand-written reverse walk (``crop_grads`` cuts them back).
- A fresh port model draws what ``model.init`` of the JAX package draws:
  every leaf of the same shape, Dense and conv kernels from flax's
  ``lecun_normal`` (spread within [0.9, 1.1] of the JAX draw's for leaves
  of 1,000 entries or more, every entry within its two-deviation cut),
  the LSTM's uniform leaves likewise, and the constant leaves equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eabnet_tpu.config import ComposedConfig as JComposed
from eabnet_tpu.config import EaBNetConfig as JEaB
from eabnet_tpu.config import GaGNetConfig as JGaG
from eabnet_tpu.models import EaBNetWithPostNet as JComposedNet
from eabnet_tpu.nn.blocks import SqueezedTCNGroup as JGroup
from eabnet_tpu_torch.config import (ComposedConfig, EaBNetConfig,
                                     GaGNetConfig)
from eabnet_tpu_torch.kernels.tcm_chain import (C_KERNEL, crop_grads,
                                                pad_weights,
                                                tcm_chain_bwd_reference,
                                                tcm_chain_reference)
from eabnet_tpu_torch.models import build_model
from eabnet_tpu_torch.nn.blocks import SqueezedTCNGroup
from eabnet_tpu_torch.weights import flatten_tree, to_jax_params, to_jax_tree

ATOL = 2e-5  # tests/test_tcm_chain.py, forward
GRAD_ATOL, GRAD_RTOL = 6e-5, 1e-3  # tests/test_tcm_chain.py, gradients
PAD_TOL = 1e-6
B, T, D = 2, 33, 128
B_PALLAS = 1  # the Pallas kernel's grid runs over the batch, one sample a step
WIDTHS = (12, 16, 24)
# the causal IN groups of the narrow configs: (C, twin, K, dilations)
GROUPS = {
    "tiny-eabnet": (16, True, 5, (1, 2)),  # tools/long_train.py --tiny
    "tiny-gagnet": (12, False, 3, (1, 2)),
    "gate-eabnet": (24, True, 5, (1, 2, 4)),  # tests/test_e2e_quality.py
    "gate-gagnet": (16, False, 3, (1, 2, 5)),
}
# (twin, K, dilations) of the padding tests: tests/test_tcm_chain.py's
FORMS = {"twin": (True, 5, (1, 2, 4)), "single": (False, 3, (1, 2, 5))}
# long_train --tiny (tools/long_train.py:209-210)
TINY_EAB = dict(M=9, c=16, embed_dim=16, cd1=16, p=2, q=1)
TINY_GAG = dict(c=12, cd1=12, p=1, q=1, dilas=(1, 2))
TRUNC = 0.87962566103423978  # std of a standard normal cut at +-2


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_group(twin, c, kd1, dils, seed):
    """The port's group of width c, drawn with its initialisers under a
    seed and its slopes, scales and biases moved off their init; its
    flax param tree; the JAX group through the Pallas kernel; and a
    seeded input."""
    torch.manual_seed(seed)
    tg = SqueezedTCNGroup(kd1, c, D, dils, twin_gate=twin)
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for p in tg.parameters():
            if p.dim() == 1:
                p.add_(torch.from_numpy(rng.standard_normal(
                    tuple(p.shape)).astype(np.float32) * 0.1))
    x = rng.standard_normal((B_PALLAS, T, D)).astype(np.float32)
    jg = JGroup(kd1, c, D, dils, is_causal=True, norm_type="IN",
                twin_gate=twin, impl="pallas")
    return x, jg, to_jax_params(tg), tg


@pytest.mark.parametrize("group", GROUPS)
def test_plain_chain_matches_pallas_at_width(group):
    """The group of a narrow config, forward and gradients: the JAX group
    through the Pallas kernel (interpret mode) against the port's group on
    the CPU (the plain chain, autograd of it; the parameter gradients flow
    through ``stacked_weights``), at tests/test_tcm_chain.py's
    tolerances."""
    c, twin, kd1, dils = GROUPS[group]
    x, jg, params, tg = jax_group(twin, c, kd1, dils, seed=c)
    wgt = np.cos(np.arange(B_PALLAS * T * D).reshape(B_PALLAS, T, D)
                 * 0.01).astype(np.float32)

    def forward_and_vjp(p, i):
        y, vjp = jax.vjp(lambda p, i: jg.apply({"params": p}, i), p, i)
        return y, vjp(jnp.asarray(wgt))

    # compiled: half the time of the eager interpreter
    ref_y, (ref_gp, ref_gx) = jax.jit(forward_and_vjp)(params,
                                                       jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    y = tg(xt)
    assert y.shape == ref_y.shape == (B_PALLAS, T, D)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(ref_y),
                               atol=ATOL)
    torch.sum(y * torch.from_numpy(wgt)).backward()
    got = flatten_tree(to_jax_params_grads(tg))
    want = flatten_tree(jax.tree.map(np.asarray, ref_gp))
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, atol=GRAD_ATOL, rtol=GRAD_RTOL,
                                   err_msg=k)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(ref_gx),
                               atol=GRAD_ATOL, rtol=GRAD_RTOL)


def to_jax_params_grads(module):
    """The module's parameter gradients in the flax layout."""
    return to_jax_tree(module, {n: p.grad for n, p in
                                module.named_parameters()})


def chain_weights(form, c, seed):
    """Seeded float64 weights of width c in the stacked layout, with slopes,
    scales and biases off their init (a single chain's row 1 and wr repeat
    branch L, as ``stacked_weights`` builds them)."""
    twin, k, dils = FORMS[form]
    g = torch.Generator().manual_seed(seed)
    p = len(dils)
    w = [torch.randn(p, D, c, generator=g) / D ** 0.5,
         torch.randn(p, k, c, c, generator=g) / (k * c) ** 0.5,
         torch.randn(p, k, c, c, generator=g) / (k * c) ** 0.5,
         torch.randn(p, c, D, generator=g) / c ** 0.5,
         torch.rand(p, 3, c, generator=g) * 0.5,
         torch.rand(p, 3, c, generator=g) + 0.5,
         torch.randn(p, 3, c, generator=g) * 0.3]
    if not twin:
        w[2] = w[1].clone()
        for i in (4, 5, 6):
            w[i][:, 1] = w[i][:, 0]
    return tuple(v.double() for v in w)


def test_pad_weights_keeps_64_and_pads_with_zeros():
    w64 = chain_weights("twin", C_KERNEL, 0)
    assert pad_weights(w64) is w64
    assert crop_grads(w64, w64)[0] is w64[0]
    w = chain_weights("twin", 12, 1)
    padded = pad_weights(w)
    assert [tuple(v.shape) for v in padded] == [
        (3, D, 64), (3, 5, 64, 64), (3, 5, 64, 64), (3, 64, D),
        (3, 3, 64), (3, 3, 64), (3, 3, 64)]
    assert all(v.is_contiguous() for v in padded)
    for got, v in zip(crop_grads(padded, w), w):
        assert torch.equal(got, v) and got.is_contiguous()
    for v, full in zip(w, padded):
        mask = torch.ones_like(full, dtype=torch.bool)
        mask[tuple(slice(0, n) for n in v.shape)] = False
        assert not full[mask].any()


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("c", WIDTHS)
def test_padding_to_the_kernel_width_is_exact(c, form):
    """The chain on ``pad_weights(w)`` is the chain on w (float64, the
    plain forward and both plain backwards): the output and the real
    gradient entries within 1e-6, the padded gradient entries 0."""
    twin, _, dils = FORMS[form]
    w = chain_weights(form, c, seed=c)
    g = torch.Generator().manual_seed(7 + c)
    x = torch.randn(B, T, D, generator=g, dtype=torch.float64)
    dy = torch.randn(B, T, D, generator=g, dtype=torch.float64)

    leaves = [v.clone().requires_grad_() for v in w]
    y = tcm_chain_reference(x, tuple(leaves), dils, twin)
    want = [torch.zeros_like(v) if r is None else r for v, r in zip(
        w, torch.autograd.grad(y, leaves, dy, allow_unused=True))]
    padded = [v.clone().requires_grad_() for v in pad_weights(w)]
    y_pad = tcm_chain_reference(x, tuple(padded), dils, twin)
    got = [torch.zeros_like(v) if r is None else r for v, r in zip(
        padded, torch.autograd.grad(y_pad, padded, dy, allow_unused=True))]
    assert (y_pad - y).abs().max().item() <= PAD_TOL
    for full, v, ref in zip(got, w, want):
        real = tuple(slice(0, n) for n in v.shape)
        assert (full[real] - ref).abs().max().item() <= PAD_TOL
        outside = torch.ones_like(full, dtype=torch.bool)
        outside[real] = False
        assert not full[outside].any()

    dx, dw = tcm_chain_bwd_reference(x, dy, w, dils, twin)
    dx_pad, dw_pad = tcm_chain_bwd_reference(x, dy, pad_weights(w), dils,
                                             twin)
    assert (dx_pad - dx).abs().max().item() <= PAD_TOL
    for a, b, full in zip(crop_grads(dw_pad, w), dw, dw_pad):
        assert a.shape == b.shape
        assert (a - b).abs().max().item() <= PAD_TOL
        outside = torch.ones_like(full, dtype=torch.bool)
        outside[tuple(slice(0, n) for n in b.shape)] = False
        assert not full[outside].any()


def leaf_kind(name):
    """How the JAX package initialises a leaf of its composed model."""
    last = name.rsplit(".", 1)[-1]
    if last in ("w_ih", "w_hh", "b_ih", "b_hh"):
        return "lstm"
    if last == "kernel":
        return "lecun"
    if last == "alpha":
        return 0.25
    if last == "scale":
        return 1.0
    return 0.0  # biases and norm shifts


def test_fresh_model_draws_what_the_jax_init_draws():
    """Every leaf of a fresh port model (the ``long_train --tiny`` config)
    against the JAX package's ``model.init``: the same shape; the spread
    within [0.9, 1.1] of the JAX draw's for leaves of 1,000 entries or
    more; every lecun kernel within its cut at two deviations, every LSTM
    leaf within its uniform bound; the constant leaves equal."""
    x = np.random.default_rng(0).standard_normal((1, 3, 161, 9, 2)).astype(
        np.float32)
    jm = JComposedNet(JComposed(eabnet=JEaB(**TINY_EAB),
                                gagnet=JGaG(**TINY_GAG)))
    # compiled: half the time of the eager init
    ref = flatten_tree(jax.tree.map(np.asarray, jax.jit(jm.init)(
        jax.random.key(0), x)["params"]))
    torch.manual_seed(0)
    model = build_model(ComposedConfig(eabnet=EaBNetConfig(**TINY_EAB),
                                       gagnet=GaGNetConfig(**TINY_GAG)))
    ours = flatten_tree(to_jax_params(model))
    assert sorted(ours) == sorted(ref)
    hid = EaBNetConfig(**TINY_EAB).hid_node
    checked = 0
    for name, want in ref.items():
        got = ours[name]
        assert got.shape == want.shape, name
        kind = leaf_kind(name)
        if isinstance(kind, float):
            assert np.all(want == kind), name
            assert np.all(got == kind), name
            continue
        if kind == "lecun":
            # flax's kernels are (..., in, out): fan_in = all but the last
            std = (1.0 / np.prod(want.shape[:-1])) ** 0.5 / TRUNC
            assert np.abs(got).max() <= 2 * std * (1 + 1e-6), name
            assert np.abs(want).max() <= 2 * std * (1 + 1e-6), name
        else:
            bound = 1.0 / hid ** 0.5
            assert np.abs(got).max() <= bound, name
            assert np.abs(want).max() <= bound, name
        if want.size >= 1000:
            ratio = got.std() / want.std()
            assert 0.9 <= ratio <= 1.1, (name, ratio)
            checked += 1
    assert checked >= 20
