"""Gradients of the port's two kernel modules on the CPU.

Each backward's plain version (``double_lstm_bwd_reference``,
``tcm_chain_bwd_reference``: explicit reverse walks, not autograd) is held
against autograd of the plain forward, and both against the JAX package's
``jax.grad`` of its Pallas kernels in interpret mode, at the shapes and
tolerances of tests/test_kernels.py (LSTM: input 3e-5, params 5e-5, rtol
1e-4) and tests/test_tcm_chain.py (6e-5, rtol 1e-3). The CUDA backward
kernels are held against these plain versions on the card
(tests/test_torch_gpu.py, chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eabnet_tpu.kernels.lstm_bf import lstm_bf_pallas
from eabnet_tpu.models.eabnet import LSTMBeamformer as JLSTMBeamformer
from eabnet_tpu.nn.blocks import SqueezedTCNGroup as JGroup
from eabnet_tpu_torch.kernels.lstm_bf import (double_lstm,
                                              double_lstm_bwd_reference,
                                              double_lstm_reference,
                                              double_lstm_states_reference)
from eabnet_tpu_torch.kernels.tcm_chain import (tcm_chain,
                                                tcm_chain_bwd_reference,
                                                tcm_chain_reference)
from eabnet_tpu_torch.nn.blocks import SqueezedTCNGroup
from eabnet_tpu_torch.weights import flatten_tree, load_jax_params, to_jax_tree

LSTM_X_ATOL, LSTM_P_ATOL, LSTM_RTOL = 3e-5, 5e-5, 1e-4
TCM_ATOL, TCM_RTOL = 6e-5, 1e-3


class _PlainLSTM(torch.autograd.Function):
    """The recurrence with the plain backward walk as its gradient: the
    structure of the CUDA autograd Function, on the CPU."""

    @staticmethod
    def forward(ctx, xw1, w_hh1, w_ih2, w_hh2, b2):
        states = double_lstm_states_reference(xw1, w_hh1, w_ih2, w_hh2, b2)
        ctx.save_for_backward(xw1, w_hh1, w_ih2, w_hh2, b2, *states)
        return states[2]

    @staticmethod
    def backward(ctx, dy):
        xw1, w_hh1, w_ih2, w_hh2, b2, h1, c1, h2, c2 = ctx.saved_tensors
        return double_lstm_bwd_reference(xw1, dy, h1, c1, h2, c2, w_hh1,
                                         w_ih2, w_hh2, b2)


@pytest.mark.parametrize("t,l,h", [(7, 5, 8), (4, 23, 16), (1, 3, 4)])
def test_lstm_bwd_reference_matches_autograd(t, l, h):
    g = torch.Generator().manual_seed(t * l)
    args = [torch.randn(t, l, 4 * h, generator=g, dtype=torch.float64)] + [
        torch.randn(*s, generator=g, dtype=torch.float64) * 0.3
        for s in ((h, 4 * h), (h, 4 * h), (h, 4 * h), (4 * h,))]
    for a in args:
        a.requires_grad_()
    out = double_lstm_reference(*args)
    dy = torch.randn(out.shape, generator=g, dtype=torch.float64)
    ref = torch.autograd.grad(out, args, dy)
    with torch.no_grad():
        states = double_lstm_states_reference(*args)
        ours = double_lstm_bwd_reference(args[0], dy, *states, *args[1:])
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-10,
                                   atol=1e-12)


def _jax_head(l, t, c, h, m, seed):
    head = JLSTMBeamformer(embed_dim=c, M=m, hid_node=h)
    rng = np.random.default_rng(seed)
    x4 = rng.standard_normal((1, t, l, c)).astype(np.float32) * 0.5
    params = head.init(jax.random.key(0), jnp.asarray(x4))["params"]
    sub = {k: jax.tree.map(np.asarray, params[k])
           for k in ("rnn1", "rnn2", "fc1", "fc2")}
    lanes = rng.standard_normal((l, t, c)).astype(np.float32) * 0.5
    cot = rng.standard_normal((l, t, 2 * m)).astype(np.float32)
    return sub, lanes, cot


def _port_head_grads(sub, lanes, cot, lstm):
    """Gradients of sum(head(lanes) * cot) through the port's recurrence
    ``lstm`` on the CPU, in the JAX layout of ``sub``."""
    p = {k: {n: torch.tensor(v, requires_grad=True) for n, v in d.items()}
         for k, d in sub.items()}
    x = torch.tensor(lanes, requires_grad=True)
    r1, r2 = p["rnn1"], p["rnn2"]
    xw1 = (x @ r1["w_ih"] + r1["b_ih"] + r1["b_hh"]).transpose(0, 1)
    h2 = lstm(xw1.contiguous(), r1["w_hh"], r2["w_ih"], r2["w_hh"],
              r2["b_ih"] + r2["b_hh"]).transpose(0, 1)
    y = torch.relu(h2 @ p["fc1"]["kernel"] + p["fc1"]["bias"])
    y = y @ p["fc2"]["kernel"] + p["fc2"]["bias"]
    torch.sum(y * torch.from_numpy(cot)).backward()
    return ({k: {n: v.grad.numpy() for n, v in d.items()}
             for k, d in p.items()}, x.grad.numpy())


@pytest.mark.parametrize("l,t", [(19, 13), (23, 9)], ids=["l19", "l23"])
@pytest.mark.parametrize("route", ["autograd", "bwd_reference"])
def test_lstm_grads_match_jax_pallas_interpret(l, t, route):
    """The shapes of tests/test_kernels.py's gradient and lane-blocking
    tests (23 lanes: the JAX kernel pads them to its lane block)."""
    c, h, m = 16, 8, 3
    sub, lanes, cot = _jax_head(l, t, c, h, m, seed=3)

    def loss(p, x):
        return jnp.sum(lstm_bf_pallas(p, x, interpret=True) * cot)

    ref_gp, ref_gx = jax.grad(loss, argnums=(0, 1))(sub, jnp.asarray(lanes))
    lstm = double_lstm if route == "autograd" else _PlainLSTM.apply
    got_gp, got_gx = _port_head_grads(sub, lanes, cot, lstm)
    np.testing.assert_allclose(got_gx, np.asarray(ref_gx), atol=LSTM_X_ATOL,
                               rtol=LSTM_RTOL)
    ref_flat = flatten_tree(jax.tree.map(np.asarray, ref_gp))
    got_flat = flatten_tree(got_gp)
    assert ref_flat.keys() == got_flat.keys()
    for k, v in ref_flat.items():
        np.testing.assert_allclose(got_flat[k], v, atol=LSTM_P_ATOL,
                                   rtol=LSTM_RTOL, err_msg=k)


def _tcm_weights(twin, k, dils, d=16, c=8, seed=0):
    g = torch.Generator().manual_seed(seed)
    p = len(dils)
    w = [torch.randn(p, d, c, generator=g) * 0.3,
         torch.randn(p, k, c, c, generator=g) * 0.3,
         torch.randn(p, k, c, c, generator=g) * 0.3,
         torch.randn(p, c, d, generator=g) * 0.3,
         torch.rand(p, 3, c, generator=g) * 0.5,
         torch.rand(p, 3, c, generator=g) + 0.5,
         torch.randn(p, 3, c, generator=g) * 0.3]
    if not twin:  # row 1 and wr duplicate branch L, as stacked_weights does
        w[2] = w[1].clone()
        for i in (4, 5, 6):
            w[i][:, 1] = w[i][:, 0]
    return [v.double() for v in w]


@pytest.mark.parametrize("twin,k,dils", [(True, 5, (1, 2, 4)),
                                         (False, 3, (1, 2, 5))],
                         ids=["twin", "single"])
def test_tcm_bwd_reference_matches_autograd(twin, k, dils):
    w = _tcm_weights(twin, k, dils)
    x = torch.randn(2, 11, 16, generator=torch.Generator().manual_seed(1),
                    dtype=torch.float64, requires_grad=True)
    for v in w:
        v.requires_grad_()
    y = tcm_chain_reference(x, tuple(w), dils, twin)
    dy = torch.randn(y.shape, generator=torch.Generator().manual_seed(2),
                     dtype=torch.float64)
    ref = torch.autograd.grad(y, [x] + w, dy, allow_unused=True)
    with torch.no_grad():
        dx, dw = tcm_chain_bwd_reference(x, dy, tuple(w), dils, twin)
    np.testing.assert_allclose(dx.numpy(), ref[0].numpy(), rtol=1e-10,
                               atol=1e-12)
    for got, want in zip(dw, ref[1:]):
        want = torch.zeros_like(got) if want is None else want
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-10,
                                   atol=1e-12)
    if not twin:  # the duplicated rows carry no gradient
        assert not dw[2].any() and not dw[4][:, 1].any()
        assert not dw[5][:, 1].any() and not dw[6][:, 1].any()


@pytest.mark.parametrize("twin,k,dils", [(True, 5, (1, 2, 4)),
                                         (False, 3, (1, 2, 5))],
                         ids=["twin", "single"])
def test_tcm_activations_give_the_prelu_inputs_and_the_same_walk(twin, k,
                                                                  dils):
    """``prelu_inputs`` reads each TCM's PReLU inputs (h and the gate g)
    from the activations layout the backward kernel returns, and the plain
    reverse walk on those activations is the walk on its own forward."""
    from eabnet_tpu_torch.kernels.tcm_chain import (
        _forward_saves, prelu_inputs, tcm_chain_activations_reference)

    w = tuple(_tcm_weights(twin, k, dils))
    g = torch.Generator().manual_seed(3)
    x = torch.randn(2, 11, 16, generator=g, dtype=torch.float64)
    dy = torch.randn(2, 11, 16, generator=g, dtype=torch.float64)
    acts = tcm_chain_activations_reference(x, w, dils, twin)
    h, gate = prelu_inputs(acts, twin)
    _, saves = _forward_saves(x, w, dils, twin, None)
    np.testing.assert_allclose(h.numpy(),
                               torch.stack([s["h"] for s in saves]).numpy(),
                               rtol=0, atol=0)
    np.testing.assert_allclose(gate.numpy(),
                               torch.stack([s["g"] for s in saves]).numpy(),
                               rtol=1e-14, atol=1e-14)
    dx, dw = tcm_chain_bwd_reference(x, dy, w, dils, twin, acts=acts)
    rdx, rdw = tcm_chain_bwd_reference(x, dy, w, dils, twin)
    for got, want in zip((dx,) + dw, (rdx,) + rdw):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12,
                                   atol=1e-12)


class _PlainChain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dilations, twin, *weights):
        ctx.dilations, ctx.twin = dilations, twin
        ctx.save_for_backward(x, *weights)
        return tcm_chain_reference(x, weights, dilations, twin)

    @staticmethod
    def backward(ctx, dy):
        x, *weights = ctx.saved_tensors
        dx, dw = tcm_chain_bwd_reference(x, dy, tuple(weights),
                                         ctx.dilations, ctx.twin)
        return (dx, None, None) + dw


@pytest.mark.parametrize("route", ["autograd", "bwd_reference"])
@pytest.mark.parametrize("twin", [True, False], ids=["twin", "single"])
def test_tcm_grads_match_jax_pallas_interpret(twin, route):
    """tests/test_tcm_chain.py's gradient test: the JAX group with the
    Pallas kernel (interpret mode) against the port's group, whose
    parameter gradients flow through ``stacked_weights``; for the single
    branch this checks that the duplicated rows add nothing."""
    b, t, d, c, kd1, dils = 2, 33, 128, 64, 5, (1, 2, 4)
    x = np.random.default_rng(2).standard_normal((b, t, d)).astype(
        np.float32)
    jg = JGroup(kd1, c, d, dils, is_causal=True, norm_type="IN",
                twin_gate=twin, impl="pallas")
    params = jg.init(jax.random.key(1), jnp.asarray(x))["params"]
    wgt = np.cos(np.arange(b * t * d).reshape(b, t, d) * 0.01).astype(
        np.float32)

    def loss(p, inp):
        return jnp.sum(jg.apply({"params": p}, inp) * wgt)

    ref_gp, ref_gx = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))
    group = load_jax_params(SqueezedTCNGroup(kd1, c, d, dils, twin_gate=twin),
                            jax.tree.map(np.asarray, params))
    xt = torch.tensor(x, requires_grad=True)
    if route == "autograd":
        y = group(xt)
    else:
        y = _PlainChain.apply(xt, dils, twin, *group.stacked_weights())
    torch.sum(y * torch.from_numpy(wgt)).backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(ref_gx),
                               atol=TCM_ATOL, rtol=TCM_RTOL)
    got = flatten_tree(to_jax_tree(group, {n: p.grad for n, p in
                                           group.named_parameters()}))
    ref = flatten_tree(jax.tree.map(np.asarray, ref_gp))
    assert got.keys() == ref.keys()
    for k, v in ref.items():
        np.testing.assert_allclose(got[k], v, atol=TCM_ATOL, rtol=TCM_RTOL,
                                   err_msg=k)


def test_cpu_wrappers_differentiate_the_plain_versions():
    """On CPU tensors the wrappers are the plain versions, so their
    gradient is autograd's, and no kernel launch is counted."""
    counts = (double_lstm.launches, double_lstm.bwd_launches,
              tcm_chain.launches, tcm_chain.bwd_launches)
    w = _tcm_weights(True, 3, (1, 2))
    w = [v.float().requires_grad_() for v in w]
    x = torch.randn(1, 9, 16, requires_grad=True)
    torch.sum(tcm_chain(x, tuple(w), (1, 2), True) ** 2).backward()
    ref = torch.autograd.grad(
        torch.sum(tcm_chain_reference(x, tuple(w), (1, 2), True) ** 2), x)
    np.testing.assert_array_equal(x.grad.numpy(), ref[0].numpy())
    assert counts == (double_lstm.launches, double_lstm.bwd_launches,
                      tcm_chain.launches, tcm_chain.bwd_launches)
