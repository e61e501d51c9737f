"""The port's two kernel modules on the CPU: each plain version against the
JAX package's Pallas kernel (interpret mode, as tests/test_kernels.py and
tests/test_tcm_chain.py run it) and against the module path, at the JAX
kernel tests' forward tolerance of 2e-5; the wrappers' dispatch, counters
and argument checks. The CUDA kernels themselves are tested on the card
(tests/test_torch_gpu.py, chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eabnet_tpu.kernels.lstm_bf import lstm_bf_pallas
from eabnet_tpu.kernels.tcm_chain import tcm_chain_pallas
from eabnet_tpu.models.eabnet import LSTMBeamformer as JLSTMBeamformer
from eabnet_tpu.models.eabnet import _scan_head
from eabnet_tpu.nn.blocks import SqueezedTCNGroup as JGroup
from eabnet_tpu_torch.kernels.lstm_bf import (double_lstm,
                                              double_lstm_reference)
from eabnet_tpu_torch.kernels.tcm_chain import tcm_chain, tcm_chain_reference
from eabnet_tpu_torch.models.eabnet import LSTMBeamformer
from eabnet_tpu_torch.nn.blocks import SqueezedTCNGroup
from eabnet_tpu_torch.weights import load_jax_params

ATOL = 2e-5
B, T, D, C = 2, 33, 128, 64
CASES = [(True, 5, (1, 2, 4)), (False, 3, (1, 2, 5, 9))]
IDS = ["twin", "single"]


def tcm_setup(twin, kd1, dils, seed=0, d=D):
    """A flax-initialised group, its param tree, the port's group loaded
    from it, and a seeded input."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, d)).astype(np.float32)
    jg = JGroup(kd1, C, d, dils, twin_gate=twin)
    params = jax.tree.map(np.asarray,
                          jg.init(jax.random.key(seed), x)["params"])
    tg = load_jax_params(SqueezedTCNGroup(kd1, C, d, dils, twin_gate=twin),
                         params)
    return x, jg, params, tg


@pytest.mark.parametrize("twin,kd1,dils", CASES, ids=IDS)
def test_tcm_plain_matches_pallas_interpret(twin, kd1, dils):
    x, _, params, tg = tcm_setup(twin, kd1, dils)
    ref = np.asarray(tcm_chain_pallas(params, jnp.asarray(x), kd1, C, dils,
                                      twin, interpret=True))
    with torch.no_grad():
        ours = tcm_chain_reference(torch.from_numpy(x), tg.stacked_weights(),
                                   dils, twin).numpy()
    np.testing.assert_allclose(ours, ref, atol=ATOL)


@pytest.mark.parametrize("twin,kd1,dils", CASES, ids=IDS)
def test_tcm_wrapper_matches_module_chain(twin, kd1, dils):
    x, jg, params, tg = tcm_setup(twin, kd1, dils, seed=1)
    ref = np.asarray(jg.apply({"params": params}, x))
    with torch.no_grad():
        ours = tcm_chain(torch.from_numpy(x), tg.stacked_weights(), dils,
                         twin).numpy()
    np.testing.assert_allclose(ours, ref, atol=ATOL)


@pytest.mark.parametrize("twin,kd1,dils", CASES, ids=IDS)
def test_tcm_plain_matches_per_tcm_modules(twin, kd1, dils):
    """The chain == the port's own SqueezedTCM modules one after another."""
    x, _, _, tg = tcm_setup(twin, kd1, dils, seed=2)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        chain = tcm_chain_reference(xt, tg.stacked_weights(), dils, twin)
        for i in range(len(dils)):
            xt = getattr(tg, f"tcm_{i}")(xt)
    np.testing.assert_allclose(chain.numpy(), xt.numpy(), atol=ATOL)


def lstm_setup(l=23, t=17, c=16, h=8, m=3, seed=0):
    rng = np.random.default_rng(seed)
    x4 = rng.standard_normal((1, t, l, c)).astype(np.float32) * 0.5
    jhead = JLSTMBeamformer(embed_dim=c, M=m, hid_node=h)
    params = jax.tree.map(np.asarray,
                          jhead.init(jax.random.key(seed), x4)["params"])
    lanes = rng.standard_normal((l, t, c)).astype(np.float32) * 0.5
    return x4, jhead, params, lanes


def port_head(params, lanes):
    """The port's head on already-normalised lanes (L, T, C) -> (L, T, 2M),
    through the LSTM-BF wrapper."""
    p = {k: {n: torch.tensor(v) for n, v in params[k].items()}
         for k in ("rnn1", "rnn2", "fc1", "fc2")}
    r1, r2 = p["rnn1"], p["rnn2"]
    x = torch.from_numpy(lanes)
    xw1 = (x @ r1["w_ih"] + r1["b_ih"] + r1["b_hh"]).transpose(0, 1)
    h2 = double_lstm(xw1.contiguous(), r1["w_hh"], r2["w_ih"], r2["w_hh"],
                     r2["b_ih"] + r2["b_hh"]).transpose(0, 1)
    y = torch.relu(h2 @ p["fc1"]["kernel"] + p["fc1"]["bias"])
    return (y @ p["fc2"]["kernel"] + p["fc2"]["bias"]).numpy()


def test_lstm_plain_matches_pallas_interpret_and_scan():
    _, _, params, lanes = lstm_setup()
    sub = {k: params[k] for k in ("rnn1", "rnn2", "fc1", "fc2")}
    pallas = np.asarray(lstm_bf_pallas(sub, jnp.asarray(lanes),
                                       interpret=True))
    scan = np.asarray(_scan_head(sub, jnp.asarray(lanes)))
    ours = port_head(params, lanes)
    assert ours.shape == pallas.shape == (23, 17, 6)
    np.testing.assert_allclose(ours, pallas, atol=ATOL)
    np.testing.assert_allclose(ours, scan, atol=ATOL)


@pytest.mark.parametrize("seed", [0, 1])
def test_lstm_beamformer_module_matches(seed):
    x4, jhead, params, _ = lstm_setup(seed=seed)
    ref = np.asarray(jhead.apply({"params": params}, x4))  # (1, T, L, M, 2)
    head = load_jax_params(LSTMBeamformer(16, 3, 8), params)
    with torch.no_grad():
        ours = head(torch.from_numpy(x4).permute(0, 3, 1, 2)).numpy()
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, atol=ATOL)


def test_lstm_plain_matches_torch_lstm():
    """The plain version == torch.nn.LSTM(2 layers) fed x @ W_ih1 + b."""
    torch.manual_seed(0)
    lstm = torch.nn.LSTM(8, 16, num_layers=2)
    x = torch.randn(11, 5, 8)
    w_ih1, w_hh1 = lstm.weight_ih_l0.t(), lstm.weight_hh_l0.t()
    xw1 = x @ w_ih1 + lstm.bias_ih_l0 + lstm.bias_hh_l0
    with torch.no_grad():
        ref = lstm(x)[0]
        ours = double_lstm_reference(xw1, w_hh1, lstm.weight_ih_l1.t(),
                                     lstm.weight_hh_l1.t(),
                                     lstm.bias_ih_l1 + lstm.bias_hh_l1)
    np.testing.assert_allclose(ours.numpy(), ref.numpy(), atol=1e-6)


def _lstm_args(t=4, l=3, h=8):
    g = torch.Generator().manual_seed(0)
    return (torch.randn(t, l, 4 * h, generator=g),
            torch.randn(h, 4 * h, generator=g),
            torch.randn(h, 4 * h, generator=g),
            torch.randn(h, 4 * h, generator=g),
            torch.randn(4 * h, generator=g))


def _tcm_args():
    _, _, _, tg = tcm_setup(True, 5, (1, 2, 4))
    x = torch.randn(B, T, D, generator=torch.Generator().manual_seed(0))
    return x, tg.stacked_weights()


def test_cpu_tensors_take_the_plain_path_and_count_nothing():
    lstm0, tcm0 = double_lstm.launches, tcm_chain.launches
    with torch.no_grad():
        args = _lstm_args()
        np.testing.assert_array_equal(double_lstm(*args).numpy(),
                                      double_lstm_reference(*args).numpy())
        x, w = _tcm_args()
        np.testing.assert_array_equal(
            tcm_chain(x, w, (1, 2, 4), True).numpy(),
            tcm_chain_reference(x, w, (1, 2, 4), True).numpy())
    assert (double_lstm.launches, tcm_chain.launches) == (lstm0, tcm0)


def test_wrappers_refuse_bad_arguments():
    args = _lstm_args()
    with torch.no_grad():
        with pytest.raises(TypeError):
            double_lstm(*(a.double() for a in args))
        with pytest.raises(ValueError):
            double_lstm(args[0][..., :-1], *args[1:])
        with pytest.raises(ValueError):
            double_lstm(args[0], args[1][:-1], *args[2:])
        x, w = _tcm_args()
        with pytest.raises(TypeError):
            tcm_chain(x.double(), w, (1, 2, 4), True)
        with pytest.raises(ValueError):
            tcm_chain(x[0], w, (1, 2, 4), True)
        with pytest.raises(ValueError):  # three weights, two dilations
            tcm_chain(x, w, (1, 2), True)
    # a gradient request is served on the CPU by the plain version
    xw1 = args[0].clone().requires_grad_()
    double_lstm(xw1, *args[1:]).sum().backward()
    ref = torch.autograd.grad(
        double_lstm_reference(xw1, *args[1:]).sum(), xw1)[0]
    np.testing.assert_array_equal(xw1.grad.numpy(), ref.numpy())
