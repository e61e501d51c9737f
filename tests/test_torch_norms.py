"""The port's cumulative layer norm (with and without its virtual-frame
prior) and batch norm against the JAX package's flax modules on 1-D and
2-D maps, BN in evaluation and in training (the running-statistics
update); and the port's counterparts of tests/test_cln_stability.py.

JAX maps are channel-last with time on axis 1; the port's are
channel-first with time on dim 2. Tolerance 1e-5: float32 rounding of
differently ordered sums."""

import jax
import numpy as np
import pytest
import torch

from eabnet_tpu.nn import norms as jn
from eabnet_tpu_torch.nn import norms as tn
from eabnet_tpu_torch.weights import (load_jax_batch_stats, load_jax_params,
                                      to_jax_batch_stats)

ATOL = 1e-5
SHAPES = [(2, 9, 6), (2, 9, 7, 6)]
SHAPE_IDS = ["1d", "2d"]


def data(shape, seed=0, scale=3.0, shift=1.5):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale + shift).astype(np.float32)


def affine(c=6):
    return {"norm": {"scale": np.linspace(0.5, 2, c, dtype=np.float32),
                     "bias": np.linspace(-1, 1, c, dtype=np.float32)}}


def stats(c=6):
    return {"norm": {"mean": np.linspace(-0.5, 1.0, c, dtype=np.float32),
                     "var": np.linspace(0.5, 4.0, c, dtype=np.float32)}}


def port(x):
    return torch.from_numpy(x).movedim(-1, 1)


def channel_last(y):
    return y.detach().movedim(1, -1).numpy()


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
@pytest.mark.parametrize("norm", ["cLN", "cLN-ref"])
def test_cumulative_layer_norm_matches(norm, shape):
    x = data(shape)
    ref = np.asarray(jn.NormSwitch(norm, 6).apply({"params": affine()}, x))
    ours = load_jax_params(tn.NormSwitch(norm, 6), affine())
    np.testing.assert_allclose(channel_last(ours(port(x))), ref, atol=ATOL)


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_batch_norm_eval_matches(shape):
    x = data(shape)
    variables = {"params": affine(), "batch_stats": stats()}
    ref = np.asarray(jn.NormSwitch("BN", 6).apply(variables, x))
    ours = load_jax_batch_stats(load_jax_params(tn.NormSwitch("BN", 6),
                                                affine()), stats())
    ours.eval()
    np.testing.assert_allclose(channel_last(ours(port(x))), ref, atol=ATOL)


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_batch_norm_train_matches_and_moves_running_stats(shape):
    """Training mode: batch statistics (biased variance), and the running
    ones moved by 0.9 ra + 0.1 batch, as flax's mutable batch_stats (an
    unbiased update, torch.nn.BatchNorm's, would miss by 1/(n - 1))."""
    variables = {"params": affine(), "batch_stats": stats()}
    ours = load_jax_batch_stats(load_jax_params(tn.NormSwitch("BN", 6),
                                                affine()), stats())
    ours.train()
    for seed in range(2):  # two updates in a row
        x = data(shape, seed=seed)
        ref, mutated = jn.NormSwitch("BN", 6).apply(
            variables, x, True, mutable=["batch_stats"])
        variables = {"params": affine(), **mutated}
        np.testing.assert_allclose(channel_last(ours(port(x))),
                                   np.asarray(ref), atol=ATOL)
        want = jax.tree.map(np.asarray, mutated["batch_stats"])
        got = to_jax_batch_stats(ours)
        for k in ("mean", "var"):
            np.testing.assert_allclose(got["norm"][k], want["norm"][k],
                                       rtol=1e-6, atol=1e-7)


def test_norm_switch_names_the_norm_one_level_down():
    for norm in ("IN", "cLN", "cLN-ref", "BN"):
        names = {n for n, _ in tn.NormSwitch(norm, 4).named_parameters()}
        assert names == {"norm.scale", "norm.bias"}
    assert {n for n, _ in tn.NormSwitch("BN", 4).named_buffers()} == {
        "norm.mean", "norm.var"}


def test_deep_cln_stack_gradients_finite_with_constant_first_frame():
    """tests/test_cln_stability.py's first case on the port: the prior
    bounds 1/sigma at a constant first frame, so ten stacked cLNs keep
    their input gradient bounded."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 32, 64)).astype(np.float32)
    x[:, 0, :] = 0.7
    xt = port(x).requires_grad_()
    h = xt
    for _ in range(10):
        h = tn.CumulativeLayerNorm(64)(h)
    torch.mean(torch.square(h)).backward()
    g = xt.grad
    assert torch.isfinite(g).all()
    assert g.abs().max().item() < 1e4


def test_cln_matches_plain_statistics_late_in_time():
    """The prior decays: late frames take the true statistics."""
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((1, 2000, 64)) * 3 + 1).astype(np.float32)
    with torch.no_grad():
        y = channel_last(tn.CumulativeLayerNorm(64)(port(x)))
    flat = x[0].reshape(-1)
    expect = (x[0, -1] - flat.mean()) / flat.std()
    np.testing.assert_allclose(y[0, -1], expect, atol=5e-3)


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_prelu_matches_flax_with_and_without_autograd(shape):
    """PReLU takes one launch when autograd does not record; its values
    are the same bits as the recorded form's, and both are flax's."""
    x = data(shape, shift=0.0)
    x[0, 0] = 0.0
    alpha = np.linspace(-0.3, 0.6, 6, dtype=np.float32)
    ref = np.asarray(jn.PReLU(6).apply({"params": {"alpha": alpha}}, x))
    ours = load_jax_params(tn.PReLU(6), {"alpha": alpha})
    recorded = ours(port(x).requires_grad_())
    with torch.no_grad():
        plain = ours(port(x))
    np.testing.assert_array_equal(channel_last(plain),
                                  channel_last(recorded))
    np.testing.assert_allclose(channel_last(plain), ref, atol=ATOL)


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
@pytest.mark.parametrize("norm", ["cLN", "cLN-ref"])
def test_cumulative_layer_norm_steps_frame_by_frame(norm, shape):
    """Inside ``stepping`` the norm takes one frame and carries (count,
    sum, sum of squares): frame by frame it gives the offline output."""
    from eabnet_tpu_torch.nn.stepping import Frame, stepping

    x = port(data(shape, seed=3))
    ours = load_jax_params(tn.NormSwitch(norm, 6), affine())
    names = {m: n for n, m in ours.named_modules()}
    state, outs = None, []
    with torch.no_grad():
        offline = ours(x)
        for t in range(x.shape[2]):
            fr = Frame(names, state)
            with stepping(fr):
                outs.append(ours(x[:, :, t:t + 1]))
            state = fr.new  # the first frame starts from the prior
    np.testing.assert_allclose(torch.cat(outs, dim=2).numpy(),
                               offline.numpy(), atol=ATOL)
