"""The port's losses against the JAX package's: values and gradients, with
exactly-zero bins (no NaN gradient) and a frame mask for short items."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eabnet_tpu.losses import losses as J
from eabnet_tpu_torch import losses as P

B, T, F = 3, 11, 7


def _spectra(seed, zero_frames=0):
    rng = np.random.default_rng(seed)
    esti = rng.standard_normal((B, T, F, 2)).astype(np.float32)
    label = rng.standard_normal((B, T, F, 2)).astype(np.float32)
    if zero_frames:  # zero-padded frames: the estimate is exactly 0 there
        esti[-1, -zero_frames:] = 0.0
        label[-1, -zero_frames:] = 0.0
    esti[0, 0, 0] = 0.0  # one exactly-zero bin inside the mask
    return esti, label


def test_frame_mask():
    counts = np.array([11, 4, 0], np.int32)
    np.testing.assert_array_equal(
        P.frame_mask(torch.from_numpy(counts), T).numpy(),
        np.asarray(J.frame_mask(counts, T)))


def test_safe_mag_value_and_zero_gradient():
    x = np.array([[0.0, 0.0], [3.0, 4.0], [-1e-3, 2e-3]], np.float32)
    xt = torch.tensor(x, requires_grad=True)
    mag = P.safe_mag(xt)
    np.testing.assert_array_equal(mag.detach().numpy(),
                                  np.asarray(J.safe_mag(x)))
    mag.sum().backward()
    ref = jax.grad(lambda v: jnp.sum(J.safe_mag(v)))(x)
    assert np.isfinite(xt.grad.numpy()).all()
    np.testing.assert_array_equal(xt.grad.numpy()[0], [0.0, 0.0])
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(ref), rtol=1e-6)


@pytest.mark.parametrize("zero_frames", [0, 4], ids=["full", "short"])
def test_composite_loss_values_and_gradients(zero_frames):
    esti0, label = _spectra(0, zero_frames)
    stages = [_spectra(s, zero_frames)[0] for s in (1, 2, 3)]
    counts = np.array([T, T, T - zero_frames], np.int32)
    mask = np.asarray(J.frame_mask(counts, T))

    def jloss(e0, e1):
        out = J.eabnet_with_postnet_loss(
            {"esti0": e0, "esti1": list(e1)}, label, mask)
        return out["final"], out

    (_, jl), (jg0, jg1) = jax.value_and_grad(jloss, argnums=(0, 1),
                                             has_aux=True)(esti0, stages)
    t0 = torch.tensor(esti0, requires_grad=True)
    t1 = [torch.tensor(s, requires_grad=True) for s in stages]
    pl = P.eabnet_with_postnet_loss({"esti0": t0, "esti1": t1},
                                    torch.from_numpy(label),
                                    torch.from_numpy(mask))
    pl["final"].backward()
    for k in ("eabnet", "postnet", "final"):
        np.testing.assert_allclose(float(pl[k]), float(jl[k]), rtol=1e-6)
    assert np.isfinite(t0.grad.numpy()).all()
    np.testing.assert_allclose(t0.grad.numpy(), np.asarray(jg0), rtol=1e-5,
                               atol=1e-9)
    for a, b in zip(t1, jg1):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-9)
    if zero_frames:  # masked frames get no gradient at all
        assert not t0.grad[-1, -zero_frames:].any()
