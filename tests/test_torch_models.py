"""The port's EaBNet, GaGNet and composed model against the JAX package's
flax models at small widths (c, cd1, p, q, hid_node cut down; F = 161 as
the encoder's four frequency stages need), with the same flax-initialised
parameters and the same seeded numpy input. Tolerance 2e-4, that of the
reference goldens (tests/test_golden.py): float32 rounding through ~40
convs, norms and the recurrence."""

import jax
import numpy as np
import pytest
import torch

from eabnet_tpu.config import ComposedConfig as JComposed
from eabnet_tpu.config import EaBNetConfig as JEaB
from eabnet_tpu.config import GaGNetConfig as JGaG
from eabnet_tpu.models import EaBNet as JEaBNet
from eabnet_tpu.models import EaBNetWithPostNet as JComposedNet
from eabnet_tpu.models import GaGNet as JGaGNet
from eabnet_tpu_torch.config import (ComposedConfig, EaBNetConfig,
                                     GaGNetConfig)
from eabnet_tpu_torch.models import EaBNet, EaBNetWithPostNet, GaGNet
from eabnet_tpu_torch.weights import load_jax_batch_stats, load_jax_params

ATOL = 2e-4
B, T, F, M = 2, 13, 161, 3
EAB = dict(c=16, M=M, embed_dim=16, cd1=32, p=2, q=2, hid_node=16)
GAG = dict(c=16, cd1=32, p=1, q=2, dilas=(1, 2))


def inputs(seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((B, T, F, M, 2)).astype(np.float32) * 0.5


def params_of(model, *args):
    return jax.tree.map(np.asarray,
                        model.init(jax.random.key(0), *args)["params"])


def test_eabnet_matches_flax():
    x = inputs()
    jm = JEaBNet(JEaB(**EAB))
    params = params_of(jm, x)
    ref = np.asarray(jm.apply({"params": params}, x))
    tm = load_jax_params(EaBNet(EaBNetConfig(**EAB)), params)
    with torch.no_grad():
        ours = tm(torch.from_numpy(x)).numpy()
    assert ours.shape == ref.shape == (B, T, F, 2)
    np.testing.assert_allclose(ours, ref, atol=ATOL)


def test_eabnet_single_mic_4d_input_matches_flax():
    """A (B, T, F, 2) input is one mic: both packages add the mic axis."""
    cfg = dict(EAB, M=1)
    x = inputs(4)[..., 0, :]
    jm = JEaBNet(JEaB(**cfg))
    params = params_of(jm, x)
    ref = np.asarray(jm.apply({"params": params}, x))
    tm = load_jax_params(EaBNet(EaBNetConfig(**cfg)), params)
    with torch.no_grad():
        ours = tm(torch.from_numpy(x)).numpy()
    assert ours.shape == ref.shape == (B, T, F, 2)
    np.testing.assert_allclose(ours, ref, atol=ATOL)


@pytest.mark.parametrize("squeezed", [False, True],
                         ids=["separate", "squeezed"])
def test_gagnet_matches_flax(squeezed):
    x = inputs(1)
    spec, pre = x[..., 0, :], x[..., 1, :]
    jm = JGaGNet(JGaG(is_squeezed=squeezed, **GAG))
    params = params_of(jm, spec, pre)
    refs = jm.apply({"params": params}, spec, pre)
    tm = load_jax_params(GaGNet(GaGNetConfig(is_squeezed=squeezed, **GAG)),
                         params)
    with torch.no_grad():
        outs = tm(torch.from_numpy(spec), torch.from_numpy(pre))
    assert len(outs) == len(refs) == GAG["q"]
    for a, b in zip(outs, refs):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL)


def test_gagnet_zero_spectrum_stays_finite():
    """Padded frames carry exactly-zero spectra; the guarded magnitude and
    phase keep the post-filter finite there, as in the JAX package."""
    x = inputs(2)
    spec, pre = x[..., 0, :], x[..., 1, :].copy()
    pre[:, -4:] = 0.0
    jm = JGaGNet(JGaG(**GAG))
    params = params_of(jm, spec, pre)
    ref = np.asarray(jm.apply({"params": params}, spec, pre)[-1])
    tm = load_jax_params(GaGNet(GaGNetConfig(**GAG)), params)
    with torch.no_grad():
        ours = tm(torch.from_numpy(spec), torch.from_numpy(pre))[-1].numpy()
    assert np.isfinite(ours).all()
    np.testing.assert_allclose(ours, ref, atol=ATOL)


def test_composed_matches_flax():
    x = inputs(3)
    cfg = dict(eabnet=JEaB(**EAB), gagnet=JGaG(**GAG), ref_mic=1)
    jm = JComposedNet(JComposed(**cfg))
    params = params_of(jm, x)
    ref = jm.apply({"params": params}, x)
    tm = load_jax_params(EaBNetWithPostNet(ComposedConfig(
        eabnet=EaBNetConfig(**EAB), gagnet=GaGNetConfig(**GAG), ref_mic=1)),
        params)
    with torch.no_grad():
        ours = tm(torch.from_numpy(x))
    for k in ("esti0", "esti"):
        np.testing.assert_allclose(ours[k].numpy(), np.asarray(ref[k]),
                                   atol=ATOL)
    assert len(ours["esti1"]) == GAG["q"]
    assert ours["esti"] is ours["esti1"][-1]


VARIANTS = [dict(norm_type="cLN"), dict(norm_type="cLN-ref", is_u2=False),
            dict(norm_type="BN"), dict(norm_type="BN", is_u2=False),
            dict(norm_type="cLN", is_causal=False)]
VARIANT_IDS = ["cln", "clnref-unet", "bn", "bn-unet", "cln-noncausal"]


def variables_of(model, *args):
    """flax init; batch norms get seeded running statistics."""
    v = jax.tree.map(np.asarray, model.init(jax.random.key(0), *args))
    rng = np.random.default_rng(7)
    stats = jax.tree_util.tree_map_with_path(
        lambda path, a: (rng.uniform(0.5, 1.5, a.shape) if
                         path[-1].key == "var" else
                         rng.uniform(-0.2, 0.2, a.shape)).astype(np.float32),
        v.get("batch_stats", {}))
    return v["params"], stats


def port_model(model, params, stats):
    load_jax_batch_stats(load_jax_params(model, params), stats)
    return model.eval()


@pytest.mark.parametrize("kw", VARIANTS, ids=VARIANT_IDS)
def test_eabnet_variants_match_flax(kw):
    """cLN, cLN-ref and BN (evaluation, running statistics), the plain
    UNet and the non-causal TCN."""
    x = inputs(5)
    jm = JEaBNet(JEaB(**EAB, **kw))
    params, stats = variables_of(jm, x)
    ref = np.asarray(jm.apply({"params": params, "batch_stats": stats}, x)
                     if stats else jm.apply({"params": params}, x))
    tm = port_model(EaBNet(EaBNetConfig(**EAB, **kw)), params, stats)
    with torch.no_grad():
        ours = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(ours, ref, atol=ATOL)


@pytest.mark.parametrize("kw", VARIANTS, ids=VARIANT_IDS)
def test_gagnet_variants_match_flax(kw):
    x = inputs(6)
    spec, pre = x[..., 0, :], x[..., 1, :]
    jm = JGaGNet(JGaG(**GAG, **kw))
    params, stats = variables_of(jm, spec, pre)
    variables = {"params": params, **({"batch_stats": stats} if stats
                                       else {})}
    refs = jm.apply(variables, spec, pre)
    tm = port_model(GaGNet(GaGNetConfig(**GAG, **kw)), params, stats)
    with torch.no_grad():
        outs = tm(torch.from_numpy(spec), torch.from_numpy(pre))
    for a, b in zip(outs, refs):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL)


def test_full_width_param_counts():
    """The port's modules at the default widths carry the reference's
    parameter counts (2,838,610 and 5,950,697, tests/test_models.py)."""
    count = lambda m: sum(p.numel() for p in m.parameters())  # noqa: E731
    assert count(EaBNet(EaBNetConfig())) == 2_838_610
    assert count(GaGNet(GaGNetConfig())) == 5_950_697
