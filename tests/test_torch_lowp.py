"""bfloat16 serving on the CPU: the two kernel modules' plain bf16 versions
against the JAX package's Pallas kernels in bf16 (interpret mode), the
wrappers' bf16 dispatch and refusals, and the composed model in bf16
against the JAX model in bf16 at small widths.

The tolerances (PERF.md §2). For a bf16 result let R be the SNR between
the reference's own bf16 and float32 outputs on the same inputs.

- Kernel level, the same function on both sides: the port's plain bf16
  version must reach R + 20 dB against JAX's Pallas function in bf16.
  The double LSTM does so over its whole sequence (R + 28 here). A TCM
  chain is held to it one TCM at a time: TCM j alone (``_chain`` with a
  float32 x and bf16 weights, as the Pallas kernel allows), on the float32
  trunk that the reference chain gives it, its float32 output against the
  reference's, R from the same TCM with float32 weights. Each TCM must
  reach R + 20 dB.
- The whole chain is checked beside it, with its bf16 output. Over 3 or 4
  TCMs a rounding to bf16 that goes the other way (its float32 input
  moved by float32 rounding) changes a later operand by a bf16 step and
  flips more roundings downstream, so no float32 implementation reaches
  R + 20 there: the plain version computed in float32 is only D = R + 5 to
  R + 9 dB from the same computed in float64 around the same bf16
  operands. The chain must reach min(R + 20, D - 3) dB (3 dB for two
  independent float32 roundings). The largest entry gap is printed, not
  bounded (one bf16 step where a rounding flips).
- Model level: the port's bf16 must reach R - 6 dB against the
  reference's bf16 and R - 3 dB against its float32 (two independent bf16
  roundings of one float32 function sit about 3 dB closer to it than to
  each other).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eabnet_tpu.config import ComposedConfig as JComposed
from eabnet_tpu.config import EaBNetConfig as JEaB
from eabnet_tpu.config import GaGNetConfig as JGaG
from eabnet_tpu.kernels.lstm_bf import _double_lstm
from eabnet_tpu.kernels.tcm_chain import _chain, tcm_chain_pallas
from eabnet_tpu.models import EaBNetWithPostNet as JComposedNet
from eabnet_tpu.models.eabnet import LSTMBeamformer as JLSTMBeamformer
from eabnet_tpu.nn.blocks import SqueezedTCNGroup as JGroup
from eabnet_tpu_torch.config import (ComposedConfig, EaBNetConfig,
                                     GaGNetConfig)
from eabnet_tpu_torch.kernels.lstm_bf import (double_lstm,
                                              double_lstm_reference)
from eabnet_tpu_torch.kernels.tcm_chain import tcm_chain, tcm_chain_reference
from eabnet_tpu_torch.models import EaBNetWithPostNet
from eabnet_tpu_torch.nn.blocks import SqueezedTCNGroup
from eabnet_tpu_torch.weights import load_jax_params

BF16 = torch.bfloat16
KERNEL_MARGIN_DB = 20.0    # plain vs reference kernel: R + this ...
SPREAD_DB = 3.0            # ... a whole TCM chain: or D - this, if lower
MODEL_BF16_DB = 6.0        # model vs the reference's bf16: R - this
MODEL_F32_DB = 3.0         # model vs the reference's float32: R - this


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for the port: on a host that other test workers
    load, more threads mostly wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def snr_db(ref, est):
    ref, est = (np.asarray(a, np.float64) for a in (ref, est))
    with np.errstate(divide="ignore"):  # identical signals: +inf dB
        return 10 * np.log10(np.sum(ref ** 2) / np.sum((ref - est) ** 2))


def f32(a):
    """A bf16 array or tensor as float32 numpy."""
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


# ---------------------------------------------------------------- LSTM-BF
def lstm_inputs(t=120, lanes=24, c=64, h=64, seed=0):
    """xw1 = x @ W_ih1 + b and the recurrent weights of a flax-initialised
    head (the LSTM's own init, as a trained head starts), float32."""
    rng = np.random.default_rng(seed)
    x4 = rng.standard_normal((1, t, lanes, c)).astype(np.float32)
    head = JLSTMBeamformer(embed_dim=c, M=3, hid_node=h)
    p = jax.tree.map(np.asarray, head.init(jax.random.key(seed), x4)["params"])
    r1, r2 = p["rnn1"], p["rnn2"]
    x = rng.standard_normal((t, lanes, c)).astype(np.float32)
    xw1 = x @ r1["w_ih"] + r1["b_ih"] + r1["b_hh"]
    return [xw1.astype(np.float32), r1["w_hh"], r2["w_ih"], r2["w_hh"],
            (r2["b_ih"] + r2["b_hh"]).astype(np.float32)]


def kernel_rule(what, ours, j16, j32, wide=None):
    """The kernel-level rule (module doc), printed: ``ours`` against the
    reference's bf16 ``j16``, R from its float32 ``j32``, R + 20; for a
    whole TCM chain, D from the plain version computed in float64
    (``wide``), min(R + 20, D - 3)."""
    r, got = snr_db(j32, j16), snr_db(j16, f32(ours))
    need, d = r + KERNEL_MARGIN_DB, ""
    if wide is not None:
        d = snr_db(f32(wide), f32(ours))
        need, d = min(need, d - SPREAD_DB), f", D {d:.2f} dB"
    print(f"{what}: R {r:.2f} dB{d}, plain bf16 vs Pallas bf16 "
          f"{got:.2f} dB (R + {got - r:.2f}; needs {need:.2f}), largest "
          f"entry gap {np.abs(f32(ours) - j16).max():.3e}")
    return got >= need


def test_lstm_plain_bf16_matches_pallas_interpret():
    args = lstm_inputs()
    j32 = np.asarray(_double_lstm(*map(jnp.asarray, args), True))
    j16 = f32(_double_lstm(*(jnp.asarray(a).astype(jnp.bfloat16)
                             for a in args), True))
    a16 = [torch.from_numpy(a).to(BF16) for a in args]
    with torch.no_grad():
        ours = double_lstm(*a16)
    assert ours.dtype == BF16 and ours.shape == j16.shape
    assert kernel_rule("lstm", ours, j16, j32)


def test_lstm_plain_bf16_rounds_h_only_where_it_is_a_product_operand():
    """h2 equals the bf16 rounding of the float32 sequences of the same
    semantics, and its products read bf16 values: rounding h at the
    output only (float32 operands) is farther from the reference."""
    args = [torch.from_numpy(a).to(BF16) for a in lstm_inputs(t=40)]
    from eabnet_tpu_torch.kernels.lstm_bf import double_lstm_states_reference

    with torch.no_grad():
        h2 = double_lstm_states_reference(*args)[2]
        np.testing.assert_array_equal(
            double_lstm_reference(*args).float().numpy(),
            h2.to(BF16).float().numpy())
        wide = double_lstm_reference(*(a.float() for a in args))
    j16 = f32(_double_lstm(*(jnp.asarray(a.float().numpy()).astype(
        jnp.bfloat16) for a in args), True))
    assert snr_db(j16, h2.to(BF16).float()) > snr_db(j16, wide.to(BF16)
                                                      .float())


# ------------------------------------------------------------ TCM chain
B, T, D, C = 2, 40, 256, 64
CASES = [(True, 5, (1, 2, 4)), (False, 3, (1, 2, 5, 9))]
IDS = ["twin", "single"]


def tcm_group(twin, kd1, dils, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    jg = JGroup(kd1, C, D, dils, twin_gate=twin)
    params = jax.tree.map(np.asarray,
                          jg.init(jax.random.key(seed), x)["params"])
    tg = load_jax_params(SqueezedTCNGroup(kd1, C, D, dils, twin_gate=twin),
                         params)
    return x, params, tg


def pallas_chain(params, x, kd1, dils, twin, dtype):
    p = jax.tree.map(lambda a: jnp.asarray(a).astype(dtype), params)
    return f32(tcm_chain_pallas(p, jnp.asarray(x).astype(dtype), kd1, C,
                                dils, twin, interpret=True))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("twin,kd1,dils", CASES, ids=IDS)
def test_tcm_plain_bf16_each_tcm_against_pallas(twin, kd1, dils, seed):
    """Each TCM alone on the reference's float32 trunk, float32 out: R +
    20 dB (module doc)."""
    x, _, tg = tcm_group(twin, kd1, dils, seed)
    w32 = tuple(w.detach() for w in tg.stacked_weights())
    w16 = tuple(w.to(BF16) for w in w32)
    trunk = torch.from_numpy(x).to(BF16).float()
    for j, dil in enumerate(dils):
        wj = [tuple(w[j:j + 1] for w in ws) for ws in (w32, w16)]
        jx = jnp.asarray(trunk.numpy())
        j32, j16 = (np.asarray(_chain(jx, tuple(
            jnp.asarray(w.float().numpy()).astype(dt) for w in ws), (dil,),
            twin, True)) for ws, dt in zip(wj, (jnp.float32, jnp.bfloat16)))
        with torch.no_grad():
            ours = tcm_chain_reference(trunk, wj[1], (dil,), twin)
        assert ours.dtype == torch.float32
        r, got = snr_db(j32, j16), snr_db(j16, ours.numpy())
        print(f"tcm {j}: R {r:.2f} dB, plain vs Pallas {got:.2f} dB (R + "
              f"{got - r:.2f}), largest entry gap "
              f"{np.abs(ours.numpy() - j16).max():.3e}")
        assert got >= r + KERNEL_MARGIN_DB, j
        trunk = torch.from_numpy(j16.copy())  # the trunk after TCM j


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("twin,kd1,dils", CASES, ids=IDS)
def test_tcm_plain_bf16_whole_chain_against_pallas(twin, kd1, dils, seed):
    x, params, tg = tcm_group(twin, kd1, dils, seed)
    j32 = pallas_chain(params, x, kd1, dils, twin, jnp.float32)
    j16 = pallas_chain(params, x, kd1, dils, twin, jnp.bfloat16)
    w16 = tuple(w.to(BF16) for w in tg.stacked_weights())
    x16 = torch.from_numpy(x).to(BF16)
    with torch.no_grad():
        ours = tcm_chain(x16, w16, dils, twin)
        wide = tcm_chain_reference(x16, w16, dils, twin,
                                   compute=torch.float64)
    assert ours.dtype == BF16
    assert kernel_rule("tcm chain", ours, j16, j32, wide)


def test_tcm_plain_bf16_keeps_the_trunk_float32():
    """Between the TCMs of a group the trunk stays float32: the chain
    equals its TCMs one after another on a float32 trunk (bf16 operands),
    rounded to bf16 once at the end, bit for bit."""
    twin, kd1, dils = CASES[0]
    x, _, tg = tcm_group(twin, kd1, dils, seed=3)
    w16 = tuple(w.to(BF16) for w in tg.stacked_weights())
    x16 = torch.from_numpy(x).to(BF16)
    with torch.no_grad():
        chain = tcm_chain(x16, w16, dils, twin)
        trunk = x16.float()
        for j, dil in enumerate(dils):
            trunk = _one_tcm_f32_trunk(
                trunk, tuple(w[j:j + 1].float() for w in w16), dil, twin)
    np.testing.assert_array_equal(f32(chain), f32(trunk.to(BF16)))


def _one_tcm_f32_trunk(x, w, dil, twin):
    """One TCM of the bf16 semantics on a float32 trunk, written out."""
    from eabnet_tpu_torch.kernels.tcm_chain import (_causal_conv,
                                                    _instance_norm_t, _prelu)

    def rnd(v):
        return v.to(BF16).float()

    wi, wl, wr, wo, al, ga, be = w
    h = rnd(x) @ wi[0]
    convs = [_causal_conv(rnd(_instance_norm_t(_prelu(h, al[0, b]), ga[0, b],
                                               be[0, b])), wc[0], dil)
             for b, wc in ((0, wl), (1, wr))[:2 if twin else 1]]
    g = convs[0] * torch.sigmoid(convs[1]) if twin else convs[0]
    no = _instance_norm_t(_prelu(g, al[0, 2]), ga[0, 2], be[0, 2])
    return x + rnd(no) @ wo[0]


# ---------------------------------------------------------------- wrappers
def test_bf16_on_cpu_takes_the_plain_path_and_counts_nothing():
    args = [torch.from_numpy(a).to(BF16) for a in lstm_inputs(t=6, lanes=3)]
    x, _, tg = tcm_group(*CASES[1], seed=4)
    w16 = tuple(w.to(BF16) for w in tg.stacked_weights())
    x16 = torch.from_numpy(x).to(BF16)
    before = (double_lstm.launches, tcm_chain.launches)
    with torch.no_grad():
        np.testing.assert_array_equal(f32(double_lstm(*args)),
                                      f32(double_lstm_reference(*args)))
        np.testing.assert_array_equal(
            f32(tcm_chain(x16, w16, CASES[1][2], False)),
            f32(tcm_chain_reference(x16, w16, CASES[1][2], False)))
    assert (double_lstm.launches, tcm_chain.launches) == before


def test_bf16_refuses_mixed_dtypes_and_autograd():
    """Mixed dtypes raise; bf16 autograd on the CPU takes the plain bf16
    backwards (not autograd of the plain forward)."""
    from eabnet_tpu_torch.kernels.lstm_bf import (
        double_lstm_bwd_reference, double_lstm_states_reference)
    from eabnet_tpu_torch.kernels.tcm_chain import tcm_chain_bwd_reference

    args = [torch.from_numpy(a).to(BF16) for a in lstm_inputs(t=4, lanes=2)]
    x, _, tg = tcm_group(*CASES[0], seed=5)
    w16 = tuple(w.to(BF16) for w in tg.stacked_weights())
    x16 = torch.from_numpy(x).to(BF16)
    with torch.no_grad():
        with pytest.raises(TypeError):  # float32 xw1, bf16 weights
            double_lstm(args[0].float(), *args[1:])
        with pytest.raises(TypeError):
            tcm_chain(x16.float(), w16, CASES[0][2], True)
        with pytest.raises(TypeError):
            tcm_chain(x16.half(), tuple(w.half() for w in w16), CASES[0][2],
                      True)
    # a gradient request takes the plain bf16 backward
    xw1 = args[0].clone().requires_grad_()
    dy = torch.ones((4, 2, 64), dtype=BF16)
    (got,) = torch.autograd.grad(double_lstm(xw1, *args[1:]), xw1, dy)
    with torch.no_grad():
        want = double_lstm_bwd_reference(
            args[0], dy, *double_lstm_states_reference(*args), *args[1:])[0]
    assert got.dtype == BF16 and torch.equal(got, want)
    xg = x16.clone().requires_grad_()
    dyc = torch.ones_like(x16)
    (got,) = torch.autograd.grad(tcm_chain(xg, w16, CASES[0][2], True), xg,
                                 dyc)
    with torch.no_grad():
        want = tcm_chain_bwd_reference(x16, dyc, w16, CASES[0][2], True)[0]
    assert got.dtype == BF16 and torch.equal(got, want)


# ----------------------------------------------------------- model level
BM, TM, FM, MM = 1, 24, 161, 3


def composed_cfgs(norm, impl):
    bf_impl, tcn_impl = impl
    eab = dict(c=16, M=MM, embed_dim=16, cd1=64, p=2, q=2, hid_node=64,
               norm_type=norm)
    gag = dict(c=16, cd1=64, p=1, q=2, dilas=(1, 2), norm_type=norm)
    jcfg = JComposed(eabnet=JEaB(bf_impl=bf_impl, tcn_impl=tcn_impl, **eab),
                     gagnet=JGaG(tcn_impl=tcn_impl, **gag))
    tcfg = ComposedConfig(eabnet=EaBNetConfig(**eab),
                          gagnet=GaGNetConfig(**gag))
    return jcfg, tcfg


@pytest.mark.parametrize("impl", [("pallas", "pallas"), ("scan", "xla")],
                         ids=["pallas", "shipped"])
@pytest.mark.parametrize("norm", ["IN", "cLN"])
def test_composed_bf16_meets_the_model_rule(norm, impl):
    jcfg, tcfg = composed_cfgs(norm, impl)
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((BM, TM, FM, MM, 2)) * 0.5).astype(np.float32)
    jm = JComposedNet(jcfg)
    params = jax.tree.map(np.asarray,
                          jm.init(jax.random.key(0), x)["params"])
    p16 = jax.tree.map(lambda a: jnp.asarray(a).astype(jnp.bfloat16), params)
    ref32 = jm.apply({"params": params}, x)
    ref16 = jm.apply({"params": p16}, jnp.asarray(x).astype(jnp.bfloat16))
    tm = load_jax_params(EaBNetWithPostNet(tcfg), params).to(BF16).eval()
    with torch.no_grad():
        ours = tm(torch.from_numpy(x).to(BF16))
    for stage in ("esti0", "esti"):
        assert ours[stage].dtype == BF16
        o, j16, j32 = f32(ours[stage]), f32(ref16[stage]), f32(ref32[stage])
        r = snr_db(j32, j16)
        print(f"{norm} {impl} {stage}: R {r:.2f} dB, port bf16 vs JAX "
              f"bf16 {snr_db(j16, o):.2f}, vs JAX f32 {snr_db(j32, o):.2f}")
        assert snr_db(j16, o) >= r - MODEL_BF16_DB, stage
        assert snr_db(j32, o) >= r - MODEL_F32_DB, stage


def test_cln_statistics_stay_float32_under_bf16_params():
    """model.to(bfloat16) leaves cLN's statistics in float32: the norm of
    a bf16 input equals its float32 computation rounded once."""
    from eabnet_tpu_torch.nn.norms import CumulativeLayerNorm

    norm = CumulativeLayerNorm(8)
    with torch.no_grad():
        norm.scale.uniform_(0.5, 1.5)
        norm.bias.uniform_(-0.5, 0.5)
    x = (torch.randn(2, 8, 50, 5, generator=torch.Generator()
                     .manual_seed(0)) * 3 + 100).to(BF16)
    with torch.no_grad():
        ref = norm(x.float())
        norm.to(BF16)
        ours = norm(x)
    assert ours.dtype == BF16
    # f32 statistics: mean 100 and sigma 3 survive; bf16 sums would not
    assert snr_db(f32(ref), f32(ours)) > 40.0
