"""The LSTM-BF backward kernel's arithmetic, emulated in numpy: every
product of the reverse walk and of the weight gradients as the kernel takes
it on the tensor cores, with TF32 operands. Split into three products
(a = a_hi + a_lo; a_lo b_hi + a_hi b_lo + a_hi b_hi), with a_hi the
mantissa rounded to 10 bits (to nearest, ties away from zero, the rounding
of ``cvt.rna.tf32.f32``) and a_lo = a - a_hi, which the tensor cores read
truncated to TF32, the walk holds the JAX package's gradient tolerances
against a float64 walk (tests/test_kernels.py: d xw1 3e-5, weights 5e-5,
rtol 1e-4; the weights against their largest entry, as on the card) and
stays as close to the float64 walk as a float32 walk does; as one TF32
product it does not, and a weight-gradient GEMM of one TF32 product fails
on the weights even beside a 3xTF32 walk. The same holds for the TCM-chain
kernels' forward and backward (below)."""

import numpy as np
import pytest

T, L, H = 24, 16, 64
DX_ATOL, DW_ATOL, RTOL = 3e-5, 5e-5, 1e-4
F64_FACTOR = 3.0  # chip_smoke.py's LSTM_DW_F64_FACTOR


def tf32(x):
    """float32 -> the nearest TF32 value (ties away from zero)."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)) \
        .view(np.float32)


def tf32_truncated(x):
    """What the tensor cores read of a float32 operand: its top 19 bits."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    return (bits & np.uint32(0xFFFFE000)).view(np.float32)


def dot_3xtf32(a, b):
    ah, bh = tf32(a), tf32(b)
    al, bl = tf32_truncated(a - ah), tf32_truncated(b - bh)
    return (al @ bh + ah @ bl) + ah @ bh


def dot_tf32(a, b):
    return tf32(a) @ tf32(b)


def dot_exact(a, b):
    return a @ b


def sigm(x):
    return 1.0 / (1.0 + np.exp(-x))


def cell_bwd(dh, dc, c_prev, c_new, gates):
    gi, gf, gg, go = np.split(gates, 4, axis=-1)
    si, sf, so = sigm(gi), sigm(gf), sigm(go)
    sg, tc = np.tanh(gg), np.tanh(c_new)
    dct = dc + dh * so * (1 - tc * tc)
    return np.concatenate([dct * sg * si * (1 - si),
                           dct * c_prev * sf * (1 - sf),
                           dct * si * (1 - sg * sg),
                           dh * tc * so * (1 - so)], -1), dct * sf


def forward_states(xw1, w_hh1, w_ih2, w_hh2, b2):
    z = np.zeros((L, H))
    h1, c1, h2, c2 = z, z, z, z
    out = []
    for s in range(T):
        g1 = xw1[s] + h1 @ w_hh1
        i, f, g, o = np.split(g1, 4, -1)
        c1 = sigm(f) * c1 + sigm(i) * np.tanh(g)
        h1 = sigm(o) * np.tanh(c1)
        g2 = h1 @ w_ih2 + h2 @ w_hh2 + b2
        i, f, g, o = np.split(g2, 4, -1)
        c2 = sigm(f) * c2 + sigm(i) * np.tanh(g)
        h2 = sigm(o) * np.tanh(c2)
        out.append((h1, c1, h2, c2))
    return [np.stack(a) for a in zip(*out)]


def walk(dot, dtype, xw1, dy, h1, c1, h2, c2, w_hh1, w_ih2, w_hh2, b2,
         wdot=None):
    """The kernel's reverse walk (its products through ``dot``) and its
    weight-gradient GEMM (through ``wdot``, by default ``dot``), in
    ``dtype``."""
    wdot = wdot or dot
    cast = lambda *a: [np.asarray(v, dtype) for v in a]  # noqa: E731
    xw1, dy, h1, c1, h2, c2, w_hh1, w_ih2, w_hh2, b2 = cast(
        xw1, dy, h1, c1, h2, c2, w_hh1, w_ih2, w_hh2, b2)
    z = np.zeros((L, H), dtype)
    dh1, dc1, dh2, dc2 = z, z, z, z
    dxw1, dg2s = np.empty_like(xw1), np.empty_like(xw1)
    for s in range(T - 1, -1, -1):
        h1p, c1p, h2p, c2p = ((a[s - 1] if s else z) for a in (h1, c1, h2,
                                                              c2))
        gates2 = dot(np.concatenate([h1[s], h2p], -1),
                     np.concatenate([w_ih2, w_hh2])) + b2
        gates1 = xw1[s] + dot(h1p, w_hh1)
        dg2, dc2 = cell_bwd(dy[s] + dh2, dc2, c2p, c2[s], gates2)
        dh2 = dot(dg2, w_hh2.T)
        dg1, dc1 = cell_bwd(dh1 + dot(dg2, w_ih2.T), dc1, c1p, c1[s], gates1)
        dh1 = dot(dg1, w_hh1.T)
        dxw1[s], dg2s[s] = dg1, dg2
    # the weight gradients over all T x L rows, dW_ih2 and dW_hh2 as one
    # K = 128 product
    rows = lambda a: a.reshape(T * L, -1)  # noqa: E731
    h1_prev = np.concatenate([z[None], h1[:-1]])
    h2_prev = np.concatenate([z[None], h2[:-1]])
    dw_hh1 = wdot(rows(h1_prev).T, rows(dxw1))
    dw2 = wdot(np.concatenate([rows(h1), rows(h2_prev)], -1).T, rows(dg2s))
    return dxw1, dw_hh1, dw2[:H], dw2[H:], rows(dg2s).sum(0)


def dx_within(got, ref):
    """The JAX tolerance for d xw1, per entry."""
    return bool(np.all(np.abs(got[0] - ref[0])
                       <= DX_ATOL + RTOL * np.abs(ref[0])))


def dw_within(got, ref, plain):
    """The weights as the card holds them: against their largest entry,
    and at most F64_FACTOR times as far from the float64 walk as the
    float32 walk ``plain``."""
    return all(np.abs(a - b).max() <= DW_ATOL + RTOL * np.abs(b).max()
               and np.abs(a - b).max() <= F64_FACTOR * np.abs(p - b).max()
               for a, b, p in zip(got[1:], ref[1:], plain[1:]))


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(7)
    w = [rng.standard_normal(s) * 0.2 for s in ((H, 4 * H),) * 3
         + ((4 * H,),)]
    xw1 = rng.standard_normal((T, L, 4 * H))
    dy = rng.standard_normal((T, L, H))
    # the forward's states in float64, stored as float32 as the kernel
    # reads them
    states = [s.astype(np.float32).astype(np.float64)
              for s in forward_states(xw1, *w)]
    args = [np.asarray(a, np.float32).astype(np.float64)
            for a in [xw1, dy] + states + w]
    return (args, walk(dot_exact, np.float64, *args),
            walk(dot_exact, np.float32, *args))


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = np.array([1.0, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10 + 2.0 ** -12,
                  -3.0 - 2.0 ** -10, 1.0 + 2.0 ** -12], np.float32)
    np.testing.assert_array_equal(
        tf32(x), np.array([1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10,
                           -3.0 - 2.0 ** -9, 1.0], np.float32))
    hi = tf32(x)
    assert np.all(hi.view(np.uint32) & np.uint32(0x1FFF) == 0)


def test_three_tf32_products_hold_the_jax_tolerances(problem):
    args, ref, plain = problem
    got = walk(dot_3xtf32, np.float32, *args)
    assert dx_within(got, ref) and dw_within(got, ref, plain)
    # as close as a float32 walk of the same order
    assert np.abs(got[0] - ref[0]).max() <= \
        4 * np.abs(plain[0] - ref[0]).max() + 1e-7


def test_one_tf32_product_misses_them(problem):
    args, ref, plain = problem
    got = walk(dot_tf32, np.float32, *args)
    assert not dx_within(got, ref)


def test_one_tf32_weight_gradient_fails_on_the_weights(problem):
    args, ref, plain = problem
    got = walk(dot_3xtf32, np.float32, *args, wdot=dot_tf32)
    assert dx_within(got, ref)
    assert not dw_within(got, ref, plain)
    # each weight gradient alone misses the float64 rule
    for a, b, p in zip(got[1:4], ref[1:4], plain[1:4]):
        assert np.abs(a - b).max() > F64_FACTOR * np.abs(p - b).max()


# ------------------------------------------------------------ TCM chain
# The TCM-chain kernels' arithmetic, emulated the same way: a chain of two
# squeezed TCMs (twin: K = 5, dilations (1, 2); single: K = 3, the same
# dilations) at D = 256, C = 64, its forward and its reverse walk written
# out as csrc/tcm_chain.cu computes them, every product (the in- and
# out-projections, the conv taps, their transposes in the walk and the
# weight-gradient GEMM) through one ``dot``, IN statistics and elementwise
# work in float32. Held against the same chain in float64 with the JAX
# package's tolerances (tests/test_tcm_chain.py: forward 2e-5; gradients
# 6e-5, rtol 1e-3, the weight gradients against their largest entry, as on
# the card).

TB, TT_, TD, TC = 2, 40, 256, 64
TCM_CASES = {"twin": (True, 5, (1, 2)), "single": (False, 3, (1, 2))}
FWD_ATOL, BWD_ATOL, BWD_RTOL = 2e-5, 6e-5, 1e-3


def _prelu(x, a):
    return np.maximum(x, 0) + a * np.minimum(x, 0)


def _shift(a, s):
    """(B, T, C) delayed by s frames (s > 0) or advanced by -s, zeros
    entering."""
    out = np.zeros_like(a)
    if s >= 0:
        out[:, s:] = a[:, :a.shape[1] - s]
    else:
        out[:, :s] = a[:, -s:]
    return out


def _mm(dot, a, w):
    """(B, T, K) @ (K, M) through dot."""
    return dot(a.reshape(-1, a.shape[-1]), w).reshape(a.shape[:-1] + (-1,))


def _gram(dot, a, b):
    """sum over (B, T) of a^T b: the weight-gradient GEMM."""
    return dot(a.reshape(-1, a.shape[-1]).T, b.reshape(-1, b.shape[-1]))


def _in(x, gamma, beta, eps=1e-5):
    mean = x.mean(axis=1, keepdims=True)
    inv = 1.0 / np.sqrt(((x - mean) ** 2).mean(axis=1, keepdims=True) + eps)
    xhat = (x - mean) * inv
    return xhat * gamma + beta, xhat, inv


def _in_bwd(xhat, inv, gamma, dy):
    dxh = dy * gamma
    return (inv * (dxh - dxh.mean(axis=1, keepdims=True)
                   - xhat * (dxh * xhat).mean(axis=1, keepdims=True)),
            (dy * xhat).sum(axis=(0, 1)), dy.sum(axis=(0, 1)))


def tcm_chain(dot, dtype, x, dy, w, dils, twin):
    """The chain forward and its reverse walk in ``dtype``, products
    through ``dot`` -> (y, dx, (dwi, dwl, dwr, dwo, dal, dga, dbe))."""
    x, dy = (np.asarray(v, dtype) for v in (x, dy))
    wi, wl, wr, wo, al, ga, be = (np.asarray(v, dtype) for v in w)
    k = wl.shape[1]
    branches = ((0, wl), (1, wr))[:2 if twin else 1]
    saves = []
    for j, dil in enumerate(dils):
        s = {"x": x, "h": _mm(dot, x, wi[j])}
        convs = []
        for bi, wb in branches:
            n, s[f"xh{bi}"], s[f"inv{bi}"] = _in(_prelu(s["h"], al[j, bi]),
                                                 ga[j, bi], be[j, bi])
            s[f"n{bi}"] = n
            convs.append(sum(_mm(dot, _shift(n, (k - 1 - i) * dil), wb[j, i])
                             for i in range(k)))
        s["c"] = convs
        sig = 1.0 / (1.0 + np.exp(-convs[-1]))
        s["g"] = convs[0] * sig if twin else convs[0]
        s["no"], s["xho"], s["invo"] = _in(_prelu(s["g"], al[j, 2]),
                                           ga[j, 2], be[j, 2])
        x = x + _mm(dot, s["no"], wo[j])
        saves.append(s)
    y = x
    grads = [np.zeros_like(v) for v in (wi, wl, wr, wo, al, ga, be)]
    dwi, dwl, dwr, dwo, dal, dga, dbe = grads
    for j in range(len(dils) - 1, -1, -1):
        s, dil = saves[j], dils[j]
        dwo[j] = _gram(dot, s["no"], dy)
        dpo, dga[j, 2], dbe[j, 2] = _in_bwd(s["xho"], s["invo"], ga[j, 2],
                                            _mm(dot, dy, wo[j].T))
        dg = np.where(s["g"] > 0, dpo, al[j, 2] * dpo)
        dal[j, 2] = (dpo * np.minimum(s["g"], 0)).sum(axis=(0, 1))
        if twin:
            sig = 1.0 / (1.0 + np.exp(-s["c"][1]))
            dcs = (dg * sig, dg * s["c"][0] * sig * (1 - sig))
        else:
            dcs = (dg,)
        dh = np.zeros_like(s["h"])
        for (bi, wb), dc, dw in zip(branches, dcs, (dwl, dwr)):
            dn = np.zeros_like(dc)
            for i in range(k):
                sh = (k - 1 - i) * dil
                dw[j, i] = _gram(dot, _shift(s[f"n{bi}"], sh), dc)
                dn = dn + _shift(_mm(dot, dc, wb[j, i].T), -sh)
            dp, dga[j, bi], dbe[j, bi] = _in_bwd(s[f"xh{bi}"], s[f"inv{bi}"],
                                                 ga[j, bi], dn)
            dh = dh + np.where(s["h"] > 0, dp, al[j, bi] * dp)
            dal[j, bi] = (dp * np.minimum(s["h"], 0)).sum(axis=(0, 1))
        dwi[j] = _gram(dot, s["x"], dh)
        dy = dy + _mm(dot, dh, wi[j].T)
    return y, dy, grads


@pytest.fixture(scope="module")
def tcm_problems():
    """Per case: the float32 inputs, the float64 chain, and the float32
    chain with exact products."""
    out = {}
    for name, (twin, k, dils) in TCM_CASES.items():
        rng = np.random.default_rng(11 if twin else 12)
        p = len(dils)
        w = [rng.standard_normal((p, TD, TC)) / 16,
             rng.standard_normal((p, k, TC, TC)) / (8 * k ** 0.5),
             rng.standard_normal((p, k, TC, TC)) / (8 * k ** 0.5),
             rng.standard_normal((p, TC, TD)) / 8,
             rng.uniform(0.0, 0.5, (p, 3, TC)),
             rng.uniform(0.5, 1.5, (p, 3, TC)),
             rng.uniform(-0.5, 0.5, (p, 3, TC))]
        x = rng.standard_normal((TB, TT_, TD))
        dy = rng.standard_normal((TB, TT_, TD))
        args = [np.asarray(a, np.float32).astype(np.float64)
                for a in [x, dy] + w]
        out[name] = (args, tcm_chain(dot_exact, np.float64, *args[:2],
                                     args[2:], dils, twin))
    return out


def tcm_within(got, ref, twin):
    """(forward within 2e-5, backward within 6e-5 + 1e-3 |ref|: d x per
    entry, the weight gradients against their largest entry)."""
    fwd = bool(np.all(np.abs(got[0] - ref[0]) <= FWD_ATOL))
    bwd = bool(np.all(np.abs(got[1] - ref[1])
                      <= BWD_ATOL + BWD_RTOL * np.abs(ref[1])))
    for a, b in zip(got[2], ref[2]):
        bwd &= bool(np.abs(a - b).max()
                    <= BWD_ATOL + BWD_RTOL * np.abs(b).max())
    return fwd, bwd


@pytest.mark.parametrize("part", ["forward", "backward"])
@pytest.mark.parametrize("case", list(TCM_CASES))
def test_tcm_chain_three_tf32_products_hold_the_jax_tolerances(
        tcm_problems, case, part):
    twin, _, dils = TCM_CASES[case]
    args, ref = tcm_problems[case]
    got = tcm_chain(dot_3xtf32, np.float32, *args[:2], args[2:], dils, twin)
    fwd, bwd = tcm_within(got, ref, twin)
    assert fwd if part == "forward" else bwd


@pytest.mark.parametrize("case", list(TCM_CASES))
def test_tcm_chain_one_tf32_product_misses_them(tcm_problems, case):
    twin, _, dils = TCM_CASES[case]
    args, ref = tcm_problems[case]
    got = tcm_chain(dot_tf32, np.float32, *args[:2], args[2:], dils, twin)
    assert not all(tcm_within(got, ref, twin))
    # the float32 chain with exact products holds them: the misses are the
    # products' precision
    exact = tcm_chain(dot_exact, np.float32, *args[:2], args[2:], dils, twin)
    assert all(tcm_within(exact, ref, twin))
