"""bfloat16 training on the CPU: the plain bf16 backwards of the two kernel
modules against the JAX package's Pallas vjps in bf16 (interpret mode),
the port's bf16 train step against the JAX package's mixed-precision step,
the norms under bf16 autograd, and the golden of the card's bf16 train
run.

The rules (PERF.md §2). For a bf16 result let R be the SNR between the
reference's own bf16 and float32 results on the same inputs.

- Kernel level: the training forward's four state sequences must reach
  R + 20 dB against JAX's ``_double_lstm`` in bf16, and each output of
  the plain bf16 LSTM-BF backward (dxw1, dW_hh1, dW_ih2, dW_hh2, db2)
  min(R + 20, D - 3) against its vjp, D from the plain backward computed
  in float64 around the same bf16 values: its reverse walk is a chain of
  T steps, where a rounding of dgates to bf16 that flips (its float32
  input moved by float32 rounding) moves the carried cotangent by a bf16
  step and flips more downstream, so float32 rounding alone puts the
  plain version only R + 13 to R + 25 from float64 (the weight gradients
  lowest). The TCM-chain backward is held one TCM at a time: TCM j alone
  (``_chain`` with a float32 x, a float32 cotangent and bf16 weights, on
  the float32 trunk and cotangent the reference chain gives it), its
  float32 cotangent out at R + 20. Its weight gradients, each summed over
  B T rows and rounded to bf16 once, are printed there and held with the
  whole chain: every output of the chain at min(R + 20, D - 3), D from
  the plain version computed in float64 around the same bf16 operands.
  (One TCM's gradient against the reference's sits at R + 16 to R + 24
  wherever a single bf16 rounding inside the TCM goes the other way in
  the two, which a float64 run of one implementation need not show at
  these sizes.)
- Step level: each parameter tensor's gradient of the port's bf16 step
  must reach R_g - 6 dB against JAX's bf16 gradient, R_g between JAX's
  bf16 and float32 gradients of that tensor; and the whole gradient (the
  tensors scaled to unit rms and joined) R_g - 3 to R_g + 10 against
  JAX's float32 (the port's float32 step, the control, must fall above),
  and each kind of parameter (PReLU slopes, norm scales, norm biases,
  kernels, ...) joined so at R_g - 3. Per tensor the float32 rule does not
  hold everywhere (12 of 546 tensors, R_g - 3 to R_g - 6, printed), and
  the cause is a rounding point: the gradient of a parameter broadcast
  over (B, T, F) is a sum over those axes, which PyTorch's bf16 autograd
  accumulates in float32 and rounds once, where XLA on the CPU adds in
  bf16 (``test_bf16_parameter_gradients_sum_in_float32``: 1.9e-2 against
  2.0e-3 relative; IN's scale and bias gradients alone 16 dB nearer
  float32 in the port). The two bf16 runs then carry different noise
  down the network; per kind their noise power against float32 is the
  same (the port's 0.82-1.14x JAX's), and a small tensor (16-64 slopes
  or gains) is one sample of it.

The golden ``tests/golden/torch_port_train_composed_9mic_bf16.npz`` holds
the JAX package's losses of the card's bf16 run (release/composed_9mic
from 40000.params, joint, bf16 compute with the Pallas LSTM-BF and TCM
chain in interpret mode, the 7 val items as one batch, 5 steps) beside its
float32 losses of the same steps (those of
``torch_port_train_composed_9mic.npz``). The JAX steps are taken one item
at a time (``jax_bf16_item_steps``), each step's gradient the mean of the
7 items' float32 gradients; in bf16 each item's weight gradients are
rounded to bf16 before that mean, where a batch step rounds their sum
once, a difference far below bf16's own distance from float32. Rewrite it
(~4 GB, tens of minutes on the CPU) with

    python tests/test_torch_lowp_train.py --regen
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests"))

EXP = os.path.join(ROOT, "release", "composed_9mic")
GOLDEN = os.path.join(ROOT, "tests", "golden",
                      "torch_port_train_composed_9mic_bf16.npz")
F32_GOLDEN = os.path.join(ROOT, "tests", "golden",
                          "torch_port_train_composed_9mic.npz")
N_STEPS = 5
KEYS = ("eabnet", "postnet", "final")


def golden_config_dict():
    """The card's bf16 training run: the float32 golden's configuration
    with the release's compute dtype and the Pallas paths."""
    from test_torch_train_golden import golden_config_dict as f32_config

    d = f32_config()
    d["train"]["compute_dtype"] = "bfloat16"
    d["model"]["eabnet"].update(bf_impl="pallas", tcn_impl="pallas")
    d["model"]["gagnet"]["tcn_impl"] = "pallas"
    return d


def jax_mixed_loss(cfg, model, compute="bfloat16"):
    """The JAX package's mixed-precision loss, as ``make_train_step``'s
    ``loss_fn`` takes it: float32 features cast to ``compute``, the
    float32 params cast to it inside the differentiated function, the
    outputs cast back to float32 before the mask and the loss (float32:
    no cast). -> loss(params, noisy, target, n_samples) -> (final,
    losses)."""
    import jax
    import jax.numpy as jnp

    dtype = jnp.dtype(compute)

    from eabnet_tpu.dsp import prepare_data
    from eabnet_tpu.losses import eabnet_with_postnet_loss, frame_mask
    from eabnet_tpu.models.eabnet import from_reference_layout
    from eabnet_tpu.train.step import _dequant, _valid_frames

    def loss_fn(p, noisy, target, n_samples):
        noisy, target = _dequant(noisy), _dequant(target)
        noisy_stft, target_stft = prepare_data(noisy, target, cfg.stft)
        target = from_reference_layout(target_stft)
        noisy_stft = noisy_stft.astype(dtype)
        p = jax.tree.map(lambda v: v.astype(dtype), p)
        out = model.apply({"params": p}, noisy_stft, train=True)
        out = jax.tree.map(lambda v: v.astype(jnp.float32), out)
        t = noisy_stft.shape[1]
        mask = frame_mask(_valid_frames(n_samples, t, cfg, noisy.shape[-1]),
                          t)
        losses = eabnet_with_postnet_loss(out, target, mask)
        return losses["final"], losses

    return loss_fn


def jax_bf16_item_steps(cfg, params, items, n_steps):
    """n_steps of the JAX package's optimizer on the mean of per-item bf16
    gradients. -> (per-step batch losses (n_steps, 3), final params)."""
    import jax
    import jax.numpy as jnp
    import optax

    from eabnet_tpu.models import build_model
    from eabnet_tpu.train.step import make_optimizer

    grad_fn = jax.jit(jax.value_and_grad(
        jax_mixed_loss(cfg, build_model(cfg.model)), has_aux=True))
    tx = make_optimizer(cfg)
    opt = tx.init(params)
    step_losses = []
    for _ in range(n_steps):
        grads, per_item = None, []
        for noisy, target in items:
            n = jnp.full((1,), noisy.shape[-1], jnp.int32)
            (_, losses), g = grad_fn(params, noisy[None], target[None], n)
            per_item.append([float(losses[k]) for k in KEYS])
            grads = g if grads is None else jax.tree.map(jnp.add, grads, g)
        grads = jax.tree.map(lambda v: v / len(items), grads)
        updates, opt = tx.update(grads, opt, params)
        params = optax.apply_updates(params, updates)
        step_losses.append(np.mean(per_item, axis=0))
        print(f"step {len(step_losses)}: {step_losses[-1].tolist()}",
              flush=True)
    return np.asarray(step_losses), params


def regen(n_steps=N_STEPS):
    import jax

    from eabnet_tpu.config import ExperimentConfig
    from eabnet_tpu.data.datasets import OfflineMcseDataset
    from eabnet_tpu.train.checkpoint import latest_checkpoint
    from flax import serialization

    jax.config.update("jax_platforms", "cpu")
    d = golden_config_dict()
    cfg = ExperimentConfig.from_dict(d)
    with open(latest_checkpoint(EXP), "rb") as f:
        params = serialization.msgpack_restore(f.read())["params"]
    ds = OfflineMcseDataset(os.path.join(ROOT, d["data"]["speech_root"]),
                            transfer_int16=True)
    items = [ds[i] for i in range(len(ds))]
    losses, _ = jax_bf16_item_steps(cfg, params, items, n_steps)
    f32 = np.load(F32_GOLDEN)
    np.savez(GOLDEN, losses=losses, losses_f32=f32["losses"][:n_steps],
             names=np.asarray(ds.names), config=json.dumps(d))
    print(f"wrote {GOLDEN}:\n{losses}")


# ------------------------------------------------------------------ tests
BF16 = torch.bfloat16
KERNEL_MARGIN_DB = 20.0    # plain vs reference kernel: R + this ...
SPREAD_DB = 3.0            # ... a whole TCM chain: or D - this, if lower
STEP_BF16_DB = 6.0         # a step's gradient vs the reference's bf16
STEP_F32_DB = 3.0          # ... and vs its float32: R_g - these
STEP_F32_CAP_DB = 10.0     # ... and at most R_g + this from float32


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
    import jax.numpy as jnp
    import torch

    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def rule(what, ours, j16, j32, wide=None):
    """R + 20 dB (a whole TCM chain: min(R + 20, D - 3)), printed; True
    where it holds. A reference that is zero (a single-branch chain's
    unused gradients) must be matched exactly."""
    ours, j16, j32 = f32(ours), f32(j16), f32(j32)
    if not np.any(j16):
        print(f"{what}: zero in the reference, ours zero: {not ours.any()}")
        return not ours.any()
    r, got = snr_db(j32, j16), snr_db(j16, ours)
    need, d = r + KERNEL_MARGIN_DB, ""
    if wide is not None:
        dv = snr_db(f32(wide), ours)
        need, d = min(need, dv - SPREAD_DB), f", D {dv:.2f} dB"
    print(f"{what}: R {r:.2f} dB{d}, plain bf16 vs Pallas bf16 {got:.2f} dB "
          f"(R + {got - r:.2f}; needs {need:.2f}), largest entry gap "
          f"{np.abs(ours - j16).max():.3e}")
    return got >= need


# ---------------------------------------------------------------- LSTM-BF
def lstm_inputs(t=64, lanes=24, seed=0):
    """xw1 and the recurrent weights of a flax-initialised head, float32,
    and a cotangent of h2 rounded to bf16."""
    from test_torch_lowp import lstm_inputs as inputs

    args = inputs(t=t, lanes=lanes, seed=seed)
    dy = np.random.default_rng(seed + 100).standard_normal((t, lanes, 64))
    return args, torch.from_numpy(dy).to(BF16).float().numpy()


@pytest.mark.parametrize("seed", [0, 1])
def test_lstm_plain_bf16_backward_against_pallas(seed):
    """The training forward's four sequences against the Pallas forward's
    (R + 20 dB), and the backward's five outputs against the Pallas
    backward on the same saved sequences (min(R + 20, D - 3)), bf16,
    interpret mode; R from both in float32 on float32 inputs."""
    import jax.numpy as jnp

    from eabnet_tpu.kernels.lstm_bf import _double_lstm_bwd, _double_lstm_fwd
    from eabnet_tpu_torch.kernels.lstm_bf import (
        double_lstm_bwd_reference, double_lstm_states_reference)

    args, dy = lstm_inputs(seed=seed)
    ref = {}
    for name, dt in (("j32", jnp.float32), ("j16", jnp.bfloat16)):
        ja = [jnp.asarray(a).astype(dt) for a in args]
        _, res = _double_lstm_fwd(*ja, True)
        ref[name] = (res[5:], _double_lstm_bwd(True, res,
                                               jnp.asarray(dy).astype(dt)))
    a16 = [torch.from_numpy(a).to(BF16) for a in args]
    states = double_lstm_states_reference(*a16)
    assert all(s.dtype == BF16 for s in states)
    ok = [rule(f"lstm state {n}", s, j16, j32) for n, s, j16, j32 in zip(
        ("h1", "c1", "h2", "c2"), states, ref["j16"][0], ref["j32"][0])]
    # the backward on the Pallas forward's own sequences
    saved = [torch.from_numpy(f32(a)).to(BF16) for a in ref["j16"][0]]
    dy16 = torch.from_numpy(dy).to(BF16)
    grads = double_lstm_bwd_reference(a16[0], dy16, *saved, *a16[1:])
    wide = double_lstm_bwd_reference(a16[0], dy16, *saved, *a16[1:],
                                     compute=torch.float64)
    assert all(g.dtype == BF16 for g in grads)
    ok += [rule(f"lstm {n}", g, j16, j32, w) for n, g, j16, j32, w in zip(
        ("dxw1", "dw_hh1", "dw_ih2", "dw_hh2", "db2"), grads,
        ref["j16"][1], ref["j32"][1], wide)]
    assert all(ok)


def test_lstm_bf16_autograd_is_the_plain_backward():
    """Under autograd a bf16 CPU tensor takes the plain bf16 backward, bit
    for bit, and launches nothing."""
    import torch

    from eabnet_tpu_torch.kernels.lstm_bf import (
        double_lstm, double_lstm_bwd_reference, double_lstm_states_reference)

    args, dy = lstm_inputs(t=12, lanes=5)
    a16 = [torch.from_numpy(a).to(BF16).requires_grad_() for a in args]
    dy16 = torch.from_numpy(dy).to(BF16)
    before = (double_lstm.launches, double_lstm.bwd_launches)
    out = double_lstm(*a16)
    got = torch.autograd.grad(out, a16, dy16)
    with torch.no_grad():
        states = double_lstm_states_reference(*a16)
        want = double_lstm_bwd_reference(a16[0], dy16, *states, *a16[1:])
    for g, w in zip(got, want):
        assert g.dtype == BF16 and torch.equal(g, w)
    assert (double_lstm.launches, double_lstm.bwd_launches) == before


# ------------------------------------------------------------ TCM chain
def tcm_inputs(twin, kd1, dils, seed):
    """x (B, T, D), a flax-initialised group (the JAX params and the port
    module) and a cotangent, float32."""
    from test_torch_lowp import tcm_group

    x, params, tg = tcm_group(twin, kd1, dils, seed)
    dy = np.random.default_rng(seed + 100).standard_normal(
        x.shape).astype(np.float32)
    return x, dy, params, tg


def jax_chain_vjp(x, dy, weights, dils, twin, dtype, x_dtype=None):
    """JAX's ``_chain`` vjp (interpret mode): x and dy in ``x_dtype``
    (default ``dtype``), the weights in ``dtype`` -> (dx, weight grads)."""
    import jax
    import jax.numpy as jnp

    from eabnet_tpu.kernels.tcm_chain import _chain

    xd = x_dtype or dtype
    jw = tuple(jnp.asarray(f32(w)).astype(dtype) for w in weights)
    _, vjp = jax.vjp(lambda a, w: _chain(a, w, tuple(dils), twin, True),
                     jnp.asarray(f32(x)).astype(xd), jw)
    dx, dw = vjp(jnp.asarray(f32(dy)).astype(xd))
    return dx, dw


NAMES = ("dx", "dwi", "dwl", "dwr", "dwo", "dalphas", "dgammas", "dbetas")
CASES = [(True, 5, (1, 2, 4)), (False, 3, (1, 2, 5, 9))]
IDS = ["twin", "single"]


@pytest.mark.parametrize("twin,kd1,dils", CASES, ids=IDS)
def test_tcm_plain_bf16_backward_each_tcm_against_pallas(twin, kd1, dils):
    """Each TCM alone, on the float32 trunk and float32 cotangent that the
    reference chain gives it: its cotangent out (float32) at R + 20 dB, R
    from the same TCM with float32 weights; its weight gradients printed
    (held with the whole chain, module doc)."""
    import jax.numpy as jnp
    import torch

    from eabnet_tpu.kernels.tcm_chain import _chain
    from eabnet_tpu_torch.kernels.tcm_chain import tcm_chain_bwd_reference

    x, dy, _, tg = tcm_inputs(twin, kd1, dils, seed=0)
    w32 = tuple(w.detach() for w in tg.stacked_weights())
    w16 = tuple(w.to(BF16) for w in w32)
    # the reference chain's float32 trunk into each TCM
    trunks = [torch.from_numpy(x).to(BF16).float()]
    for j, dil in enumerate(dils[:-1]):
        trunks.append(torch.from_numpy(f32(_chain(
            jnp.asarray(trunks[-1].numpy()),
            tuple(jnp.asarray(f32(w[j:j + 1])).astype(jnp.bfloat16)
                  for w in w16), (dil,), twin, True))))
    cot = torch.from_numpy(dy).to(BF16).float()
    ok = []
    for j in range(len(dils) - 1, -1, -1):
        wj = [tuple(w[j:j + 1] for w in ws) for ws in (w32, w16)]
        j32 = jax_chain_vjp(trunks[j], cot, wj[0], dils[j:j + 1], twin,
                            jnp.float32)
        j16 = jax_chain_vjp(trunks[j], cot, wj[1], dils[j:j + 1], twin,
                            jnp.bfloat16, jnp.float32)
        dx, dw = tcm_chain_bwd_reference(trunks[j], cot, wj[1], dils[j:j + 1],
                                         twin)
        assert dx.dtype == torch.float32 and dw[0].dtype == BF16
        ok.append(rule(f"tcm {j} dx", dx, j16[0], j32[0]))
        for n, o, a, b in zip(NAMES[1:], dw, j16[1], j32[1]):
            rule(f"tcm {j} {n} (printed)", o, a, b)
        cot = torch.from_numpy(f32(j16[0]))  # the cotangent into TCM j - 1
    assert all(ok)


@pytest.mark.parametrize("twin,kd1,dils", CASES, ids=IDS)
def test_tcm_plain_bf16_backward_whole_chain_against_pallas(twin, kd1, dils):
    """The whole chain's dx and weight gradients at min(R + 20, D - 3)."""
    import jax.numpy as jnp
    import torch

    from eabnet_tpu_torch.kernels.tcm_chain import tcm_chain_bwd_reference

    x, dy, _, tg = tcm_inputs(twin, kd1, dils, seed=1)
    w32 = tuple(w.detach() for w in tg.stacked_weights())
    w16 = tuple(w.to(BF16) for w in w32)
    x16, dy16 = (torch.from_numpy(a).to(BF16) for a in (x, dy))
    j32 = jax_chain_vjp(x16, dy16, w32, dils, twin, jnp.float32)
    j16 = jax_chain_vjp(x16, dy16, w16, dils, twin, jnp.bfloat16)
    dx, dw = tcm_chain_bwd_reference(x16, dy16, w16, dils, twin)
    wdx, wdw = tcm_chain_bwd_reference(x16, dy16, w16, dils, twin,
                                       compute=torch.float64)
    assert dx.dtype == BF16
    ok = [rule(f"tcm chain {n}", o, a, b, wide) for n, o, a, b, wide in zip(
        NAMES, (dx,) + dw, (j16[0],) + tuple(j16[1]),
        (j32[0],) + tuple(j32[1]), (wdx,) + wdw)]
    assert all(ok)


@pytest.mark.parametrize("twin,kd1,dils", CASES, ids=IDS)
def test_tcm_plain_bf16_backward_recomputes_the_forward_trunk(twin, kd1,
                                                              dils):
    """The float32 trunk the plain bf16 backward recomputes (the input of
    each TCM after the first) is the plain bf16 forward's, TCM by TCM, bit
    for bit: that forward is held to JAX's ``_chain`` one TCM at a time
    (tests/test_torch_lowp.py), and the reverse walk takes this trunk's
    bf16 roundings as its operands."""
    import torch

    from eabnet_tpu_torch.kernels.tcm_chain import (
        tcm_chain_activations_reference, tcm_chain_reference)

    x, _, _, tg = tcm_inputs(twin, kd1, dils, seed=4)
    w16 = tuple(w.detach().to(BF16) for w in tg.stacked_weights())
    x16 = torch.from_numpy(x).to(BF16)
    acts = tcm_chain_activations_reference(x16, w16, dils, twin)
    assert acts["x"].shape[0] == len(dils) - 1
    trunk = x16.float()
    for j, dil in enumerate(dils[:-1]):
        trunk = tcm_chain_reference(trunk, tuple(w[j:j + 1] for w in w16),
                                    (dil,), twin)
        assert acts["x"][j].dtype == torch.float32
        assert torch.equal(acts["x"][j], trunk), j


@pytest.mark.parametrize("twin,kd1,dils", CASES, ids=IDS)
def test_tcm_plain_bf16_weight_gradients_are_rounded_once(twin, kd1, dils):
    """The Pallas backward sums every weight gradient in float32 over the
    batch and rounds it to bf16 once: one TCM's dwo equals the float64 sum
    of its rounded operands (no and the cotangent) rounded once, to the
    float32 summation's own flips (at least 68 dB, chip_smoke's
    LOWP_SUM_DB; one more rounding of partial sums costs ~59)."""
    from eabnet_tpu_torch.kernels.tcm_chain import (_forward_saves,
                                                    tcm_chain_bwd_reference)

    x, dy, _, tg = tcm_inputs(twin, kd1, dils, seed=3)
    t = 200  # many 16-frame tiles
    x = np.concatenate([x] * 5, axis=1)[:, :t]
    dy = np.concatenate([dy] * 5, axis=1)[:, :t]
    w16 = tuple(w.detach().to(BF16)[:1] for w in tg.stacked_weights())
    xf, dyf = (torch.from_numpy(a).to(BF16).float() for a in (x, dy))
    _, dw = tcm_chain_bwd_reference(xf, dyf, w16, dils[:1], twin)
    _, saves = _forward_saves(xf, tuple(w.float() for w in w16), dils[:1],
                              twin, None, lowp=True)
    ref = torch.einsum("btc,btd->cd", saves[0]["no"].to(BF16).double(),
                       dyf.to(BF16).double()).to(BF16)
    got = snr_db(f32(ref), f32(dw[3][0]))
    print(f"dwo against the float64 sum of its operands: {got:.2f} dB")
    assert got >= 68.0


def test_tcm_bf16_autograd_is_the_plain_backward():
    """Under autograd a bf16 CPU tensor takes the plain bf16 backward, bit
    for bit, and launches nothing."""
    import torch

    from eabnet_tpu_torch.kernels.tcm_chain import (tcm_chain,
                                                    tcm_chain_bwd_reference)

    twin, kd1, dils = CASES[0]
    x, dy, _, tg = tcm_inputs(twin, kd1, dils, seed=2)
    w16 = [w.detach().to(BF16).requires_grad_() for w in tg.stacked_weights()]
    x16 = torch.from_numpy(x).to(BF16).requires_grad_()
    dy16 = torch.from_numpy(dy).to(BF16)
    before = (tcm_chain.launches, tcm_chain.bwd_launches)
    got = torch.autograd.grad(tcm_chain(x16, tuple(w16), dils, twin),
                              [x16] + w16, dy16)
    with torch.no_grad():
        dx, dw = tcm_chain_bwd_reference(x16, dy16, tuple(w16), dils, twin)
    for g, w in zip(got, (dx,) + dw):
        assert g.dtype == BF16 and torch.equal(g, w)
    assert (tcm_chain.launches, tcm_chain.bwd_launches) == before


# --------------------------------------------------------------- the step
STEP_BATCH, STEP_N = 2, 3200


def step_cfg(norm):
    """A small composed model at the kernels' widths (C = 64, H = 64) with
    the Pallas paths, bf16 compute."""
    from eabnet_tpu.config import (ComposedConfig, DataConfig, EaBNetConfig,
                                   ExperimentConfig, GaGNetConfig,
                                   TrainConfig)

    return ExperimentConfig(
        model=ComposedConfig(
            eabnet=EaBNetConfig(c=16, M=3, embed_dim=16, cd1=64, p=2, q=2,
                                hid_node=64, norm_type=norm, is_u2=False,
                                bf_impl="pallas", tcn_impl="pallas"),
            gagnet=GaGNetConfig(c=16, cd1=64, p=1, q=2, dilas=(1, 2),
                                norm_type=norm, is_u2=False,
                                tcn_impl="pallas"),
            freeze_eabnet=False),
        data=DataConfig(dataset="fake"),
        train=TrainConfig(batch_size=STEP_BATCH, wav_len=0.2, lr=5e-4,
                          grad_clip=1.0, compute_dtype="bfloat16"))


def step_batch(seed=0):
    rng = np.random.default_rng(seed)
    clean = (rng.standard_normal((STEP_BATCH, STEP_N)) * 0.1).astype(
        np.float32)
    noisy = (clean[:, None] * 0.8 + rng.standard_normal(
        (STEP_BATCH, 3, STEP_N)) * 0.05).astype(np.float32)
    return noisy, clean, np.full((STEP_BATCH,), STEP_N, np.int32)


def jax_grads(cfg, params, batch, compute):
    """JAX's gradients of the step's loss in ``compute`` (bfloat16: mixed
    precision, the Pallas kernels in interpret mode; float32: the
    scan / XLA paths, which the JAX package's tests hold to the Pallas
    ones in float32)."""
    import dataclasses

    import jax

    from eabnet_tpu.models import build_model

    if compute == "float32":
        m = cfg.model
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            m, eabnet=dataclasses.replace(m.eabnet, bf_impl="scan",
                                          tcn_impl="xla"),
            gagnet=dataclasses.replace(m.gagnet, tcn_impl="xla")))
    loss = jax_mixed_loss(cfg, build_model(cfg.model), compute)
    return jax.grad(lambda p: loss(p, *batch)[0])(params)


def test_bf16_parameter_gradients_sum_in_float32():
    """The gradient of a bf16 parameter broadcast over (B, T, F), as a norm
    scale or a PReLU slope is, is the sum over those axes accumulated in
    float32 and rounded to bf16 once (the Pallas kernels' rule for their
    weight gradients): within one bf16 rounding of the float64 sum. JAX
    on the CPU adds in bf16 (printed; the cause of the step test's
    per-tensor spread, module doc)."""
    import jax
    import jax.numpy as jnp
    import torch

    rng = np.random.default_rng(0)
    x16, dy16 = (torch.from_numpy(rng.standard_normal((2, 300, 7, 16)) + m)
                 .to(BF16) for m in (0.5, 0.0))
    exact = (x16.double() * dy16.double()).sum(dim=(0, 1, 2)).numpy()
    s = torch.ones(16, dtype=BF16, requires_grad=True)
    (x16 * s).backward(dy16)
    ours = np.abs(f32(s.grad) - exact).max() / np.abs(exact).max()
    _, vjp = jax.vjp(lambda v: jnp.asarray(f32(x16)).astype(jnp.bfloat16) * v,
                     jnp.ones((16,), jnp.bfloat16))
    theirs = np.abs(f32(vjp(jnp.asarray(f32(dy16)).astype(
        jnp.bfloat16))[0]) - exact).max() / np.abs(exact).max()
    print(f"scale gradient, largest relative error: ours {ours:.2e}, JAX "
          f"(CPU) {theirs:.2e}, one bf16 rounding {2.0 ** -9:.2e}")
    assert s.grad.dtype == BF16 and ours <= 2.0 ** -8


def param_kind(name):
    """A parameter's kind, by the end of its name: PReLU slope, norm scale
    or bias, kernel, bias, LSTM weight or bias."""
    for kind in ("alpha", "norm.scale", "norm.bias", "kernel", "bias"):
        if name.endswith(kind):
            return kind
    return name.rsplit(".", 1)[-1]


@pytest.mark.parametrize("norm", ["IN", "cLN"])
def test_bf16_step_gradients_meet_the_step_rule(norm):
    """Each parameter tensor's gradient of the port's bf16 step against
    JAX's mixed-precision gradient at R_g - 6 dB, and the whole gradient
    against JAX's float32 at R_g - 3 to R_g + 10 (module doc; the port's
    float32 step, the control, lies above R_g + 10), each kind of
    parameter joined so at R_g - 3. A conv bias right
    before an instance norm has no effect on the loss: its gradient is
    rounding noise in every version and is left out."""
    import re

    import jax
    import torch

    from eabnet_tpu.train.step import create_train_state
    from eabnet_tpu_torch.config import ExperimentConfig as PConfig
    from eabnet_tpu_torch.models import build_model
    from eabnet_tpu_torch.train.step import _forward_losses
    from eabnet_tpu_torch.weights import (flatten_tree, load_jax_params,
                                          to_jax_tree)

    cancelled = re.compile(r"\.(enco|deco)_\d+\.conv\.bias$")
    cfg = step_cfg(norm)
    _, state = create_train_state(cfg, jax.random.key(0))
    params = jax.tree.map(np.asarray, state.params)
    batch = step_batch()
    g16, g32 = (flatten_tree(jax.tree.map(f32, jax_grads(
        cfg, params, batch, dt))) for dt in ("bfloat16", "float32"))
    pcfg = PConfig.from_json(cfg.to_json())
    model = load_jax_params(build_model(pcfg.model), params).train()
    losses, _ = _forward_losses(model, pcfg,
                                *(torch.from_numpy(a) for a in batch),
                                compute=torch.bfloat16)
    losses["final"].backward()
    ours = flatten_tree(to_jax_tree(model, {
        n: p.grad for n, p in model.named_parameters()}))
    assert ours.keys() == g16.keys()
    bad = []
    for k, want in g16.items():
        if cancelled.search(k):
            continue
        r, s16 = snr_db(g32[k], want), snr_db(want, ours[k])
        if s16 < r - STEP_BF16_DB:
            bad.append(f"{k}: R_g {r:.2f}, vs bf16 {s16:.2f}")
    print(f"{norm}: {len(g16)} gradients, outside the rule: {bad}")
    assert not bad
    # against float32: the whole gradient, every tensor scaled to unit rms
    # in JAX float32 (per tensor: printed)
    keys = [k for k in g16 if not cancelled.search(k)]
    scale = {k: 1 / np.sqrt(np.mean(np.square(g32[k], dtype=np.float64)))
             for k in keys}
    # the control: the port's float32 step on the same params and batch
    model32 = load_jax_params(build_model(pcfg.model), params).train()
    losses, _ = _forward_losses(model32, pcfg,
                                *(torch.from_numpy(a) for a in batch))
    losses["final"].backward()
    ours32 = flatten_tree(to_jax_tree(model32, {
        n: p.grad for n, p in model32.named_parameters()}))
    cat = {n: np.concatenate([(d[k] * scale[k]).ravel() for k in keys])
           for n, d in (("j32", g32), ("j16", g16), ("ours", ours),
                        ("ours32", ours32))}
    r, got = snr_db(cat["j32"], cat["j16"]), snr_db(cat["j32"], cat["ours"])
    control = snr_db(cat["j32"], cat["ours32"])
    per = sorted((r_k - s_k, k) for k, r_k, s_k in (
        (k, snr_db(g32[k], g16[k]), snr_db(g32[k], ours[k])) for k in keys))
    print(f"{norm}: whole gradient R_g {r:.2f} dB, ours vs JAX float32 "
          f"{got:.2f} (R_g - {r - got:.2f}; the port's float32 step "
          f"{control:.2f}); per tensor, the largest R_g minus ours vs "
          f"float32: {per[-4:]}")
    # bf16's noise, neither much less nor more than JAX's; the same step
    # in float32 falls outside
    assert r - STEP_F32_DB <= got <= r + STEP_F32_CAP_DB
    assert control > r + STEP_F32_CAP_DB
    # each kind of parameter joined the same way (PReLU slopes, norm
    # scales and biases, kernels, ...): R_g - 3 against JAX float32
    kinds = {}
    for k in keys:
        kinds.setdefault(param_kind(k), []).append(k)
    low = []
    for kind, ks in sorted(kinds.items()):
        cat = {n: np.concatenate([(d[k] * scale[k]).ravel() for k in ks])
               for n, d in (("j32", g32), ("j16", g16), ("ours", ours))}
        r_k = snr_db(cat["j32"], cat["j16"])
        s_k = snr_db(cat["j32"], cat["ours"])
        print(f"{norm} {kind} ({len(ks)} tensors): R_g {r_k:.2f} dB, ours "
              f"vs JAX float32 {s_k:.2f}")
        if s_k < r_k - STEP_F32_DB:
            low.append(kind)
    assert not low


@pytest.mark.parametrize("norm", ["IN", "cLN", "cLN-ref", "BN"])
def test_norms_under_bf16_autograd(norm):
    """Each norm of the port in bf16 under autograd against the JAX
    package's (flax BN in training mode) in bf16: the output in bf16 and
    the gradients of the input, scale and bias at R - 6 dB (the model
    rule), R between JAX's bf16 and float32. IN takes its statistics in
    x's dtype, cLN and BN in float32, in both packages."""
    import jax
    import jax.numpy as jnp

    from eabnet_tpu.nn.norms import NormSwitch as JNorm
    from eabnet_tpu_torch.nn.norms import NormSwitch
    from eabnet_tpu_torch.weights import load_jax_params

    rng = np.random.default_rng(3)
    x = (rng.standard_normal((2, 30, 7, 16)) * 2 + 0.5).astype(np.float32)
    dy = rng.standard_normal(x.shape).astype(np.float32)
    jn = JNorm(norm, 16)
    variables = jn.init(jax.random.key(0), x, train=True)
    params = jax.tree.map(
        lambda v: v + rng.standard_normal(v.shape).astype(np.float32) * 0.1,
        jax.tree.map(np.asarray, variables["params"]))

    def jax_vjp(dt):
        def f(p, a):
            v = {"params": p}
            if norm == "BN":
                v["batch_stats"] = variables["batch_stats"]
                return jn.apply(v, a, train=True, mutable=["batch_stats"])[0]
            return jn.apply(v, a, train=True)
        p = jax.tree.map(lambda v: jnp.asarray(v).astype(dt), params)
        out, vjp = jax.vjp(f, p, jnp.asarray(x).astype(dt))
        dp, dx = vjp(jnp.asarray(dy).astype(dt))
        leaf = dp["norm"] if "norm" in dp else dp
        return out, dx, leaf["scale"], leaf["bias"]

    j32, j16 = jax_vjp(jnp.float32), jax_vjp(jnp.bfloat16)
    assert j16[0].dtype == jnp.bfloat16
    mod = load_jax_params(NormSwitch(norm, 16), params).to(BF16).train()
    for b in mod.buffers():  # flax keeps batch_stats float32
        b.data = b.data.float()
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).to(BF16).requires_grad_()
    out = mod(xt)
    assert out.dtype == BF16
    out.backward(torch.from_numpy(dy).permute(0, 3, 1, 2).to(BF16))
    ours = (out.permute(0, 2, 3, 1), xt.grad.permute(0, 2, 3, 1),
            mod.norm.scale.grad, mod.norm.bias.grad)
    bad = []
    for name, o, a, b in zip(("out", "dx", "dscale", "dbias"), ours, j16,
                             j32):
        r, got = snr_db(f32(b), f32(a)), snr_db(f32(a), f32(o))
        print(f"{norm} {name}: R {r:.2f} dB, ours vs JAX bf16 {got:.2f}, "
              f"vs JAX float32 {snr_db(f32(b), f32(o)):.2f}")
        if got < r - STEP_BF16_DB:
            bad.append(name)
    assert not bad


def test_batch_stats_stay_float32_under_bf16():
    """A BN model's bf16 step: flax's mutated batch_stats come back float32
    (the statistics are float32 reductions of the bf16 activations), and
    the port's running statistics stay float32 buffers with those
    values."""
    import jax
    import jax.numpy as jnp
    import torch

    from eabnet_tpu.dsp import prepare_data
    from eabnet_tpu.models import build_model as build_jax
    from eabnet_tpu.train.step import create_train_state
    from eabnet_tpu_torch.config import ExperimentConfig as PConfig
    from eabnet_tpu_torch.models import build_model
    from eabnet_tpu_torch.train.step import _forward_losses
    from eabnet_tpu_torch.weights import (flatten_tree, load_jax_batch_stats,
                                          load_jax_params,
                                          to_jax_batch_stats)

    cfg = step_cfg("BN")
    _, state = create_train_state(cfg, jax.random.key(0))
    noisy, clean, n = step_batch(1)
    stft, _ = prepare_data(jnp.asarray(noisy), jnp.asarray(clean), cfg.stft)
    p16 = jax.tree.map(lambda v: v.astype(jnp.bfloat16), state.params)
    _, mutated = build_jax(cfg.model).apply(
        {"params": p16, "batch_stats": state.batch_stats},
        stft.astype(jnp.bfloat16), train=True, mutable=["batch_stats"])
    want = flatten_tree(jax.tree.map(np.asarray, mutated["batch_stats"]))
    assert {v.dtype for v in want.values()} == {np.dtype(np.float32)}
    model = build_model(PConfig.from_json(cfg.to_json()).model)
    load_jax_params(model, jax.tree.map(np.asarray, state.params))
    load_jax_batch_stats(model, jax.tree.map(np.asarray, state.batch_stats))
    model.train()
    with torch.enable_grad():
        _forward_losses(model, PConfig.from_json(cfg.to_json()),
                        *(torch.from_numpy(a) for a in (noisy, clean, n)),
                        compute=torch.bfloat16)
    got = flatten_tree(to_jax_batch_stats(model))
    assert got.keys() == want.keys()
    assert all(b.dtype == torch.float32 for b in model.buffers())
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=2e-2,
                                   atol=2e-2 * np.abs(v).max(), err_msg=k)


if __name__ == "__main__":
    if "--regen" not in sys.argv:
        sys.exit("usage: python tests/test_torch_lowp_train.py --regen "
                 "[--steps N]")
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, ROOT)
    steps = (int(sys.argv[sys.argv.index("--steps") + 1])
             if "--steps" in sys.argv else N_STEPS)
    regen(steps)
