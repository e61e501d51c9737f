"""The port's train step against the JAX package's ``make_train_step``: the
same init (the JAX init carried across with ``load_jax_params``), the same
batches (one item shorter than the batch, so the frame mask is not all
ones), three steps; losses per step, parameters and Adam moments after.
Also the optimizer's pieces alone against optax, and ``freeze_eabnet``.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from eabnet_tpu.config import (ComposedConfig, DataConfig, EaBNetConfig,
                               ExperimentConfig, GaGNetConfig, TrainConfig)
from eabnet_tpu.models import build_model as build_jax_model
from eabnet_tpu.train.step import TrainState as JTrainState
from eabnet_tpu.train.step import (create_train_state, make_optimizer,
                                   make_train_step)
from eabnet_tpu_torch.config import ExperimentConfig as PExperimentConfig
from eabnet_tpu_torch.models import build_model
from eabnet_tpu_torch.train import step as P
from eabnet_tpu_torch.weights import (flatten_tree, from_jax_tree,
                                      load_jax_batch_stats, load_jax_params,
                                      to_jax_batch_stats, to_jax_tree)

N_STEPS, BATCH, N = 3, 3, 3200
# The bias of a conv right before an instance norm has no effect on the
# output (the norm removes it), so its gradient is float32 rounding noise
# in both packages and Adam turns that noise into +-lr moves: these leaves
# are held to Adam's step bound only.
IN_CANCELLED = re.compile(r"\.(enco|deco)_\d+\.conv\.bias$")
# Measured (CPU, these batches): the free-running losses agree to 3.8e-6
# relative over the 3 steps; a step taken from the same state gives Adam
# moments within 1.05% of each leaf's largest entry (float32 noise of the
# gradients) and parameters within 1.75 lr: Adam moves an element by up
# to ~lr whatever the size of its gradient, so an element whose gradient
# is at the noise floor can move by +lr in one package and -lr in the
# other. The tolerances below are those numbers with margin; the moments
# are the check of the gradients, the parameters only of Adam's bound.
LOSS_RTOL = 1e-5
MOMENT_RTOL = 0.05    # of each leaf's largest entry
PARAM_ATOL = 2.5      # in units of lr


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for the port: on a host that other test workers
    load, more threads mostly wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def small_cfg(freeze=False, norm="IN", is_u2=True):
    return ExperimentConfig(
        model=ComposedConfig(
            eabnet=EaBNetConfig(c=8, M=3, embed_dim=8, cd1=8, p=2, q=1,
                                norm_type=norm, is_u2=is_u2),
            gagnet=GaGNetConfig(c=8, cd1=8, p=1, q=1, dilas=(1, 2),
                                norm_type=norm, is_u2=is_u2),
            freeze_eabnet=freeze),
        data=DataConfig(dataset="fake"),
        train=TrainConfig(batch_size=BATCH, wav_len=0.2, lr=5e-4,
                          grad_clip=1.0))


def batches(seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(N_STEPS):
        clean = (rng.standard_normal((BATCH, N)) * 0.1).astype(np.float32)
        noisy = (clean[:, None] * 0.8 + rng.standard_normal(
            (BATCH, 3, N)) * 0.05).astype(np.float32)
        n_samples = np.array([N, N, N - 700], np.int32)
        noisy[-1, :, n_samples[-1]:] = 0.0
        clean[-1, n_samples[-1]:] = 0.0
        out.append((noisy, clean, n_samples))
    return out


def run_both(freeze):
    """Both packages from one init on the same batches: free-running
    losses, and each step also taken by the port from JAX's state before
    it (so the comparison after each step is free of earlier drift)."""
    cfg = small_cfg(freeze)
    _, state = create_train_state(cfg, jax.random.key(0))
    jstep = make_train_step(cfg, donate=False)
    pcfg = PExperimentConfig.from_json(cfg.to_json())
    params0 = jax.tree.map(np.asarray, state.params)
    free = P.TrainState(0, load_jax_params(build_model(pcfg.model), params0),
                        None)
    free.opt_state = P.adam_init(free.model)
    forced = P.TrainState(0, build_model(pcfg.model), None)
    pstep = P.make_train_step(pcfg)
    jl, pl, steps = [], [], []
    for noisy, clean, n in batches():
        before = jax.tree.map(np.asarray, state)
        state, losses = jstep(state, noisy, clean, n)
        jl.append([float(losses[k]) for k in KEYS])
        args = (torch.from_numpy(noisy), torch.from_numpy(clean),
                torch.from_numpy(n))
        free, losses = pstep(free, *args)
        pl.append([float(losses[k]) for k in KEYS])
        set_state(forced, before)
        forced, _ = pstep(forced, *args)
        steps.append((before, jax.tree.map(np.asarray, state),
                      snapshot(forced)))
    return state, free, np.array(jl), np.array(pl), steps


KEYS = ("eabnet", "postnet", "final")


def set_state(pstate, jstate):
    """The port's state := the JAX package's (params, batch statistics,
    step, Adam)."""
    adam = jstate.opt_state[1][0]
    load_jax_params(pstate.model, jstate.params)
    load_jax_batch_stats(pstate.model, jstate.batch_stats)
    pstate.step = int(jstate.step)
    pstate.opt_state = P.AdamState(
        int(adam.count),
        {k: torch.from_numpy(v) for k, v in
         from_jax_tree(pstate.model, adam.mu).items()},
        {k: torch.from_numpy(v) for k, v in
         from_jax_tree(pstate.model, adam.nu).items()})


def snapshot(pstate):
    """(params, mu, nu) of the port's state as flat JAX-layout dicts."""
    m = pstate.model
    return tuple(flatten_tree(to_jax_tree(m, d)) for d in (
        dict(m.named_parameters()), pstate.opt_state.mu,
        pstate.opt_state.nu))


@pytest.fixture(scope="module", params=[False, True],
                ids=["joint", "freeze_eabnet"])
def runs(request):
    return (request.param,) + run_both(request.param)


def test_losses_per_step(runs):
    _, state, free, jl, pl, _ = runs
    assert free.step == int(state.step) == N_STEPS
    np.testing.assert_allclose(pl, jl, rtol=LOSS_RTOL)
    assert pl[-1, 2] < pl[0, 2]


def test_each_step_from_the_same_state(runs):
    """Parameters and both Adam moments after each step, the port's step
    taken from JAX's state before it."""
    freeze, *_, steps = runs
    lr = small_cfg().train.lr
    for i, (before, after, (params, mu, nu)) in enumerate(steps):
        adam = after.opt_state[1][0]
        start = flatten_tree(before.params)
        for got, want, what in ((params, after.params, "params"),
                                (mu, adam.mu, "mu"), (nu, adam.nu, "nu")):
            want = flatten_tree(want)
            assert got.keys() == want.keys()
            for k, v in want.items():
                msg = f"step {i + 1} {what} {k}"
                if what == "params" and (IN_CANCELLED.search(k)
                                         or k.startswith("eabnet.")
                                         and freeze):
                    # frozen: unchanged bit for bit in both; IN-cancelled:
                    # both moved by at most Adam's step
                    if freeze and k.startswith("eabnet."):
                        assert got[k].tobytes() == start[k].tobytes(), msg
                        assert v.tobytes() == start[k].tobytes(), msg
                    bound = 1.5 * lr
                    assert np.abs(got[k] - start[k]).max() <= bound, msg
                    assert np.abs(v - start[k]).max() <= bound, msg
                elif what == "params":
                    np.testing.assert_allclose(got[k], v,
                                               atol=PARAM_ATOL * lr,
                                               err_msg=msg)
                elif not IN_CANCELLED.search(k):
                    np.testing.assert_allclose(
                        got[k], v, rtol=0,
                        atol=MOMENT_RTOL * np.abs(v).max(), err_msg=msg)


def batch_stft(cfg):
    t = cfg.stft.num_frames(int(cfg.train.wav_len * cfg.stft.sr))
    return jnp.zeros((1, t, cfg.stft.freq_bins, cfg.model.eabnet.M, 2))


def test_batch_norm_step_matches_jax():
    """A BN model (both nets, the plain UNet: a fifth of the U²Net's JAX
    compile time): two train steps, each taken by the port from JAX's
    state before it. The losses (batch statistics in the forward)
    and the running statistics after the step (0.9 ra + 0.1 batch) match
    flax's mutable batch_stats."""
    cfg = small_cfg(norm="BN", is_u2=False)
    # create_train_state's init under jit (its eager flax init is ~30 s)
    model = build_jax_model(cfg.model)
    variables = jax.jit(model.init)(jax.random.key(0), batch_stft(cfg))
    state = JTrainState(step=jnp.zeros((), jnp.int32),
                        params=variables["params"],
                        opt_state=make_optimizer(cfg).init(
                            variables["params"]),
                        batch_stats=variables["batch_stats"])
    jstep = make_train_step(cfg, donate=False)
    pcfg = PExperimentConfig.from_json(cfg.to_json())
    ours = P.TrainState(0, build_model(pcfg.model), None)
    pstep = P.make_train_step(pcfg)
    for noisy, clean, n in batches(seed=3)[:2]:
        set_state(ours, state)
        args = (torch.from_numpy(noisy), torch.from_numpy(clean),
                torch.from_numpy(n))
        state, jl = jstep(state, noisy, clean, n)
        ours, pl = pstep(ours, *args)
        np.testing.assert_allclose([float(pl[k]) for k in KEYS],
                                   [float(jl[k]) for k in KEYS],
                                   rtol=LOSS_RTOL)
        want = flatten_tree(jax.tree.map(np.asarray, state.batch_stats))
        got = flatten_tree(to_jax_batch_stats(ours.model))
        assert got.keys() == want.keys() and len(got) > 0
        for k, v in want.items():
            np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-6,
                                       err_msg=k)


@pytest.mark.parametrize("max_norm", [1e3, 1e-2], ids=["keep", "clip"])
def test_clip_by_global_norm_is_optax(max_norm):
    rng = np.random.default_rng(0)
    tree = {"a": rng.standard_normal((3, 4)).astype(np.float32),
            "b": rng.standard_normal(5).astype(np.float32)}
    ref, _ = optax.clip_by_global_norm(max_norm).update(tree, None)
    got = P.clip_by_global_norm({k: torch.from_numpy(v)
                                 for k, v in tree.items()}, max_norm)
    for k in tree:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-6)


def test_adam_update_is_optax():
    rng = np.random.default_rng(1)
    tx = optax.adam(5e-4)
    params = {"w": np.zeros((4, 3), np.float32)}
    opt = tx.init(params)
    state = P.AdamState(0, {"w": torch.zeros(4, 3)}, {"w": torch.zeros(4, 3)})
    for i in range(5):
        g = (rng.standard_normal((4, 3)) * 10.0 ** -i).astype(np.float32)
        ref, opt = tx.update({"w": g}, opt)
        got = P.adam_update({"w": torch.from_numpy(g)}, state, 5e-4)
        np.testing.assert_allclose(got["w"].numpy(), np.asarray(ref["w"]),
                                   rtol=2e-6)
    assert state.count == int(opt[0].count) == 5
    np.testing.assert_allclose(state.nu["w"].numpy(), np.asarray(opt[0].nu["w"]),
                               rtol=1e-6)
