"""The train step with the cnn and miso beamforming heads in the port
against the JAX package's at a small width, on the same flax parameters
and seeded batches: losses within 1e-5 relative of JAX's, and
``freeze_eabnet`` leaving the head's parameters unchanged in float32 and
bf16 training.
"""

import json

import jax
import numpy as np
import pytest
import torch

from eabnet_tpu.config import ComposedConfig as JComposed
from eabnet_tpu.config import DataConfig as JData
from eabnet_tpu.config import EaBNetConfig as JEaB
from eabnet_tpu.config import ExperimentConfig as JExperiment
from eabnet_tpu.config import GaGNetConfig as JGaG
from eabnet_tpu.config import TrainConfig as JTrain
from eabnet_tpu.train.step import create_train_state as j_create_state
from eabnet_tpu.train.step import make_train_step as j_make_step
from eabnet_tpu_torch.config import ExperimentConfig
from eabnet_tpu_torch.models import build_model
from eabnet_tpu_torch.train import step as P
from eabnet_tpu_torch.weights import (flatten_tree, load_jax_params,
                                      to_jax_params)

from tests.test_torch_heads import HEADS
from tests.test_torch_train_step import (MOMENT_RTOL, PARAM_ATOL, set_state,
                                         snapshot)

LOSS_RTOL = 1e-5     # train losses (tests/test_torch_train_step.py)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for the port: on a host that other test workers
    load, more threads mostly wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ----------------------------------------------------------- training
N_STEPS, BATCH, N = 2, 3, 3200
LOSS_KEYS = ("eabnet", "postnet", "final")


def train_cfg(head, freeze=False):
    return JExperiment(
        model=JComposed(
            eabnet=JEaB(c=8, M=3, embed_dim=8, cd1=8, p=2, q=1,
                        **HEADS[head]),
            gagnet=JGaG(c=8, cd1=8, p=1, q=1, dilas=(1, 2)),
            freeze_eabnet=freeze),
        data=JData(dataset="fake"),
        train=JTrain(batch_size=BATCH, wav_len=0.2, lr=5e-4, grad_clip=1.0))


def train_batches(seed=0):
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


def port_state(cfg, params):
    state = P.TrainState(0, load_jax_params(build_model(cfg.model), params),
                         None)
    state.opt_state = P.adam_init(state.model)
    return state


@pytest.mark.parametrize("head", HEADS)
def test_head_train_step_matches_jax_and_freezes(head):
    """Each step taken by the port from the JAX package's state before it:
    the losses within 1e-5 relative, the head's Adam moments and
    parameters after it by ``tests/test_torch_train_step.py``'s rules.
    (Free-running, the losses of step 2 drift by ~2e-4 here: at step 1
    Adam moves every element by +-lr, and ~45 of ~809,000 elements whose
    gradients sit at the noise floor move the other way in the other
    package.)"""
    jcfg = train_cfg(head)
    _, jstate = j_create_state(jcfg, jax.random.key(0))
    params0 = jax.tree.map(np.asarray, jstate.params)
    jstep = j_make_step(jcfg, donate=False)
    cfg = ExperimentConfig.from_dict(json.loads(jcfg.to_json()))
    state = port_state(cfg, params0)
    step = P.make_train_step(cfg)
    lr = cfg.train.lr
    jl, pl = [], []
    for noisy, clean, n in train_batches():
        set_state(state, jax.tree.map(np.asarray, jstate))
        jstate, jlosses = jstep(jstate, noisy, clean, n)
        state, losses = step(state, *(torch.from_numpy(a)
                                      for a in (noisy, clean, n)))
        jl.append([float(jlosses[k]) for k in LOSS_KEYS])
        pl.append([float(losses[k]) for k in LOSS_KEYS])
        adam = jstate.opt_state[1][0]
        for got, want, what in zip(snapshot(state), (
                jstate.params, adam.mu, adam.nu), ("params", "mu", "nu")):
            want = flatten_tree(jax.tree.map(np.asarray, want))
            for k in ("eabnet.bf_map.kernel", "eabnet.bf_map.bias"):
                atol = (PARAM_ATOL * lr if what == "params"
                        else MOMENT_RTOL * np.abs(want[k]).max())
                np.testing.assert_allclose(got[k], want[k], rtol=0,
                                           atol=atol, err_msg=f"{what} {k}")
    np.testing.assert_allclose(pl, jl, rtol=LOSS_RTOL)
    head_params = {k: v for k, v in flatten_tree(params0).items()
                   if k.startswith("eabnet.bf_map.")}
    assert len(head_params) == 2
    moved = flatten_tree(to_jax_params(state.model))
    assert all(not np.array_equal(moved[k], v)
               for k, v in head_params.items())

    # freeze_eabnet: the head (like the rest of the beamformer) keeps its
    # values, the post-filter trains, in float32 and bf16
    for dtype in ("float32", "bfloat16"):
        d = json.loads(train_cfg(head, freeze=True).to_json())
        d["train"]["compute_dtype"] = dtype
        fcfg = ExperimentConfig.from_dict(d)
        frozen = port_state(fcfg, params0)
        fstep = P.make_train_step(fcfg)
        for noisy, clean, n in train_batches(1):
            frozen, losses = fstep(frozen, *(torch.from_numpy(a)
                                             for a in (noisy, clean, n)))
            assert all(np.isfinite(float(v)) for v in losses.values())
        after = flatten_tree(to_jax_params(frozen.model))
        for k, v in flatten_tree(params0).items():
            assert np.array_equal(after[k], v) == k.startswith("eabnet."), \
                (dtype, k)
