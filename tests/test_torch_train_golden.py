"""The golden of the port's training run on the card, and the port's first
full-width step against it on the CPU.

``chip_smoke.py`` trains release/composed_9mic jointly (freeze_eabnet
false, float32, lr 5e-4, clip 1.0) from its 40000.params on the offline
dataset of release/val_set (7 pairs of 6 s, one batch of 7, T = 601) for
5 steps, and holds the step losses {eabnet, postnet, final} against
tests/golden/torch_port_train_composed_9mic.npz, the JAX package's losses
for the same steps. The JAX steps are taken with the release config's
scan/xla paths, one item at a time: each step's gradient is the mean of
the 7 items' gradients, which is the batch gradient because every item
has all 601 frames (the loss is a mean over items with equal mask sums)
and the model treats items independently (instance norms). That keeps the
JAX run at the memory of one item. ``test_item_accumulation_is_the_batch_step``
holds this procedure against the JAX package's own batched
``make_train_step`` at a small width. Rewrite the golden (5 JAX steps of
7 items on the CPU, ~4 GB) with

    python tests/test_torch_train_golden.py --regen
"""

import json
import os
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXP = os.path.join(ROOT, "release", "composed_9mic")
GOLDEN = os.path.join(ROOT, "tests", "golden",
                      "torch_port_train_composed_9mic.npz")
N_STEPS = 5
KEYS = ("eabnet", "postnet", "final")
# The port's forward on the CPU reproduces the JAX forward to float32
# rounding (~1e-6 relative at full width); 2e-5 leaves room for other
# BLAS builds while a wrong layout or mask moves the losses by percent.
FIRST_STEP_RTOL = 2e-5


def golden_config_dict():
    """The training configuration of the chip run and of the golden: the
    release config, jointly trained in float32 at lr 5e-4 on the offline
    pairs of release/val_set (paths relative to the repository root)."""
    with open(os.path.join(EXP, "config.json")) as f:
        d = json.load(f)
    d["model"]["freeze_eabnet"] = False
    d["data"].update(dataset="mcse", train_set="offline",
                     speech_root="release/val_set", val_set="",
                     num_workers=0, transfer_int16=True)
    d["train"].update(compute_dtype="float32", lr=5e-4, grad_clip=1.0,
                      batch_size=7, log_every=1, checkpoint_dir="",
                      exp_root="", total_epoch=1000)
    return d


def jax_item_steps(cfg, params, items, n_steps):
    """n_steps of the JAX package's optimizer on the mean of per-item
    gradients (each item a batch of one through the JAX loss). Returns
    (per-step batch losses (n_steps, 3), per-item losses of step 1
    (n_items, 3), final params)."""
    import jax
    import jax.numpy as jnp
    import optax

    from eabnet_tpu.dsp import prepare_data
    from eabnet_tpu.losses import eabnet_with_postnet_loss, frame_mask
    from eabnet_tpu.models import build_model
    from eabnet_tpu.models.eabnet import from_reference_layout
    from eabnet_tpu.train.step import (_dequant, _valid_frames,
                                       make_optimizer)

    model = build_model(cfg.model)

    def loss_fn(p, noisy, target):
        noisy, target = _dequant(noisy), _dequant(target)
        noisy_stft, target_stft = prepare_data(noisy, target, cfg.stft)
        out = model.apply({"params": p}, noisy_stft, train=True)
        t = noisy_stft.shape[1]
        n = jnp.full((noisy.shape[0],), noisy.shape[-1], jnp.int32)
        mask = frame_mask(_valid_frames(n, t, cfg, noisy.shape[-1]), t)
        losses = eabnet_with_postnet_loss(
            out, from_reference_layout(target_stft), mask)
        return losses["final"], losses

    grad_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    tx = make_optimizer(cfg)
    opt = tx.init(params)
    step_losses, first_items = [], None
    for _ in range(n_steps):
        grads, per_item = None, []
        for noisy, target in items:
            (_, losses), g = grad_fn(params, noisy[None], target[None])
            per_item.append([float(losses[k]) for k in KEYS])
            grads = g if grads is None else jax.tree.map(jnp.add, grads, g)
        grads = jax.tree.map(lambda v: v / len(items), grads)
        updates, opt = tx.update(grads, opt, params)
        params = optax.apply_updates(params, updates)
        step_losses.append(np.mean(per_item, axis=0))
        if first_items is None:
            first_items = np.asarray(per_item)
    return np.asarray(step_losses), first_items, params


def regen():
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
    losses, first_items, _ = jax_item_steps(cfg, params, items, N_STEPS)
    np.savez(GOLDEN, losses=losses, first_items=first_items,
             names=np.asarray(ds.names), config=json.dumps(d))
    print(f"wrote {GOLDEN}:\n{losses}")


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)


def test_golden_matches_its_config(golden):
    assert json.loads(str(golden["config"])) == golden_config_dict()
    assert golden["losses"].shape == (N_STEPS, 3)
    assert golden["first_items"].shape == (7, 3)
    assert np.isfinite(golden["losses"]).all()
    np.testing.assert_allclose(golden["losses"][0],
                               golden["first_items"].mean(axis=0), rtol=1e-6)
    # the beamformer's loss falls step by step on the items it trains on
    assert (np.diff(golden["losses"][:, 0]) < 0).all()


def test_port_first_step_matches_golden_on_cpu(golden):
    """The port's step-1 losses of the first item at full width (the
    released weights, before any update) against the JAX package's."""
    index = 0
    import torch

    from eabnet_tpu_torch.checkpoint import latest_checkpoint, load_params
    from eabnet_tpu_torch.config import ExperimentConfig
    from eabnet_tpu_torch.data.datasets import OfflineMcseDataset
    from eabnet_tpu_torch.models import build_model
    from eabnet_tpu_torch.train.step import make_eval_step, TrainState
    from eabnet_tpu_torch.weights import load_jax_params

    cfg = ExperimentConfig.from_json(str(golden["config"]))
    model = load_jax_params(build_model(cfg.model),
                            load_params(latest_checkpoint(EXP)))
    ds = OfflineMcseDataset(os.path.join(ROOT, cfg.data.speech_root),
                            transfer_int16=True)
    assert ds.names[index] == str(golden["names"][index])
    noisy, target = ds[index]
    losses, _ = make_eval_step(cfg)(TrainState(0, model, None),
                                    torch.from_numpy(noisy[None]),
                                    torch.from_numpy(target[None]))
    ours = [float(losses[k]) for k in KEYS]
    np.testing.assert_allclose(ours, golden["first_items"][index],
                               rtol=FIRST_STEP_RTOL)


def test_item_accumulation_is_the_batch_step():
    """At a small width, jax_item_steps equals the JAX package's batched
    make_train_step over two steps (losses and params)."""
    import jax

    from eabnet_tpu.config import (ComposedConfig, DataConfig, EaBNetConfig,
                                   ExperimentConfig, GaGNetConfig,
                                   TrainConfig)
    from eabnet_tpu.train.step import create_train_state, make_train_step

    cfg = ExperimentConfig(
        model=ComposedConfig(
            eabnet=EaBNetConfig(c=8, M=3, embed_dim=8, cd1=8, p=2, q=1),
            gagnet=GaGNetConfig(c=8, cd1=8, p=1, q=1, dilas=(1, 2))),
        data=DataConfig(dataset="fake"),
        train=TrainConfig(batch_size=3, wav_len=0.1, lr=5e-4))
    rng = np.random.default_rng(0)
    noisy = (rng.standard_normal((3, 3, 1600)) * 0.1).astype(np.float32)
    target = (rng.standard_normal((3, 1600)) * 0.1).astype(np.float32)
    _, state = create_train_state(cfg, jax.random.key(0))
    params0 = jax.tree.map(np.asarray, state.params)
    step = make_train_step(cfg, donate=False)
    batch_losses = []
    for _ in range(2):
        state, losses = step(state, noisy, target)
        batch_losses.append([float(losses[k]) for k in KEYS])
    items = list(zip(noisy, target))
    losses, _, params = jax_item_steps(cfg, params0, items, 2)
    np.testing.assert_allclose(losses, batch_losses, rtol=1e-5)
    # Adam moves a parameter by up to ~lr whatever the size of its
    # gradient, so where a gradient is at float32 rounding level the two
    # summation orders can move it in opposite directions (measured: one
    # element of 12,288 by 1.35 lr over the two steps)
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(state.params)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   atol=2.5 * cfg.train.lr)


if __name__ == "__main__":
    if "--regen" not in sys.argv:
        sys.exit("usage: python tests/test_torch_train_golden.py --regen")
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, ROOT)
    regen()
