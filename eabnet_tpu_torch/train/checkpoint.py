"""Training checkpoints in the JAX package's format.

``<iter>.ckpt`` is the flax state dict of the JAX package's ``TrainState``
(step, params, optax ``chain(clip_by_global_norm, adam)`` state, the
batch norms' running statistics) plus the epoch, msgpack-encoded, written
atomically beside a frozen ``config.json``; ``<iter>.params`` holds the
params alone. Both packages read each other's files: the port writes the JAX parameter layout
(``weights.to_jax_tree``) and reads it back (``weights.from_jax_tree``).
Reference ``.pth`` checkpoints are not read by the port.
"""

from __future__ import annotations

import os
import re
from typing import Tuple

import numpy as np
import torch

from eabnet_tpu_torch.checkpoint import (latest_checkpoint, load_params,
                                         msgpack_restore, msgpack_serialize,
                                         write_atomic)
from eabnet_tpu_torch.config import ExperimentConfig
from eabnet_tpu_torch.weights import (from_jax_tree, load_jax_batch_stats,
                                      load_jax_params, to_jax_batch_stats,
                                      to_jax_params, to_jax_tree)

__all__ = ["latest_checkpoint", "load_checkpoint", "load_config",
           "save_checkpoint", "save_config", "save_params", "state_dict"]


def state_dict(state, epoch: int) -> dict:
    """The checkpoint tree: what ``flax.serialization.to_state_dict`` gives
    for the JAX package's ``{"state": TrainState, "epoch": np.int64}``."""
    model, opt = state.model, state.opt_state
    return {
        "state": {
            "step": np.asarray(state.step, np.int32),
            "params": to_jax_params(model),
            "opt_state": {"0": {}, "1": {
                "0": {"count": np.asarray(opt.count, np.int32),
                      "mu": to_jax_tree(model, opt.mu),
                      "nu": to_jax_tree(model, opt.nu)},
                "1": {}}},
            "batch_stats": to_jax_batch_stats(model),
        },
        "epoch": np.int64(epoch),
    }


def save_checkpoint(state, epoch: int, directory: str) -> str:
    """Write the train state (and epoch) as ``<step>.ckpt``, atomically;
    returns the path."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"{int(state.step)}.ckpt")
    write_atomic(path, msgpack_serialize(state_dict(state, epoch)))
    return path


def save_params(model: torch.nn.Module, directory: str, step: int) -> str:
    """Write the params alone as ``<step>.params``, atomically."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"{int(step)}.params")
    write_atomic(path, msgpack_serialize({"params": to_jax_params(model)}))
    return path


def load_checkpoint(path: str, state, cfg: ExperimentConfig) -> Tuple:
    """Restore (state, epoch) in place from ``<iter>.ckpt``, or the params
    of ``<iter>.params`` with the step from the file name, the optimizer
    and batch statistics left as given (fresh) and epoch 0. ``.pth``
    raises."""
    del cfg  # the JAX signature; the port needs no config to read a file
    if path.endswith(".pth"):
        raise NotImplementedError(
            "reference .pth checkpoints are not read by this slice of the "
            "port; convert them with the JAX package first")
    if path.endswith(".params"):
        load_jax_params(state.model, load_params(path))
        m = re.match(r"(\d+)\.params$", os.path.basename(path))
        state.step = int(m.group(1)) if m else 0
        return state, 0
    with open(path, "rb") as f:
        tree = msgpack_restore(f.read())
    saved = tree["state"]
    load_jax_params(state.model, saved["params"])
    load_jax_batch_stats(state.model, saved["batch_stats"])
    adam = saved["opt_state"]["1"]["0"]
    opt = state.opt_state
    device = next(state.model.parameters()).device
    for moments, key in ((opt.mu, "mu"), (opt.nu, "nu")):
        for name, arr in from_jax_tree(state.model, adam[key]).items():
            moments[name] = torch.from_numpy(arr).to(device)
    opt.count = int(adam["count"])
    state.step = int(saved["step"])
    return state, int(tree["epoch"])


def save_config(cfg: ExperimentConfig, exp_root: str) -> None:
    os.makedirs(exp_root, exist_ok=True)
    cfg.save(os.path.join(exp_root, "config.json"))


def load_config(exp_root: str) -> ExperimentConfig:
    return ExperimentConfig.load(os.path.join(exp_root, "config.json"))
