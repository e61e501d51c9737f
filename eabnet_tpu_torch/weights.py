"""Load a flax parameter tree of the JAX package into the port's modules.

The port's modules carry the JAX package's module and parameter names, so
a flax path ``a/b/kernel`` is the port's parameter ``a.b.kernel``. Only the
layouts differ, by the type of the module that owns the parameter:

- ``Dense``: (in, out) -> (out, in);
- ``Conv2d``: HWIO -> OIHW;
- ``ConvTranspose2d``: flax's un-flipped (kt, kf, in, out) -> PyTorch's
  transposed-conv (in, out, kt, kf), spatially flipped;
- ``Conv1d``: (K, in, out) -> (out, in, K);
- everything else (LSTM weights, PReLU slopes, norm scale/bias): as is.

The channel folds of the JAX package (mic-major input channels, the
(freq, channel) bottleneck order) are kept by the models themselves.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

from eabnet_tpu_torch.nn.blocks import Conv1d, Conv2d, ConvTranspose2d, Dense

_KERNEL_LAYOUT = {
    Dense: lambda a: a.T,
    Conv2d: lambda a: a.transpose(3, 2, 0, 1),
    ConvTranspose2d: lambda a: a[::-1, ::-1].transpose(2, 3, 0, 1),
    Conv1d: lambda a: a.transpose(2, 1, 0),
}


def flatten_tree(tree: Dict, prefix: str = "") -> Dict[str, np.ndarray]:
    """{"a": {"b": x}} -> {"a.b": x}."""
    out = {}
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else k
        if isinstance(v, Mapping):
            out.update(flatten_tree(v, name))
        else:
            out[name] = np.asarray(v)
    return out


def load_jax_params(module: nn.Module, tree: Dict) -> nn.Module:
    """Copy every leaf of the flax param tree into ``module``'s parameters.

    Raises on a parameter the tree lacks, a leaf no parameter takes, or a
    shape that differs after the layout change, so nothing loads halfway.
    """
    flat = flatten_tree(tree)
    params = dict(module.named_parameters())
    missing = sorted(params.keys() - flat.keys())
    unused = sorted(flat.keys() - params.keys())
    if missing or unused:
        raise KeyError(f"param tree does not match the module: missing "
                       f"{missing[:5]} ({len(missing)}), unused "
                       f"{unused[:5]} ({len(unused)})")
    with torch.no_grad():
        for name, p in params.items():
            owner_name, _, leaf = name.rpartition(".")
            owner = module.get_submodule(owner_name)
            arr = flat[name]
            if leaf == "kernel" and type(owner) in _KERNEL_LAYOUT:
                arr = _KERNEL_LAYOUT[type(owner)](arr)
            if tuple(arr.shape) != tuple(p.shape):
                raise ValueError(f"{name}: tree shape {arr.shape} does not "
                                 f"match the module's {tuple(p.shape)}")
            p.copy_(torch.from_numpy(np.array(arr, dtype=np.float32)))
    return module
