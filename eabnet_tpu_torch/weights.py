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

``to_jax_params`` (and ``to_jax_tree`` for any per-parameter tensors, such
as Adam's moments) is the inverse: the module's parameters as a flax
tree in the JAX layout, exact to the bit.

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
_JAX_LAYOUT = {  # the inverse of each entry above
    Dense: lambda a: a.T,
    Conv2d: lambda a: a.transpose(2, 3, 1, 0),
    ConvTranspose2d: lambda a: a.transpose(2, 3, 0, 1)[::-1, ::-1],
    Conv1d: lambda a: a.transpose(2, 1, 0),
}


def _layout(module: nn.Module, name: str, table):
    """The layout change of parameter ``name`` (identity if none)."""
    owner_name, _, leaf = name.rpartition(".")
    owner = module.get_submodule(owner_name)
    if leaf == "kernel" and type(owner) in table:
        return table[type(owner)]
    return lambda a: a


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


def from_jax_tree(module: nn.Module, tree: Dict) -> Dict[str, np.ndarray]:
    """A flax tree keyed like ``module``'s parameters (the params, or
    per-parameter state such as Adam's moments) -> {parameter name: array
    in the module's layout}, float32.

    Raises on a parameter the tree lacks, a leaf no parameter takes, or a
    shape that differs after the layout change.
    """
    flat = flatten_tree(tree)
    params = dict(module.named_parameters())
    missing = sorted(params.keys() - flat.keys())
    unused = sorted(flat.keys() - params.keys())
    if missing or unused:
        raise KeyError(f"param tree does not match the module: missing "
                       f"{missing[:5]} ({len(missing)}), unused "
                       f"{unused[:5]} ({len(unused)})")
    out = {}
    for name, p in params.items():
        arr = _layout(module, name, _KERNEL_LAYOUT)(flat[name])
        if tuple(arr.shape) != tuple(p.shape):
            raise ValueError(f"{name}: tree shape {arr.shape} does not "
                             f"match the module's {tuple(p.shape)}")
        out[name] = np.array(arr, dtype=np.float32)
    return out


def load_jax_params(module: nn.Module, tree: Dict) -> nn.Module:
    """Copy every leaf of the flax param tree into ``module``'s parameters
    (see ``from_jax_tree``); nothing loads halfway."""
    arrays = from_jax_tree(module, tree)
    with torch.no_grad():
        for name, p in module.named_parameters():
            p.copy_(torch.from_numpy(arrays[name]))
    return module


def to_jax_tree(module: nn.Module,
                tensors: Mapping[str, torch.Tensor]) -> Dict:
    """{parameter name: tensor in the module's layout} -> a nested flax
    tree of numpy arrays (copies) in the JAX layout, in the module's
    parameter order."""
    tree: Dict = {}
    for name, _ in module.named_parameters():
        arr = tensors[name].detach().cpu().numpy()
        # a copy: the numpy view of a CPU tensor would follow later
        # in-place updates of the parameter
        arr = np.array(_layout(module, name, _JAX_LAYOUT)(arr), order="C")
        *path, leaf = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = arr
    return tree


def to_jax_params(module: nn.Module) -> Dict:
    """The module's parameters as a flax param tree (the inverse of
    ``load_jax_params``)."""
    return to_jax_tree(module, dict(module.named_parameters()))
