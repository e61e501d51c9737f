"""Seeded weights for both sides of a cell.

The weights are drawn on the device from ``--seed`` in two calls of one
``torch.Generator`` over one flat buffer, at the scale of the released
models' own initialisers: flax's ``lecun_normal`` (a normal cut at two
deviations, variance 1 / fan_in) for every Dense and conv kernel,
uniform(-1/sqrt(H), 1/sqrt(H)) for the LSTM weights and biases. Leaves
that those initialisers set to a constant (biases 0, norm scales 1, PReLU
slopes 0.25) get that constant plus a seeded deviation of 0.05, so that
every channel differs and a fault that mixes channels shows.

The reference keeps the buffer's views in PyTorch's layout; the program
gets the same numbers as a flax parameter tree in the released layout
(``jax_tree``), which its own loader maps back.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
from torch import nn

from benchmark.reference import model as ref

CONSTANT_SPREAD = 0.05
_CUT = 2.0  # lecun_normal's truncation, in deviations
_TRUNC_STD = 0.87962566103423978  # the deviation of a normal cut at +-2

# PyTorch layout -> the released (flax) layout, by the owning module
_JAX_LAYOUT = {
    ref.Dense: lambda a: a.T,
    ref.Conv2d: lambda a: a.transpose(2, 3, 1, 0),
    ref.ConvTranspose2d: lambda a: a.transpose(2, 3, 0, 1)[::-1, ::-1],
    ref.Conv1d: lambda a: a.transpose(2, 1, 0),
}


def _init(owner: nn.Module, leaf: str, shape) -> tuple:
    """(normal deviation, uniform half-width, constant) of one leaf."""
    if leaf == "kernel":
        if isinstance(owner, ref.Dense):
            fan_in = shape[1]
        else:  # (O, I, kt, kf), (I, O, kt, kf), (O, I, K): flax's fan_in
            fan_in = shape[1 if not isinstance(owner, ref.ConvTranspose2d)
                           else 0] * math.prod(shape[2:])
        return (1.0 / fan_in) ** 0.5 / _TRUNC_STD, 0.0, 0.0
    if isinstance(owner, ref._LSTMParams):
        return 0.0, 1.0 / owner.w_hh.shape[0] ** 0.5, 0.0
    if leaf == "alpha":
        return CONSTANT_SPREAD, 0.0, 0.25
    if leaf == "scale":
        return CONSTANT_SPREAD, 0.0, 1.0
    if leaf == "bias":
        return CONSTANT_SPREAD, 0.0, 0.0
    raise ValueError(f"no initialiser for {type(owner).__name__}.{leaf}")


def _seed64(seed: int) -> int:
    return int(seed) & 0xFFFF_FFFF_FFFF_FFFF


def draw(model: nn.Module, seed: int, device) -> Dict[str, torch.Tensor]:
    """{name: tensor} for every parameter of the reference ``model``,
    drawn on ``device`` from ``seed``, and copied into the model."""
    params = dict(model.named_parameters())
    rows = []
    for name, p in params.items():
        owner_name, _, leaf = name.rpartition(".")
        rows.append(_init(model.get_submodule(owner_name), leaf,
                          tuple(p.shape)))
    counts = torch.tensor([p.numel() for p in params.values()],
                          device=device)
    n = int(sum(p.numel() for p in params.values()))
    per = torch.tensor(rows, dtype=torch.float32, device=device)
    a, b, c = (torch.repeat_interleave(per[:, i], counts) for i in range(3))
    g = torch.Generator(device=device)
    g.manual_seed(_seed64(seed))
    u = torch.rand((2, n), generator=g, device=device, dtype=torch.float64)
    lo = 0.5 * math.erfc(_CUT / math.sqrt(2.0))  # the normal's CDF at -2
    z = (math.sqrt(2.0) * torch.erfinv(2.0 * (lo + u[0] * (1 - 2 * lo))
                                       - 1.0)).float()
    flat = c + a * z + b * (2.0 * u[1].float() - 1.0)
    out, off = {}, 0
    for name, p in params.items():
        out[name] = flat[off:off + p.numel()].view(p.shape)
        off += p.numel()
    with torch.no_grad():
        for name, p in params.items():
            p.data = out[name]
    return out


def jax_tree(model: nn.Module, weights: Dict[str, torch.Tensor]) -> Dict:
    """The weights as a nested flax tree of float32 numpy arrays in the
    released layout."""
    host = torch.cat([w.reshape(-1) for w in weights.values()]).cpu().numpy()
    tree: Dict = {}
    off = 0
    for name, w in weights.items():
        arr = host[off:off + w.numel()].reshape(tuple(w.shape))
        off += w.numel()
        owner_name, _, leaf = name.rpartition(".")
        owner = model.get_submodule(owner_name)
        if leaf == "kernel" and type(owner) in _JAX_LAYOUT:
            arr = _JAX_LAYOUT[type(owner)](arr)
        *path, last = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[last] = np.ascontiguousarray(arr, dtype=np.float32)
    return tree
