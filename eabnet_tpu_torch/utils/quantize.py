"""Weights-only int8 serving ("int8w"), the port's own copy of the JAX
package's scheme.

Every >= 2-D float parameter of a flax tree is stored as symmetric int8
with one float32 scale per output channel (absmax / 127 over every axis
but the last, where flax keeps output features); 1-D parameters (biases,
norm gains, PReLU slopes) stay float. The packed tree is made in numpy in
the JAX layout (``quantize_weights_int8``, the same leaves as the JAX
package's), then mapped onto a module's parameters (``pack_for_module``):
the int8 tensors take the layout change of ``weights.py`` (transposes and
flips, exact on int8) and each scale lands on the mapped output-channel
axis. ``dequantize`` turns packed values back into a tensor of the
compute dtype as the JAX package does, ``q.astype(dtype) * s.astype(dtype)``
in that dtype's arithmetic, so the values equal the JAX package's bit for
bit. The Enhancer keeps the packed tensors on the device
(``PackedWeights``, a few flat buffers) and dequantizes inside each call in
a few launches, so the resident parameter bytes are the packed ones
(``packed_nbytes``).
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from eabnet_tpu_torch.weights import _KERNEL_LAYOUT, _layout, flatten_tree


def flat_views(flat: torch.Tensor, shapes: Sequence[Tuple[int, ...]]
               ) -> list:
    """A flat (N,) tensor cut into consecutive views of ``shapes``: many
    tensors cast or moved in one launch (the int8w floats here, the bf16
    copies of the float32 parameters in ``train/step.py``); under autograd
    each view's gradient lands in its slice."""
    sizes = [int(np.prod(s, dtype=np.int64)) for s in shapes]
    return [v.view(s) for v, s in zip(torch.split(flat, sizes), shapes)]


def _pack(w: np.ndarray) -> Dict[str, np.ndarray]:
    w = np.asarray(w)
    if w.ndim < 2 or not np.issubdtype(w.dtype, np.floating):
        return {"w": w, "s": np.float32(1.0)}
    absmax = np.abs(w).max(axis=tuple(range(w.ndim - 1)))  # (O,)
    scale = np.where(absmax > 0, absmax / 127.0, 1.0).astype(np.float32)
    q = np.clip(np.round(w / scale), -127, 127).astype(np.int8)
    return {"w": q, "s": scale}


def quantize_weights_int8(params: Dict) -> Dict:
    """A flax param tree (JAX layout) -> the same tree with each leaf a
    packed ``{"w": int8 or float, "s": scale}``."""
    return {k: quantize_weights_int8(v) if isinstance(v, dict) else _pack(v)
            for k, v in params.items()}


def _is_packed(node) -> bool:
    return isinstance(node, dict) and set(node) == {"w", "s"}


def _leaves(packed: Dict):
    for v in packed.values():
        if _is_packed(v):
            yield v
        else:
            yield from _leaves(v)


def packed_nbytes(packed: Dict) -> int:
    """Parameter bytes of a packed tree: the int8 (or float) values and
    their scales."""
    return sum(np.asarray(leaf["w"]).nbytes + np.asarray(leaf["s"]).nbytes
               for leaf in _leaves(packed))


def pack_for_module(module: nn.Module, packed: Dict
                    ) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
    """A packed tree -> {parameter name: (values, scale)} in ``module``'s
    layout: the values mapped as ``weights.py`` maps a kernel, the scale
    shaped to broadcast along the mapped output-channel axis. Raises on a
    missing or unused leaf, or a shape that does not match."""
    flat = {k[:-2]: v for k, v in flatten_tree(packed).items()
            if k.endswith(".w")}
    scales = {k[:-2]: v for k, v in flatten_tree(packed).items()
              if k.endswith(".s")}
    params = dict(module.named_parameters())
    missing, unused = params.keys() - flat.keys(), flat.keys() - params.keys()
    if missing or unused:
        raise KeyError(f"packed tree does not match the module: missing "
                       f"{sorted(missing)[:5]}, unused {sorted(unused)[:5]}")
    out = {}
    for name, p in params.items():
        layout = _layout(module, name, _KERNEL_LAYOUT)
        w, s = flat[name], np.asarray(scales[name], np.float32)
        q = layout(w).copy()  # copies: fresh strides, writable
        if w.dtype == np.int8:
            # the scale as a (1, ..., 1, O) array takes the same layout
            # change, which moves O to the module's output-channel axis
            s = layout(s.reshape((1,) * (w.ndim - 1) + (-1,))).copy()
        if tuple(q.shape) != tuple(p.shape):
            raise ValueError(f"{name}: packed shape {q.shape} does not "
                             f"match the module's {tuple(p.shape)}")
        out[name] = (torch.from_numpy(q), torch.from_numpy(s))
    return out


def dequantize(values: torch.Tensor, scale: torch.Tensor,
               dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Packed values in ``dtype``: int8 values times their scale in that
    dtype's arithmetic; float values cast."""
    if values.dtype == torch.int8:
        return values.to(dtype) * scale.to(dtype)
    return values.to(dtype)


def _rows(q: torch.Tensor, s: torch.Tensor):
    """q as (O, rest) rows, its output-channel axis (the one s spans)
    first, and how to undo that: (axis, shape of the moved q)."""
    if s.numel() == 1:
        return q.reshape(1, -1), (None, tuple(q.shape))
    a = next(d for d, n in enumerate(s.shape) if n > 1)
    moved = q.movedim(a, 0)
    return moved.reshape(moved.shape[0], -1), (a, tuple(moved.shape))


class PackedWeights:
    """``pack_for_module``'s output resident on one device in three flat
    tensors, dequantized in a few launches.

    The int8 values go in one buffer as rows, one per output channel, each
    parameter's output-channel axis first; parameters whose rows have the
    same width are neighbours and form a group, so one broadcast multiply
    dequantizes a group. Their scales go in a float32 buffer in the same
    row order, followed by the float parameters' unit scales (unused; kept
    so the resident bytes are the packed tree's, as the JAX package keeps
    them), and the float parameters in a third buffer. ``dequantize`` casts
    each buffer once and multiplies once per group (``dequantize``'s
    arithmetic, so the same bits); every parameter is a view of those."""

    def __init__(self, packed: Dict[str, Tuple[torch.Tensor, torch.Tensor]],
                 device):
        by_width, floats, units = {}, [], []
        for name, (q, s) in packed.items():
            if q.dtype == torch.int8:
                rows, undo = _rows(q, s)
                by_width.setdefault(rows.shape[1], []).append(
                    (name, rows, s.reshape(-1), undo))
            else:
                floats.append((name, q))
                units.append(s.reshape(-1))
        qs, ss, self._groups = [], [], []
        n_q = n_s = 0
        for width, members in sorted(by_width.items()):
            views = [(name, r.shape[0], undo) for name, r, _, undo in members]
            n_rows = sum(n for _, n, _ in views)
            qs += [r.reshape(-1) for _, r, _, _ in members]
            ss += [scale for _, _, scale, _ in members]
            self._groups.append((n_q, n_s, n_rows, width, views))
            n_q, n_s = n_q + n_rows * width, n_s + n_rows
        self._floats = [(name, tuple(v.shape)) for name, v in floats]

        def flat(parts, dtype):
            return (torch.cat(parts) if parts
                    else torch.empty(0, dtype=dtype)).to(device)

        self.values = flat(qs, torch.int8)
        self.scales = flat(ss + units, torch.float32)
        self.floats = flat([v.reshape(-1) for _, v in floats], torch.float32)

    def nbytes(self) -> int:
        """Resident bytes: the packed tree's values and scales."""
        return self.values.nbytes + self.scales.nbytes + self.floats.nbytes

    def n_groups(self) -> int:
        """Broadcast multiplies per ``dequantize``."""
        return len(self._groups)

    def dequantize(self, dtype: torch.dtype = torch.bfloat16
                   ) -> Dict[str, torch.Tensor]:
        """{parameter name: tensor in dtype}, in the module's layout."""
        values, scales = self.values.to(dtype), self.scales.to(dtype)
        out = {}
        for n_q, n_s, rows, width, views in self._groups:
            w = values[n_q:n_q + rows * width].view(rows, width) * \
                scales[n_s:n_s + rows, None]
            parts = torch.split(w, [n for _, n, _ in views])
            for (name, _, (axis, shape)), v in zip(views, parts):
                v = v.view(shape)
                out[name] = v if axis is None else v.movedim(0, axis)
        parts = flat_views(self.floats.to(dtype),
                           [shape for _, shape in self._floats])
        for (name, _), v in zip(self._floats, parts):
            out[name] = v
        return out
