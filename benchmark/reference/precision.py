"""Lower precisions for the controls.

- ``tf32``: each operand of the reference's products rounded to TF32's
  10-bit mantissa (round to nearest, ``model.set_rounding``), the
  products and sums in float32: what a TF32 tensor core computes, and
  the step below the float32 that the serving configurations state.
- ``fp8_training(model)``: the reference computed in the step below the
  bfloat16 that the training configurations state, as fp8 training
  computes: each operand of every product, and the gradient that flows
  back into it, scaled by its largest magnitude onto float8 e4m3's
  range and rounded to e4m3 (3-bit mantissa); the output of every other
  operation (the backward's too) rounded to bfloat16 (``every_op``).
  (Every output in e4m3 gives no number: the front end's magnitude
  compression raises flushed zeros to a negative power, and a tensor
  scaled by an infinite largest entry is NaN throughout.)
- ``every_op(bf16)``: every output in bfloat16, the precision that the
  training configurations state: a second witness beside the program's
  bf16 step (``control.py``).
"""

from __future__ import annotations

import contextlib

import torch

E4M3_MAX = 448.0


def tf32(x: torch.Tensor) -> torch.Tensor:
    if x.dtype != torch.float32:
        return x
    bits = x.detach().contiguous().view(torch.int32)
    y = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return x + (y - x).detach() if x.requires_grad else y


def e4m3(x: torch.Tensor) -> torch.Tensor:
    """x scaled by its largest magnitude onto e4m3's range, rounded to
    e4m3 and scaled back."""
    if x.numel() == 0:
        return x
    xd = x.detach().float()
    scale = (xd.abs().amax() / E4M3_MAX).clamp(min=1e-30)
    return ((xd / scale).to(torch.float8_e4m3fn).float() * scale).to(x.dtype)


class _Fp8(torch.autograd.Function):
    """e4m3 both ways: the operand forward, its gradient backward."""

    @staticmethod
    def forward(ctx, x):
        return e4m3(x)

    @staticmethod
    def backward(ctx, g):
        return e4m3(g)


def fp8(x: torch.Tensor) -> torch.Tensor:
    return _Fp8.apply(x) if x.requires_grad else e4m3(x)


ROUNDINGS = {"tf32": tf32}


def bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(x.dtype)


@contextlib.contextmanager
def every_op(rounder):
    """Every float32 output of every operation inside the block (the
    backward's too) through ``rounder``; a view stays a view, an in-place
    result is rounded in place. Yields what it rounded: ``ops``, the
    ``backward`` ops among them (an operator named ``*_backward``) and
    the ``threads`` they ran on (the autograd engine runs a CUDA
    backward on a thread of its own)."""
    import threading

    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_map

    seen = {"ops": 0, "backward": 0, "threads": set()}

    class _Round(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func.is_view:
                return out
            seen["ops"] += 1
            seen["backward"] += "backward" in func.__name__
            seen["threads"].add(threading.get_ident())
            mutable = func._schema.is_mutable

            def one(t):
                if not isinstance(t, torch.Tensor) or \
                        t.dtype != torch.float32:
                    return t
                return t.copy_(rounder(t)) if mutable else rounder(t)

            return tree_map(one, out)

    with _Round():
        yield seen


@contextlib.contextmanager
def fp8_training(model):
    """The block's computation through ``model`` one step below bf16:
    the products' operands and their gradients in e4m3, every other
    output in bf16. Yields what ``every_op`` rounded."""
    from benchmark.reference.model import set_rounding

    set_rounding(model, fp8)
    try:
        with every_op(bf16) as seen:
            yield seen
    finally:
        set_rounding(model, lambda v: v)


@contextlib.contextmanager
def float32_products():
    """TF32 off for cuDNN's convolutions and for matmuls inside the
    block (PyTorch lets cuDNN take TF32 by default), the caller's flags
    back after: the reference computes in float32."""
    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = (matmul.allow_tf32, cudnn.allow_tf32)
    matmul.allow_tf32 = cudnn.allow_tf32 = False
    try:
        yield
    finally:
        matmul.allow_tf32, cudnn.allow_tf32 = saved
