"""The LSTM beamforming head's double recurrence: CUDA kernels (forward
and backward), plain versions and the wrapper that picks between them by
the tensor's device.

Replaces the TPU kernels ``eabnet_tpu/kernels/lstm_bf.py::_fwd_kernel``
and ``::_bwd_kernel``. The CUDA source (``csrc/lstm_bf.cu``) says what
bounds each kernel on the card and how its design answers that.
``double_lstm_reference`` is the forward in plain PyTorch, used for CPU
tensors (where autograd of it gives the gradient) and as the comparison on
the card; ``double_lstm_bwd_reference`` is the backward as an explicit
reverse-time walk with the backward kernel's signature, the comparison for
that kernel. As in the JAX package, the layer-1 input projection and the
MLP after the recurrence stay outside the kernels (``models/eabnet.py``).

Weights are in the JAX package's layout: ``w_hh1`` (H, 4H), ``w_ih2`` and
``w_hh2`` (H, 4H), ``b2 = b_ih2 + b_hh2`` (4H,), gate order i, f, g, o.

bfloat16 follows the Pallas kernels' semantics (``wdt`` there): xw1 and
the weights come in bf16, every product is the float32 product of bf16
operands with a float32 sum (h rounded to bf16 where it enters a
product), the carried (h, c) and the gates stay float32, and h2 comes out
in bf16; the training forward writes all four sequences (h1, c1, h2, c2)
rounded to bf16. The bf16 backward reads those rounded sequences, rounds
the cotangent dy and, per step, dgates before the recurrent products and
the weight-gradient products (db2 sums the unrounded layer-2 dgates);
dxw1 comes out in bf16 and each weight gradient is summed in float32 and
rounded to bf16 once. Under autograd a bf16 CPU tensor takes the plain
bf16 backward (``_DoubleLSTMPlain``), not autograd of the plain forward,
whose casts would round the gradient elsewhere.
"""

from __future__ import annotations

from typing import Tuple

import torch

from eabnet_tpu_torch.kernels._build import load_library

H_KERNEL = 64  # the kernels' hidden width


def _cell(gates, c_prev):
    i, f, g, o = torch.chunk(gates, 4, dim=-1)
    c = torch.sigmoid(f) * c_prev + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c


def _operand(h: torch.Tensor, lowp: bool) -> torch.Tensor:
    """h as a product operand: rounded to bf16 (and back) in bf16 mode."""
    return h.to(torch.bfloat16).to(h.dtype) if lowp else h


def double_lstm_states_reference(xw1, w_hh1, w_ih2, w_hh2, b2
                                 ) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch: xw1 (T, L, 4H) -> the sequences (h1, c1, h2, c2),
    each (T, L, H); the training forward kernel's outputs. With bf16
    arguments, the bf16 semantics (module doc): a float32 recurrence whose
    sequences come out rounded to bf16."""
    lowp = xw1.dtype == torch.bfloat16
    if lowp:
        xw1, w_hh1, w_ih2, w_hh2, b2 = (
            a.float() for a in (xw1, w_hh1, w_ih2, w_hh2, b2))
    t, l, g4 = xw1.shape
    zeros = xw1.new_zeros((l, g4 // 4))
    h1, c1, h2, c2 = zeros, zeros, zeros, zeros
    w2 = torch.cat([w_ih2, w_hh2], dim=0)
    seqs = ([], [], [], [])
    for step in range(t):
        h1, c1 = _cell(xw1[step] + _operand(h1, lowp) @ w_hh1, c1)
        h2, c2 = _cell(_operand(torch.cat([h1, h2], dim=-1), lowp) @ w2
                       + b2, c2)
        for seq, v in zip(seqs, (h1, c1, h2, c2)):
            seq.append(v)
    out_dtype = torch.bfloat16 if lowp else xw1.dtype
    return tuple(torch.stack(s).to(out_dtype) for s in seqs)


def double_lstm_reference(xw1: torch.Tensor, w_hh1: torch.Tensor,
                          w_ih2: torch.Tensor, w_hh2: torch.Tensor,
                          b2: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch: xw1 (T, L, 4H) -> layer-2 hiddens h2 (T, L, H), in
    xw1's dtype."""
    return double_lstm_states_reference(
        xw1, w_hh1, w_ih2, w_hh2, b2)[2].to(xw1.dtype)


def _cell_bwd(dh, dc, c_prev, c_new, gates):
    """dgates (pre-activation) and dc_prev of one LSTM cell."""
    gi, gf, gg, go = torch.chunk(gates, 4, dim=-1)
    si, sf, so = torch.sigmoid(gi), torch.sigmoid(gf), torch.sigmoid(go)
    sg, tc = torch.tanh(gg), torch.tanh(c_new)
    dct = dc + dh * so * (1.0 - tc * tc)
    dgates = torch.cat([dct * sg * si * (1.0 - si),
                        dct * c_prev * sf * (1.0 - sf),
                        dct * si * (1.0 - sg * sg),
                        dh * tc * so * (1.0 - so)], dim=-1)
    return dgates, dct * sf


def double_lstm_bwd_reference(xw1, dy, h1, c1, h2, c2, w_hh1, w_ih2, w_hh2,
                              b2, *, compute=torch.float32
                              ) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch backward, an explicit reverse-time walk (not autograd):
    xw1 (T, L, 4H), the cotangent dy of h2 and the saved states (T, L, H)
    -> (dxw1, dw_hh1, dw_ih2, dw_hh2, db2). With bf16 arguments the bf16
    semantics (module doc), computed in ``compute`` around the bf16 values
    (float32; float64 measures how far float32 rounding alone moves them),
    the results in bf16."""
    lowp = xw1.dtype == torch.bfloat16
    if lowp:  # dy arrives rounded to bf16, as the Pallas kernel takes it
        dy = dy.to(torch.bfloat16)
        xw1, dy, h1, c1, h2, c2, w_hh1, w_ih2, w_hh2, b2 = (
            a.to(compute) for a in (xw1, dy, h1, c1, h2, c2, w_hh1, w_ih2,
                                    w_hh2, b2))
    t, l, g4 = xw1.shape
    zeros = xw1.new_zeros((l, g4 // 4))
    dh1, dc1, dh2, dc2 = zeros, zeros, zeros, zeros
    dxw1 = torch.empty_like(xw1)
    dw_hh1, dw_ih2, dw_hh2 = (torch.zeros_like(w) for w in
                              (w_hh1, w_ih2, w_hh2))
    db2 = torch.zeros_like(b2)
    for s in range(t - 1, -1, -1):
        h1p, c1p, h2p, c2p = ((a[s - 1] if s else zeros)
                              for a in (h1, c1, h2, c2))
        gates1 = xw1[s] + h1p @ w_hh1
        gates2 = h1[s] @ w_ih2 + h2p @ w_hh2 + b2
        dg2, dc2 = _cell_bwd(dy[s] + dh2, dc2, c2p, c2[s], gates2)
        db2 += dg2.sum(0)
        dg2 = _operand(dg2, lowp)  # the operand of every product below
        dh2 = dg2 @ w_hh2.t()
        dg1, dc1 = _cell_bwd(dh1 + dg2 @ w_ih2.t(), dc1, c1p, c1[s], gates1)
        dg1 = _operand(dg1, lowp)
        dh1 = dg1 @ w_hh1.t()
        dxw1[s] = dg1
        dw_hh1 += h1p.t() @ dg1
        dw_ih2 += h1[s].t() @ dg2
        dw_hh2 += h2p.t() @ dg2
    out = (dxw1, dw_hh1, dw_ih2, dw_hh2, db2)
    return tuple(a.to(torch.bfloat16) for a in out) if lowp else out


def _check(xw1, w_hh1, w_ih2, w_hh2, b2):
    tensors = (xw1, w_hh1, w_ih2, w_hh2, b2)
    if xw1.dtype not in (torch.float32, torch.bfloat16) or any(
            t.dtype != xw1.dtype for t in tensors):
        raise TypeError("double_lstm takes all float32 or all bfloat16 "
                        "tensors, got " + ", ".join(str(t.dtype)
                                                    for t in tensors))
    if any(t.device != xw1.device for t in tensors):
        raise ValueError("double_lstm: all tensors must be on one device")
    if xw1.dim() != 3 or xw1.shape[-1] % 4 or xw1.shape[0] < 1 \
            or xw1.shape[1] < 1:
        raise ValueError(f"double_lstm: xw1 must be (T, L, 4H), got "
                         f"{tuple(xw1.shape)}")
    h = xw1.shape[-1] // 4
    for name, w, shape in (("w_hh1", w_hh1, (h, 4 * h)),
                           ("w_ih2", w_ih2, (h, 4 * h)),
                           ("w_hh2", w_hh2, (h, 4 * h)),
                           ("b2", b2, (4 * h,))):
        if tuple(w.shape) != shape:
            raise ValueError(f"double_lstm: {name} must be {shape}, got "
                             f"{tuple(w.shape)}")


def fwd_lanes_per_block(lanes: int) -> int:
    """The forward kernel's lanes per block for ``lanes`` lanes on the
    current CUDA device; its grid is ceil(lanes / that) blocks."""
    lib = load_library()
    lb = int(lib.lib.eabnet_lstm_bf_fwd_lanes_per_block(lanes))
    if lb < 1:
        lib.check(-lb, "double_lstm lanes per block")
    return lb


def _count(entry: str) -> None:
    """One launch of the C entry ``eabnet_lstm_bf_<entry>``."""
    n = double_lstm.entry_launches
    n[entry] = n.get(entry, 0) + 1


def _launch_fwd(xw1, w_hh1, w_ih2, w_hh2, b2, states: bool):
    """The forward kernel: h2 only, or (h1, c1, h2, c2) when ``states``."""
    t, l, g4 = xw1.shape
    if g4 != 4 * H_KERNEL:
        raise ValueError(f"double_lstm kernel takes H=64, got H={g4 // 4}")
    if not xw1.is_contiguous() or xw1.data_ptr() % 16:
        raise ValueError("double_lstm: xw1 must be contiguous and 16-byte "
                         "aligned")
    lowp = xw1.dtype == torch.bfloat16
    w2 = torch.cat([w_ih2, w_hh2], dim=0)
    ins = (xw1, w_hh1.contiguous(), w2, b2.contiguous())
    lib = load_library()
    dtypes = (xw1.dtype,) * 4  # h1, c1, h2, c2 as the kernel writes them
    outs = [torch.empty((t, l, H_KERNEL), dtype=dt, device=xw1.device)
            for dt in (dtypes if states else dtypes[2:3])]
    stream = torch.cuda.current_stream(xw1.device).cuda_stream
    entry = ("fwd_train" if states else "fwd") + ("_bf16" if lowp else "")
    fn = getattr(lib.lib, "eabnet_lstm_bf_" + entry)
    with torch.cuda.device(xw1.device):
        if states:
            err = fn(*(a.data_ptr() for a in ins),
                     *(o.data_ptr() for o in outs), t, l, stream)
        else:
            err = fn(*(a.data_ptr() for a in ins), outs[0].data_ptr(), t, l,
                     stream)
    lib.check(err, "double_lstm kernel launch")
    double_lstm.launches += 1
    _count(entry)
    return tuple(outs) if states else outs[0]


def _launch_bwd(xw1, dy, h1, c1, h2, c2, w_hh1, w_ih2, w_hh2, b2):
    """The backward kernels: -> (dxw1, dw_hh1, dw_ih2, dw_hh2, db2)."""
    t, l, g4 = xw1.shape
    h = H_KERNEL
    ins = [a.contiguous() for a in (xw1, dy, h1, c1, h2, c2, w_hh1, w_ih2,
                                    w_hh2, b2)]
    lib = load_library()
    n_work = int(lib.lib.eabnet_lstm_bf_bwd_workspace(t, l))
    if n_work < 0:
        raise RuntimeError("double_lstm backward: no CUDA device to size "
                           "the workspace")
    dxw1 = torch.empty_like(ins[0])
    # bf16: dxw1 and the weight gradients in bf16, the workspace float32
    dw = torch.empty(3 * h * g4 + g4, dtype=xw1.dtype, device=xw1.device)
    work = torch.empty(n_work, dtype=torch.float32, device=xw1.device)
    stream = torch.cuda.current_stream(xw1.device).cuda_stream
    entry = "bwd_bf16" if xw1.dtype == torch.bfloat16 else "bwd"
    fn = getattr(lib.lib, "eabnet_lstm_bf_" + entry)
    with torch.cuda.device(xw1.device):
        err = fn(*(a.data_ptr() for a in ins), dxw1.data_ptr(),
                 dw.data_ptr(), work.data_ptr(), t, l, stream)
    lib.check(err, "double_lstm backward kernel launch")
    double_lstm.bwd_launches += 1
    _count(entry)
    dws = dw[:3 * h * g4].view(3, h, g4)
    return dxw1, dws[0], dws[1], dws[2], dw[3 * h * g4:]


class _DoubleLSTM(torch.autograd.Function):
    """The recurrence on the card, with the backward kernel as its
    gradient (float32 or bf16). The forward saves the four state sequences
    it wrote."""

    @staticmethod
    def forward(ctx, xw1, w_hh1, w_ih2, w_hh2, b2):
        h1, c1, h2, c2 = _launch_fwd(xw1, w_hh1, w_ih2, w_hh2, b2,
                                     states=True)
        ctx.save_for_backward(xw1, w_hh1, w_ih2, w_hh2, b2, h1, c1, h2, c2)
        return h2

    @staticmethod
    def backward(ctx, dy):
        xw1, w_hh1, w_ih2, w_hh2, b2, h1, c1, h2, c2 = ctx.saved_tensors
        return _launch_bwd(xw1, dy, h1, c1, h2, c2, w_hh1, w_ih2, w_hh2, b2)


class _DoubleLSTMPlain(torch.autograd.Function):
    """bf16 on the CPU: the plain training forward, with the plain bf16
    backward (the explicit reverse walk) as its gradient."""

    @staticmethod
    def forward(ctx, xw1, w_hh1, w_ih2, w_hh2, b2):
        h1, c1, h2, c2 = double_lstm_states_reference(xw1, w_hh1, w_ih2,
                                                      w_hh2, b2)
        ctx.save_for_backward(xw1, w_hh1, w_ih2, w_hh2, b2, h1, c1, h2, c2)
        return h2

    @staticmethod
    def backward(ctx, dy):
        xw1, w_hh1, w_ih2, w_hh2, b2, h1, c1, h2, c2 = ctx.saved_tensors
        return double_lstm_bwd_reference(xw1, dy, h1, c1, h2, c2, w_hh1,
                                         w_ih2, w_hh2, b2)


def double_lstm(xw1: torch.Tensor, w_hh1: torch.Tensor, w_ih2: torch.Tensor,
                w_hh2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """xw1 (T, L, 4H) -> h2 (T, L, H): the plain version on a CPU tensor
    (in float32 autograd of it is the gradient there, in bf16 the plain
    bf16 backward), the CUDA kernels on a CUDA tensor. bfloat16 tensors
    take the bf16 semantics (module doc) and the bf16 kernels. Forward
    launches of either dtype are counted in ``double_lstm.launches``,
    backward launches in ``double_lstm.bwd_launches``, and every launch
    by its C entry in ``double_lstm.entry_launches`` ({"fwd", "fwd_bf16",
    "fwd_train", "fwd_train_bf16", "bwd", "bwd_bf16"}: count)."""
    _check(xw1, w_hh1, w_ih2, w_hh2, b2)
    args = (xw1, w_hh1, w_ih2, w_hh2, b2)
    grad = torch.is_grad_enabled() and any(a.requires_grad for a in args)
    if xw1.device.type == "cpu":
        if grad and xw1.dtype == torch.bfloat16:
            return _DoubleLSTMPlain.apply(*args)
        return double_lstm_reference(*args)
    if xw1.device.type != "cuda":
        raise ValueError(f"double_lstm: no kernel for device {xw1.device}")
    if grad:
        return _DoubleLSTM.apply(*args)
    return _launch_fwd(*args, states=False)


double_lstm.launches = 0
double_lstm.bwd_launches = 0
double_lstm.entry_launches = {}
