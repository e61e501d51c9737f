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


def double_lstm_states_reference(xw1, w_hh1, w_ih2, w_hh2, b2
                                 ) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch: xw1 (T, L, 4H) -> the sequences (h1, c1, h2, c2),
    each (T, L, H); the training forward kernel's outputs."""
    t, l, g4 = xw1.shape
    zeros = xw1.new_zeros((l, g4 // 4))
    h1, c1, h2, c2 = zeros, zeros, zeros, zeros
    w2 = torch.cat([w_ih2, w_hh2], dim=0)
    seqs = ([], [], [], [])
    for step in range(t):
        h1, c1 = _cell(xw1[step] + h1 @ w_hh1, c1)
        h2, c2 = _cell(torch.cat([h1, h2], dim=-1) @ w2 + b2, c2)
        for seq, v in zip(seqs, (h1, c1, h2, c2)):
            seq.append(v)
    return tuple(torch.stack(s) for s in seqs)


def double_lstm_reference(xw1: torch.Tensor, w_hh1: torch.Tensor,
                          w_ih2: torch.Tensor, w_hh2: torch.Tensor,
                          b2: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch: xw1 (T, L, 4H) -> layer-2 hiddens h2 (T, L, H)."""
    return double_lstm_states_reference(xw1, w_hh1, w_ih2, w_hh2, b2)[2]


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
                              b2) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch backward, an explicit reverse-time walk (not autograd):
    xw1 (T, L, 4H), the cotangent dy of h2 and the saved states (T, L, H)
    -> (dxw1, dw_hh1, dw_ih2, dw_hh2, db2)."""
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
        dh2 = dg2 @ w_hh2.t()
        dg1, dc1 = _cell_bwd(dh1 + dg2 @ w_ih2.t(), dc1, c1p, c1[s], gates1)
        dh1 = dg1 @ w_hh1.t()
        dxw1[s] = dg1
        dw_hh1 += h1p.t() @ dg1
        dw_ih2 += h1[s].t() @ dg2
        dw_hh2 += h2p.t() @ dg2
        db2 += dg2.sum(0)
    return dxw1, dw_hh1, dw_ih2, dw_hh2, db2


def _check(xw1, w_hh1, w_ih2, w_hh2, b2):
    tensors = (xw1, w_hh1, w_ih2, w_hh2, b2)
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("double_lstm runs float32 only in this slice")
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


def _launch_fwd(xw1, w_hh1, w_ih2, w_hh2, b2, states: bool):
    """The forward kernel: h2 only, or (h1, c1, h2, c2) when ``states``."""
    t, l, g4 = xw1.shape
    if g4 != 4 * H_KERNEL:
        raise ValueError(f"double_lstm kernel takes H=64, got H={g4 // 4}")
    if not xw1.is_contiguous():
        raise ValueError("double_lstm: xw1 must be contiguous")
    w2 = torch.cat([w_ih2, w_hh2], dim=0)
    ins = (xw1, w_hh1.contiguous(), w2, b2.contiguous())
    lib = load_library()
    outs = [torch.empty((t, l, H_KERNEL), dtype=torch.float32,
                        device=xw1.device) for _ in range(4 if states else 1)]
    stream = torch.cuda.current_stream(xw1.device).cuda_stream
    with torch.cuda.device(xw1.device):
        if states:
            err = lib.lib.eabnet_lstm_bf_fwd_train(
                *(a.data_ptr() for a in ins), *(o.data_ptr() for o in outs),
                t, l, stream)
        else:
            err = lib.lib.eabnet_lstm_bf_fwd(
                *(a.data_ptr() for a in ins), outs[0].data_ptr(), t, l,
                stream)
    lib.check(err, "double_lstm kernel launch")
    double_lstm.launches += 1
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
    dw = torch.empty(3 * h * g4 + g4, dtype=torch.float32, device=xw1.device)
    work = torch.empty(n_work, dtype=torch.float32, device=xw1.device)
    stream = torch.cuda.current_stream(xw1.device).cuda_stream
    with torch.cuda.device(xw1.device):
        err = lib.lib.eabnet_lstm_bf_bwd(
            *(a.data_ptr() for a in ins), dxw1.data_ptr(), dw.data_ptr(),
            work.data_ptr(), t, l, stream)
    lib.check(err, "double_lstm backward kernel launch")
    double_lstm.bwd_launches += 1
    dws = dw[:3 * h * g4].view(3, h, g4)
    return dxw1, dws[0], dws[1], dws[2], dw[3 * h * g4:]


class _DoubleLSTM(torch.autograd.Function):
    """The recurrence on the card, with the backward kernel as its
    gradient. The forward saves the four state sequences it wrote."""

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


def double_lstm(xw1: torch.Tensor, w_hh1: torch.Tensor, w_ih2: torch.Tensor,
                w_hh2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """xw1 (T, L, 4H) -> h2 (T, L, H): the plain version on a CPU tensor
    (autograd of it is the gradient there), the CUDA kernels on a CUDA
    tensor. Forward launches are counted in ``double_lstm.launches``,
    backward launches in ``double_lstm.bwd_launches``."""
    _check(xw1, w_hh1, w_ih2, w_hh2, b2)
    if xw1.device.type == "cpu":
        return double_lstm_reference(xw1, w_hh1, w_ih2, w_hh2, b2)
    if xw1.device.type != "cuda":
        raise ValueError(f"double_lstm: no kernel for device {xw1.device}")
    args = (xw1, w_hh1, w_ih2, w_hh2, b2)
    if torch.is_grad_enabled() and any(a.requires_grad for a in args):
        return _DoubleLSTM.apply(*args)
    return _launch_fwd(*args, states=False)


double_lstm.launches = 0
double_lstm.bwd_launches = 0
