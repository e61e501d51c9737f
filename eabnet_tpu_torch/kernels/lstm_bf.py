"""Forward of the LSTM beamforming head's double recurrence: CUDA kernel,
plain version and the wrapper that picks between them by the tensor's
device.

Replaces the TPU kernel ``eabnet_tpu/kernels/lstm_bf.py::_fwd_kernel``.
The CUDA source (``csrc/lstm_bf.cu``) says what bounds the kernel on the
card and how its design answers that; ``double_lstm_reference`` is the same
function in plain PyTorch, used for CPU tensors and as the comparison on
the card. As in the JAX package, the layer-1 input projection and the MLP
after the recurrence stay outside the kernel (``models/eabnet.py``).

Weights are in the JAX package's layout: ``w_hh1`` (H, 4H), ``w_ih2`` and
``w_hh2`` (H, 4H), ``b2 = b_ih2 + b_hh2`` (4H,), gate order i, f, g, o.
"""

from __future__ import annotations

import torch

from eabnet_tpu_torch.kernels._build import load_library

H_KERNEL = 64  # the kernel's hidden width


def _cell(gates, c_prev):
    i, f, g, o = torch.chunk(gates, 4, dim=-1)
    c = torch.sigmoid(f) * c_prev + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c


def double_lstm_reference(xw1: torch.Tensor, w_hh1: torch.Tensor,
                          w_ih2: torch.Tensor, w_hh2: torch.Tensor,
                          b2: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch: xw1 (T, L, 4H) -> layer-2 hiddens h2 (T, L, H)."""
    t, l, g4 = xw1.shape
    zeros = xw1.new_zeros((l, g4 // 4))
    h1, c1, h2, c2 = zeros, zeros, zeros, zeros
    w2 = torch.cat([w_ih2, w_hh2], dim=0)
    out = []
    for step in range(t):
        h1, c1 = _cell(xw1[step] + h1 @ w_hh1, c1)
        h2, c2 = _cell(torch.cat([h1, h2], dim=-1) @ w2 + b2, c2)
        out.append(h2)
    return torch.stack(out)


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
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            "double_lstm has no backward yet (the training slice of the "
            "port); call it under torch.no_grad()")


def double_lstm(xw1: torch.Tensor, w_hh1: torch.Tensor, w_ih2: torch.Tensor,
                w_hh2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """xw1 (T, L, 4H) -> h2 (T, L, H): the plain version on a CPU tensor,
    the CUDA kernel on a CUDA tensor (one launch, counted in
    ``double_lstm.launches``)."""
    _check(xw1, w_hh1, w_ih2, w_hh2, b2)
    if xw1.device.type == "cpu":
        return double_lstm_reference(xw1, w_hh1, w_ih2, w_hh2, b2)
    if xw1.device.type != "cuda":
        raise ValueError(f"double_lstm: no kernel for device {xw1.device}")
    t, l, g4 = xw1.shape
    if g4 != 4 * H_KERNEL:
        raise ValueError(f"double_lstm kernel takes H=64, got H={g4 // 4}")
    w2 = torch.cat([w_ih2, w_hh2], dim=0)
    ins = (xw1, w_hh1.contiguous(), w2, b2.contiguous())
    if not xw1.is_contiguous():
        raise ValueError("double_lstm: xw1 must be contiguous")
    lib = load_library()
    h2 = torch.empty((t, l, H_KERNEL), dtype=torch.float32,
                     device=xw1.device)
    stream = torch.cuda.current_stream(xw1.device).cuda_stream
    with torch.cuda.device(xw1.device):
        err = lib.lib.eabnet_lstm_bf_fwd(
            *(a.data_ptr() for a in ins), h2.data_ptr(), t, l, stream)
    lib.check(err, "double_lstm kernel launch")
    double_lstm.launches += 1
    return h2


double_lstm.launches = 0
