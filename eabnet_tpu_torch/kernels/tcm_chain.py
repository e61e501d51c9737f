"""Forward of a whole squeezed-TCN group: CUDA kernel, plain version and
the wrapper that picks between them by the tensor's device.

Replaces the TPU kernel ``eabnet_tpu/kernels/tcm_chain.py::_fwd_kernel``.
The CUDA source (``csrc/tcm_chain.cu``) says what bounds the kernel on the
card and how its design answers that; ``tcm_chain_reference`` is the same
function in plain PyTorch, used for CPU tensors and as the comparison on
the card.

Weights come stacked over the group's p TCMs, as
``SqueezedTCNGroup.stacked_weights`` builds them:
``(wi (p, D, C), wl (p, K, C, C), wr (p, K, C, C), wo (p, C, D),
alphas, gammas, betas (p, 3, C))`` with conv taps as (tap, in, out) and
the (p, 3, C) rows ``[branch L, branch R (L again when single), out]``.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from eabnet_tpu_torch.kernels._build import load_library

EPS = 1e-5
C_KERNEL = 64  # the kernel's squeezed width


def _prelu(x, alpha):
    return torch.clamp(x, min=0) + alpha * torch.clamp(x, max=0)


def _instance_norm_t(x, gamma, beta):
    """IN over the time axis of (B, T, C), f32 statistics."""
    mean = x.mean(dim=1, keepdim=True)
    var = torch.square(x - mean).mean(dim=1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + EPS) * gamma + beta


def _causal_conv(n, w, dil):
    """sum_i shift_down(n, (K-1-i) dil) @ w[i] on (B, T, C); w (K, C, C)."""
    k, t = w.shape[0], n.shape[1]
    out = None
    for i in range(k):
        s = (k - 1 - i) * dil
        shifted = F.pad(n, (0, 0, s, 0))[:, :t] if s else n
        term = shifted @ w[i]
        out = term if out is None else out + term
    return out


def tcm_chain_reference(x: torch.Tensor, weights: Tuple[torch.Tensor, ...],
                        dilations: Sequence[int], twin: bool) -> torch.Tensor:
    """Plain PyTorch chain of p TCMs on x (B, T, D) -> (B, T, D)."""
    wi, wl, wr, wo, al, ga, be = weights
    for j, dil in enumerate(dilations):
        h = x @ wi[j]
        convs = []
        for bi, w in ((0, wl), (1, wr))[:2 if twin else 1]:
            n = _instance_norm_t(_prelu(h, al[j, bi]), ga[j, bi], be[j, bi])
            convs.append(_causal_conv(n, w[j], dil))
        g = convs[0] * torch.sigmoid(convs[1]) if twin else convs[0]
        no = _instance_norm_t(_prelu(g, al[j, 2]), ga[j, 2], be[j, 2])
        x = x + no @ wo[j]
    return x


def _check(x, weights, dilations):
    tensors = (x,) + tuple(weights)
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("tcm_chain runs float32 only in this slice")
    if any(t.device != x.device for t in tensors):
        raise ValueError("tcm_chain: all tensors must be on one device")
    if x.dim() != 3:
        raise ValueError(f"tcm_chain: x must be (B, T, D), got {tuple(x.shape)}")
    b, t, d = x.shape
    wi, wl, wr, wo, al, ga, be = weights
    p, k, c = len(dilations), wl.shape[1], wi.shape[-1]
    expect = {"wi": (p, d, c), "wl": (p, k, c, c), "wr": (p, k, c, c),
              "wo": (p, c, d), "alphas": (p, 3, c), "gammas": (p, 3, c),
              "betas": (p, 3, c)}
    for (name, shape), w in zip(expect.items(), weights):
        if tuple(w.shape) != shape:
            raise ValueError(f"tcm_chain: {name} must be {shape}, "
                             f"got {tuple(w.shape)}")
    if b < 1 or t < 1 or p < 1:
        raise ValueError("tcm_chain: empty batch, sequence or chain")
    if torch.is_grad_enabled() and any(w.requires_grad for w in tensors):
        raise NotImplementedError(
            "tcm_chain has no backward yet (the training slice of the port); "
            "call it under torch.no_grad()")


def tcm_chain(x: torch.Tensor, weights: Tuple[torch.Tensor, ...],
              dilations: Sequence[int], twin: bool) -> torch.Tensor:
    """Run one SqueezedTCNGroup: the plain version on a CPU tensor, the
    CUDA kernel on a CUDA tensor (one launch, counted in
    ``tcm_chain.launches``)."""
    _check(x, weights, dilations)
    if x.device.type == "cpu":
        return tcm_chain_reference(x, weights, dilations, twin)
    if x.device.type != "cuda":
        raise ValueError(f"tcm_chain: no kernel for device {x.device}")
    b, t, d = x.shape
    k, c, p = weights[1].shape[1], weights[0].shape[-1], len(dilations)
    if c != C_KERNEL or d > 256 or d % 4 or k > 8 or p > 16:
        raise ValueError(
            f"tcm_chain kernel takes C=64, D<=256 (multiple of 4), K<=8, "
            f"p<=16; got C={c}, D={d}, K={k}, p={p}")
    if not all(w.is_contiguous() for w in (x,) + tuple(weights)):
        raise ValueError("tcm_chain: tensors must be contiguous")
    lib = load_library()
    y = torch.empty_like(x)
    work = torch.empty(int(lib.lib.eabnet_tcm_chain_workspace(b, t)),
                       dtype=torch.float32, device=x.device)
    dils = (ctypes.c_int * p)(*dilations)
    wi, wl, wr, wo, al, ga, be = weights
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = lib.lib.eabnet_tcm_chain_fwd(
            x.data_ptr(), wi.data_ptr(), wl.data_ptr(), wr.data_ptr(),
            wo.data_ptr(), al.data_ptr(), ga.data_ptr(), be.data_ptr(),
            y.data_ptr(), work.data_ptr(), b, t, d, k, p, dils, int(twin),
            stream)
    lib.check(err, "tcm_chain kernel launch")
    tcm_chain.launches += 1
    return y


tcm_chain.launches = 0
