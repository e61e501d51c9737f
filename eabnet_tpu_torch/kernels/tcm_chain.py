"""A whole squeezed-TCN group: CUDA kernels (forward and backward), plain
versions and the wrapper that picks between them by the tensor's device.

Replaces the TPU kernels ``eabnet_tpu/kernels/tcm_chain.py::_fwd_kernel``
and ``::_bwd_kernel``. The CUDA source (``csrc/tcm_chain.cu``) says what
bounds each kernel on the card and how its design answers that.
``tcm_chain_reference`` is the forward in plain PyTorch, used for CPU
tensors (where autograd of it gives the gradient) and as the comparison
on the card; ``tcm_chain_bwd_reference`` is the backward written out by
hand, as the Pallas backward walks it, the comparison for the backward
kernel.

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


def _prelu_bwd(x, alpha, dy):
    return (torch.where(x > 0, dy, dy * alpha),
            (dy * torch.clamp(x, max=0)).sum(dim=(0, 1)))


def _in_saved(x, gamma, beta):
    """IN over T with the (xhat, inv_std) its backward reads."""
    mean = x.mean(dim=1, keepdim=True)
    var = torch.square(x - mean).mean(dim=1, keepdim=True)
    inv = torch.rsqrt(var + EPS)
    xhat = (x - mean) * inv
    return xhat * gamma + beta, xhat, inv


def _in_bwd(xhat, inv, gamma, dy):
    dxhat = dy * gamma
    m1 = dxhat.mean(dim=1, keepdim=True)
    m2 = (dxhat * xhat).mean(dim=1, keepdim=True)
    return (inv * (dxhat - m1 - xhat * m2), (dy * xhat).sum(dim=(0, 1)),
            dy.sum(dim=(0, 1)))


def _shift(a, s):
    """(B, T, C) delayed by s frames (s > 0) or advanced by -s (s < 0),
    zeros entering."""
    t = a.shape[1]
    if s > 0:
        return F.pad(a, (0, 0, s, 0))[:, :t]
    if s < 0:
        return F.pad(a, (0, 0, 0, -s))[:, -s:]
    return a


def _forward_saves(x, weights, dilations, twin, acts):
    """The chain forward with what the reverse walk reads: (trunk inputs,
    per-TCM saves); ``acts`` replaces trunk inputs, h and conv outputs."""
    wi, wl, wr, wo, al, ga, be = weights
    branches = ((0, wl), (1, wr))[:2 if twin else 1]
    inputs, saves = [], []
    for j, dil in enumerate(dilations):
        if acts is not None and j:
            x = acts["x"][j - 1]
        inputs.append(x)
        s = {"h": x @ wi[j] if acts is None else acts["h"][j]}
        convs = []
        for bi, w in branches:
            n, s[f"xhat{bi}"], s[f"inv{bi}"] = _in_saved(
                _prelu(s["h"], al[j, bi]), ga[j, bi], be[j, bi])
            s[f"n{bi}"] = n
            convs.append(_causal_conv(n, w[j], dil) if acts is None
                         else acts["c"][bi][j])
        s["c"] = convs
        s["g"] = convs[0] * torch.sigmoid(convs[1]) if twin else convs[0]
        no, s["xhat_o"], s["inv_o"] = _in_saved(
            _prelu(s["g"], al[j, 2]), ga[j, 2], be[j, 2])
        s["no"] = no
        x = x + no @ wo[j]
        saves.append(s)
    return inputs, saves


def tcm_chain_activations_reference(x, weights, dilations, twin):
    """Plain PyTorch: the forward activations the backward kernel keeps,
    in the layout of ``_launch_bwd(..., activations=True)``."""
    inputs, saves = _forward_saves(x, weights, dilations, twin, None)
    cl = torch.stack([s["c"][0] for s in saves])
    cr = (torch.stack([s["c"][1] for s in saves]) if twin
          else torch.zeros_like(cl))
    return {"x": torch.stack(inputs[1:]) if len(inputs) > 1
            else x.new_zeros((0,) + tuple(x.shape)),
            "h": torch.stack([s["h"] for s in saves]), "c": (cl, cr)}


def prelu_inputs(acts, twin):
    """The PReLU inputs of each TCM, read from activations in the layout of
    ``_launch_bwd(..., activations=True)``: the in-projections h (p, B, T,
    C) and the gate g = c_L * sigmoid(c_R) (twin) or c_L."""
    cl, cr = acts["c"]
    return acts["h"], (cl * torch.sigmoid(cr) if twin else cl)


def tcm_chain_bwd_reference(x: torch.Tensor, dy: torch.Tensor,
                            weights: Tuple[torch.Tensor, ...],
                            dilations: Sequence[int], twin: bool,
                            acts=None):
    """Plain PyTorch backward, written out as the Pallas backward walks it
    (not autograd): recompute the chain, then go through it in reverse.
    x, dy (B, T, D) -> (dx, (dwi, dwl, dwr, dwo, dalphas, dgammas,
    dbetas)), the weight gradients summed over the batch. Only the
    branches that run get a gradient: a single-branch chain leaves ``wr``
    and row 1 of the (p, 3, C) tables at zero.

    ``acts`` (from ``_launch_bwd(..., activations=True)``) replaces the
    recomputed trunk inputs, in-projections ``h`` and conv outputs by the
    backward kernel's own: a PReLU input within float32 noise of 0 then
    takes the same branch in both, and the comparison sees only the
    reverse walk's arithmetic."""
    wi, wl, wr, wo, al, ga, be = weights
    k = wl.shape[1]
    grads = [torch.zeros_like(w) for w in weights]
    dwi, dwl, dwr, dwo, dal, dga, dbe = grads
    branches = ((0, wl, dwl), (1, wr, dwr))[:2 if twin else 1]
    inputs, saves = _forward_saves(x, weights, dilations, twin, acts)
    for j in range(len(dilations) - 1, -1, -1):
        s, dil = saves[j], dilations[j]
        dno = dy @ wo[j].t()
        dwo[j] += torch.einsum("btc,btd->cd", s["no"], dy)
        dpo, dga[j, 2], dbe[j, 2] = _in_bwd(s["xhat_o"], s["inv_o"],
                                            ga[j, 2], dno)
        dg, dal[j, 2] = _prelu_bwd(s["g"], al[j, 2], dpo)
        if twin:
            sig = torch.sigmoid(s["c"][1])
            dcs = (dg * sig, dg * s["c"][0] * sig * (1.0 - sig))
        else:
            dcs = (dg,)
        dh = torch.zeros_like(s["h"])
        for (bi, w, dw), dc in zip(branches, dcs):
            dn = torch.zeros_like(dc)
            for i in range(k):
                shift = (k - 1 - i) * dil
                dw[j, i] += torch.einsum(
                    "btk,btc->kc", _shift(s[f"n{bi}"], shift), dc)
                dn = dn + _shift(dc @ w[j, i].t(), -shift)
            dp, dga[j, bi], dbe[j, bi] = _in_bwd(
                s[f"xhat{bi}"], s[f"inv{bi}"], ga[j, bi], dn)
            dhb, dal[j, bi] = _prelu_bwd(s["h"], al[j, bi], dp)
            dh = dh + dhb
        dwi[j] += torch.einsum("btd,btc->dc", inputs[j], dh)
        dy = dy + dh @ wi[j].t()
    return dy, tuple(grads)


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


def _kernel_check(x, weights, dilations):
    b, t, d = x.shape
    k, c, p = weights[1].shape[1], weights[0].shape[-1], len(dilations)
    if c != C_KERNEL or d > 256 or d % 4 or k > 8 or p > 16:
        raise ValueError(
            f"tcm_chain kernel takes C=64, D<=256 (multiple of 4), K<=8, "
            f"p<=16; got C={c}, D={d}, K={k}, p={p}")
    if not all(w.is_contiguous() for w in (x,) + tuple(weights)):
        raise ValueError("tcm_chain: tensors must be contiguous")
    return b, t, d, k, p


def _launch_fwd(x, weights, dilations, twin):
    b, t, d, k, p = _kernel_check(x, weights, dilations)
    lib = load_library()
    y = torch.empty_like(x)
    work = torch.empty(int(lib.lib.eabnet_tcm_chain_workspace(b, t)),
                       dtype=torch.float32, device=x.device)
    dils = (ctypes.c_int * p)(*dilations)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = lib.lib.eabnet_tcm_chain_fwd(
            x.data_ptr(), *(w.data_ptr() for w in weights), y.data_ptr(),
            work.data_ptr(), b, t, d, k, p, dils, int(twin), stream)
    lib.check(err, "tcm_chain kernel launch")
    tcm_chain.launches += 1
    return y


def _launch_bwd(x, dy, weights, dilations, twin, activations=False):
    """The backward kernel: -> (dx, (dwi, dwl, dwr, dwo, dalphas, dgammas,
    dbetas)), and with ``activations`` also the forward it recomputed:
    {"x": trunk inputs of TCMs 1..p-1 (p-1, B, T, D), "h": (p, B, T, C),
    "c": (branch-L, branch-R) conv outputs, each (p, B, T, C)} (copies of
    the kernel's workspace, laid out as ``csrc/tcm_chain.cu`` documents in
    ``eabnet_tcm_chain_bwd``)."""
    dy = dy.contiguous()
    b, t, d, k, p = _kernel_check(x, weights, dilations)
    lib = load_library()
    n_work = int(lib.lib.eabnet_tcm_chain_bwd_workspace(b, t, d, k, p,
                                                        int(twin)))
    if n_work < 0:
        raise RuntimeError("tcm_chain backward: the kernel cannot be sized "
                           "on this device")
    dx = torch.empty_like(x)
    grads = torch.empty(sum(w.numel() for w in weights), dtype=torch.float32,
                        device=x.device)
    work = torch.empty(n_work, dtype=torch.float32, device=x.device)
    dils = (ctypes.c_int * p)(*dilations)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = lib.lib.eabnet_tcm_chain_bwd(
            x.data_ptr(), dy.data_ptr(), *(w.data_ptr() for w in weights),
            dx.data_ptr(), grads.data_ptr(), work.data_ptr(), b, t, d, k, p,
            dils, int(twin), stream)
    lib.check(err, "tcm_chain backward kernel launch")
    tcm_chain.bwd_launches += 1
    dw = tuple(g.view(w.shape) for g, w in zip(
        torch.split(grads, [w.numel() for w in weights]), weights))
    if not activations:
        return dx, dw
    c = weights[0].shape[-1]
    btc, btd = b * t * c, b * t * d
    o = int(lib.lib.eabnet_tcm_chain_workspace(b, t))  # the forward's part
    xs = work[o:o + (p - 1) * btd].view(p - 1, b, t, d).clone()
    o += (p - 1) * btd
    hs, cl, cr = (work[o + i * p * btc:o + (i + 1) * p * btc]
                  .view(p, b, t, c).clone() for i in range(3))
    return dx, dw, {"x": xs, "h": hs, "c": (cl, cr)}


class _TCMChain(torch.autograd.Function):
    """The chain on the card, with the backward kernel as its gradient.
    Only the group input is saved; the backward recomputes the rest."""

    @staticmethod
    def forward(ctx, x, dilations, twin, *weights):
        ctx.dilations, ctx.twin = dilations, twin
        ctx.save_for_backward(x, *weights)
        return _launch_fwd(x, weights, dilations, twin)

    @staticmethod
    def backward(ctx, dy):
        x, *weights = ctx.saved_tensors
        dx, grads = _launch_bwd(x, dy, tuple(weights), ctx.dilations,
                                ctx.twin)
        return (dx, None, None) + grads


def tcm_chain(x: torch.Tensor, weights: Tuple[torch.Tensor, ...],
              dilations: Sequence[int], twin: bool) -> torch.Tensor:
    """Run one SqueezedTCNGroup: the plain version on a CPU tensor
    (autograd of it is the gradient there), the CUDA kernels on a CUDA
    tensor. Forward launches are counted in ``tcm_chain.launches``,
    backward launches in ``tcm_chain.bwd_launches``."""
    _check(x, weights, dilations)
    if x.device.type == "cpu":
        return tcm_chain_reference(x, weights, dilations, twin)
    if x.device.type != "cuda":
        raise ValueError(f"tcm_chain: no kernel for device {x.device}")
    dilations = tuple(int(v) for v in dilations)
    if torch.is_grad_enabled() and any(
            w.requires_grad for w in (x,) + tuple(weights)):
        return _TCMChain.apply(x, dilations, bool(twin), *weights)
    return _launch_fwd(x, weights, dilations, twin)


tcm_chain.launches = 0
tcm_chain.bwd_launches = 0
