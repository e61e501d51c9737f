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

The CUDA kernels are built for a squeezed width of C = 64. A chain of any
C from 1 to 64 runs through them with its weights zero-padded to 64
channels (``pad_weights``): a padded channel is exactly 0 through the
whole chain (the in-projection gives 0, PReLU(0) = 0, the instance norm
of a zero channel with scale and bias 0 gives 0, the convs' and the
out-projection's padded rows are 0), so the output is the narrow chain's
and the padded entries of every gradient are 0; the backward returns the
gradients cropped to C. At C = 64 nothing is padded or copied.

bfloat16 follows the Pallas kernels' semantics (``wdt`` there): x and
every weight come in bf16; each product is the float32 product of bf16
operands with a float32 sum (its activation operand rounded to bf16 where
it enters the product); the trunk stays float32 between the TCMs of the
group and is rounded to bf16 once, at the group's output; the PReLU, the
gate and the IN statistics are float32, with the slopes, scales and
biases read as float32 from their bf16 values. The bf16 backward
recomputes the chain so, carries the cotangent in float32 across the TCMs
(it arrives in bf16), rounds every product operand to bf16 (the cotangent
too), keeps the IN and PReLU derivatives float32, writes dx in bf16 and
sums each weight gradient in float32 before rounding it to bf16 once.
Under autograd a bf16 CPU tensor takes the plain bf16 backward
(``_TCMChainPlain``), not autograd of the plain forward.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from eabnet_tpu_torch.kernels._build import load_library

EPS = 1e-5
C_KERNEL = 64  # the kernel's squeezed width
TILE_FRAMES = 16  # frames per tile of the kernels' cooperative grid


def _prelu(x, alpha):
    return torch.clamp(x, min=0) + alpha * torch.clamp(x, max=0)


def _instance_norm_t(x, gamma, beta):
    """IN over the time axis of (B, T, C), f32 statistics."""
    mean = x.mean(dim=1, keepdim=True)
    var = torch.square(x - mean).mean(dim=1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + EPS) * gamma + beta


def _operand(v: torch.Tensor, lowp: bool) -> torch.Tensor:
    """v as a product operand: rounded to bf16 (and back) in bf16 mode."""
    return v.to(torch.bfloat16).to(v.dtype) if lowp else v


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
                        dilations: Sequence[int], twin: bool, *,
                        compute=torch.float32) -> torch.Tensor:
    """Plain PyTorch chain of p TCMs on x (B, T, D) -> (B, T, D), in x's
    dtype. bf16 weights: the semantics of the module doc, computed in
    ``compute`` around the bf16 operands (float32; float64 measures how far
    float32 rounding alone moves them). As in the Pallas kernel, x may be
    float32 with bf16 weights: the trunk then enters and leaves unrounded
    (one TCM of a chain, on its float32 trunk input)."""
    dtype, lowp = x.dtype, weights[0].dtype == torch.bfloat16
    if lowp:
        x, weights = x.to(compute), tuple(w.to(compute) for w in weights)
    wi, wl, wr, wo, al, ga, be = weights
    for j, dil in enumerate(dilations):
        h = _operand(x, lowp) @ wi[j]
        convs = []
        for bi, w in ((0, wl), (1, wr))[:2 if twin else 1]:
            n = _instance_norm_t(_prelu(h, al[j, bi]), ga[j, bi], be[j, bi])
            convs.append(_causal_conv(_operand(n, lowp), w[j], dil))
        g = convs[0] * torch.sigmoid(convs[1]) if twin else convs[0]
        no = _instance_norm_t(_prelu(g, al[j, 2]), ga[j, 2], be[j, 2])
        x = x + _operand(no, lowp) @ wo[j]
    return x.to(dtype)


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


def _forward_saves(x, weights, dilations, twin, acts, lowp=False):
    """The chain forward with what the reverse walk reads: (trunk inputs,
    per-TCM saves); ``acts`` replaces trunk inputs, h and conv outputs;
    ``lowp`` rounds each product's activation operand to bf16."""
    wi, wl, wr, wo, al, ga, be = weights
    branches = ((0, wl), (1, wr))[:2 if twin else 1]
    inputs, saves = [], []
    for j, dil in enumerate(dilations):
        if acts is not None and j:
            x = acts["x"][j - 1].to(x.dtype)
        inputs.append(x)
        s = {"h": _operand(x, lowp) @ wi[j] if acts is None
             else acts["h"][j].to(x.dtype)}
        convs = []
        for bi, w in branches:
            n, s[f"xhat{bi}"], s[f"inv{bi}"] = _in_saved(
                _prelu(s["h"], al[j, bi]), ga[j, bi], be[j, bi])
            s[f"n{bi}"] = n
            convs.append(_causal_conv(_operand(s[f"n{bi}"], lowp), w[j], dil)
                         if acts is None else acts["c"][bi][j].to(x.dtype))
        s["c"] = convs
        s["g"] = convs[0] * torch.sigmoid(convs[1]) if twin else convs[0]
        no, s["xhat_o"], s["inv_o"] = _in_saved(
            _prelu(s["g"], al[j, 2]), ga[j, 2], be[j, 2])
        s["no"] = no
        x = x + _operand(s["no"], lowp) @ wo[j]
        saves.append(s)
    return inputs, saves


def tcm_chain_activations_reference(x, weights, dilations, twin):
    """Plain PyTorch: the forward activations the backward kernel keeps,
    in the layout of ``_launch_bwd(..., activations=True)`` (bf16 weights:
    float32, with the bf16 semantics of the module doc)."""
    lowp = weights[0].dtype == torch.bfloat16
    if lowp:
        x, weights = x.float(), tuple(w.float() for w in weights)
    inputs, saves = _forward_saves(x, weights, dilations, twin, None, lowp)
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
                            acts=None, *, compute=torch.float32):
    """Plain PyTorch backward, written out as the Pallas backward walks it
    (not autograd): recompute the chain, then go through it in reverse.
    x, dy (B, T, D) -> (dx, (dwi, dwl, dwr, dwo, dalphas, dgammas,
    dbetas)), the weight gradients summed over the batch. Only the
    branches that run get a gradient: a single-branch chain leaves ``wr``
    and row 1 of the (p, 3, C) tables at zero.

    bf16 weights: the bf16 semantics of the module doc, computed in
    ``compute`` around the bf16 operands; dx comes out in x's dtype, the
    gradients in bf16. As in the Pallas kernel, x and dy may be float32
    with bf16 weights (one TCM of a chain on its float32 trunk and
    cotangent).

    ``acts`` (from ``_launch_bwd(..., activations=True)``) replaces the
    recomputed trunk inputs, in-projections ``h`` and conv outputs by the
    backward kernel's own: a PReLU input within float32 noise of 0 then
    takes the same branch in both, and the comparison sees only the
    reverse walk's arithmetic."""
    x_dtype, lowp = x.dtype, weights[0].dtype == torch.bfloat16
    if lowp:
        # the cotangent arrives rounded to x's dtype, as the kernel takes it
        x, dy = x.to(compute), dy.to(x_dtype).to(compute)
        weights = tuple(w.to(compute) for w in weights)
    wi, wl, wr, wo, al, ga, be = weights
    k = wl.shape[1]
    grads = [torch.zeros_like(w) for w in weights]
    dwi, dwl, dwr, dwo, dal, dga, dbe = grads
    branches = ((0, wl, dwl), (1, wr, dwr))[:2 if twin else 1]
    inputs, saves = _forward_saves(x, weights, dilations, twin, acts, lowp)
    for j in range(len(dilations) - 1, -1, -1):
        s, dil = saves[j], dilations[j]
        dyr = _operand(dy, lowp)  # the cotangent as a product operand
        dno = dyr @ wo[j].t()
        dwo[j] += torch.einsum("btc,btd->cd", _operand(s["no"], lowp), dyr)
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
            dc = _operand(dc, lowp)
            dn = torch.zeros_like(dc)
            for i in range(k):
                shift = (k - 1 - i) * dil
                dw[j, i] += torch.einsum(
                    "btk,btc->kc", _operand(_shift(s[f"n{bi}"], shift), lowp),
                    dc)
                dn = dn + _shift(dc @ w[j, i].t(), -shift)
            dp, dga[j, bi], dbe[j, bi] = _in_bwd(
                s[f"xhat{bi}"], s[f"inv{bi}"], ga[j, bi], dn)
            dhb, dal[j, bi] = _prelu_bwd(s["h"], al[j, bi], dp)
            dh = dh + dhb
        dh = _operand(dh, lowp)
        dwi[j] += torch.einsum("btd,btc->dc", _operand(inputs[j], lowp), dh)
        dy = dy + dh @ wi[j].t()
    if lowp:
        return dy.to(x_dtype), tuple(g.to(torch.bfloat16) for g in grads)
    return dy, tuple(grads)


def float32_nudged(v: torch.Tensor, seed: int) -> torch.Tensor:
    """float32 v with each entry moved by float32 rounding, at random: one
    ulp up, one ulp down, or kept."""
    g = torch.Generator(device=v.device).manual_seed(seed)
    u = torch.randint(-1, 2, v.shape, generator=g, device=v.device)
    inf = torch.full_like(v, float("inf"))
    return torch.where(u > 0, torch.nextafter(v, inf),
                       torch.where(u < 0, torch.nextafter(v, -inf), v))


def tcm_chain_bwd_probes(x, dy, weights, dilations, twin, seed=0):
    """Plain bf16 backwards that differ from ``tcm_chain_bwd_reference(x,
    dy, weights, dilations, twin)`` by float32 rounding alone, and take
    nothing from a kernel: the same computed in float64; on the CPU
    (another float32 summation order in every product and reduction; on
    a CPU x, the same as it); on x moved by float32 rounding
    (``float32_nudged``); and on the plain forward's activations (trunk
    inputs, h, conv outputs), each moved so. -> four (dx, grads) on x's
    device, as that returns them. How far they lie from it is D, how far
    float32 rounding alone moves the plain version: a bf16 rounding that
    flips there moves what follows by a bf16 step, so D is a sample of a
    heavy-tailed spread, and the nearest of several samples says more
    than one."""
    xf, dyr = x.float(), dy.to(x.dtype).float()
    out = [tcm_chain_bwd_reference(x, dy, weights, dilations, twin,
                                   compute=torch.float64)]
    dx, grads = tcm_chain_bwd_reference(
        x.cpu(), dy.cpu(), tuple(w.cpu() for w in weights), dilations, twin)
    out.append((dx.to(x.device), tuple(g.to(x.device) for g in grads)))
    dx, grads = tcm_chain_bwd_reference(float32_nudged(xf, seed), dyr,
                                        weights, dilations, twin)
    out.append((dx.to(x.dtype), grads))
    acts = tcm_chain_activations_reference(xf, weights, dilations, twin)
    acts = {"x": float32_nudged(acts["x"], seed + 1),
            "h": float32_nudged(acts["h"], seed + 2),
            "c": tuple(float32_nudged(c, seed + 3 + i)
                       for i, c in enumerate(acts["c"]))}
    out.append(tcm_chain_bwd_reference(x, dy, weights, dilations, twin,
                                       acts=acts))
    return out


def _check(x, weights, dilations):
    tensors = (x,) + tuple(weights)
    if x.dtype not in (torch.float32, torch.bfloat16) or any(
            t.dtype != x.dtype for t in tensors):
        raise TypeError("tcm_chain takes all float32 or all bfloat16 "
                        "tensors, got " + ", ".join(str(t.dtype)
                                                    for t in tensors))
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


def pad_weights(weights: Tuple[torch.Tensor, ...]
                ) -> Tuple[torch.Tensor, ...]:
    """Stacked weights of squeezed width C <= 64 at the kernels' C = 64:
    zero columns of wi, zero in and out channels of wl and wr, zero rows
    of wo, zero slopes, scales and biases. The same tuple at C = 64."""
    n = C_KERNEL - weights[0].shape[-1]
    if n == 0:
        return weights
    wi, wl, wr, wo, *rows = weights
    return (F.pad(wi, (0, n)), F.pad(wl, (0, n, 0, n)),
            F.pad(wr, (0, n, 0, n)), F.pad(wo, (0, 0, 0, n)),
            *(F.pad(v, (0, n)) for v in rows))


def crop_grads(grads: Tuple[torch.Tensor, ...],
               weights: Tuple[torch.Tensor, ...]) -> Tuple[torch.Tensor, ...]:
    """Gradients of ``pad_weights(weights)`` cut back to the shapes of
    ``weights`` (the same tensors where nothing was padded)."""
    return tuple(
        g if g.shape == w.shape else
        g[tuple(slice(0, n) for n in w.shape)].contiguous()
        for g, w in zip(grads, weights))


def _kernel_check(x, weights, dilations):
    b, t, d = x.shape
    k, c, p = weights[1].shape[1], weights[0].shape[-1], len(dilations)
    if c > C_KERNEL or d > 256 or d % 4 or k > 8 or p > 16:
        raise ValueError(
            f"tcm_chain kernel takes C<=64, D<=256 (multiple of 4), K<=8, "
            f"p<=16; got C={c}, D={d}, K={k}, p={p}")
    if not all(w.is_contiguous() and w.data_ptr() % 16 == 0
               for w in (x,) + tuple(weights)):
        raise ValueError("tcm_chain: tensors must be contiguous and 16-byte "
                         "aligned")
    return b, t, d, k, p


def geometry(b: int, t: int, k: int, twin: bool, backward: bool,
             lowp: bool = False) -> dict:
    """The cooperative launch of the forward (its bf16 variant with
    ``lowp``, or the backward's walk) at (B, T) on the current device: its
    tiles, blocks, co-resident blocks per SM, and the most and the mean
    tile rounds per block."""
    lib = load_library()
    out = (ctypes.c_int * 2)()
    err = lib.lib.eabnet_tcm_chain_geometry(int(backward), int(lowp),
                                            int(twin), k, b, t, out)
    lib.check(err, "tcm_chain geometry")
    tiles = b * -(-t // TILE_FRAMES)
    return dict(tiles=tiles, blocks=out[0], blocks_per_sm=out[1],
                rounds_max=-(-tiles // out[0]), rounds_mean=tiles / out[0])


def _count(entry: str) -> None:
    """One launch of the C entry ``eabnet_tcm_chain_<entry>``."""
    n = tcm_chain.entry_launches
    n[entry] = n.get(entry, 0) + 1


def _launch_fwd(x, weights, dilations, twin, trunk=False):
    """The forward kernel -> y, and with ``trunk`` (bf16 only) also a copy
    of the float32 trunk left in the workspace: the trunk input of the
    chain's last TCM (that TCM writes only y)."""
    b, t, d, k, p = _kernel_check(x, weights, dilations)
    weights = pad_weights(weights)
    lib = load_library()
    y = torch.empty_like(x)
    lowp = x.dtype == torch.bfloat16
    # bf16: a float32 trunk (B, T, D) after the forward's scratch
    n_work = int(lib.lib.eabnet_tcm_chain_workspace(b, t)) + (
        b * t * d if lowp else 0)
    work = torch.empty(n_work, dtype=torch.float32, device=x.device)
    dils = (ctypes.c_int * p)(*dilations)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    entry = "fwd_bf16" if lowp else "fwd"
    fn = getattr(lib.lib, "eabnet_tcm_chain_" + entry)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), *(w.data_ptr() for w in weights),
                 y.data_ptr(), work.data_ptr(), b, t, d, k, p, dils,
                 int(twin), stream)
    lib.check(err, "tcm_chain kernel launch")
    tcm_chain.launches += 1
    _count(entry)
    if not trunk:
        return y
    if not lowp:
        raise ValueError("tcm_chain: only the bf16 forward keeps its trunk "
                         "in the workspace")
    return y, work[n_work - b * t * d:].view(b, t, d).clone()


def bf16_trunks(x: torch.Tensor, weights: Tuple[torch.Tensor, ...],
                dilations: Sequence[int], twin: bool) -> list:
    """The bf16 forward kernel's float32 trunk after each TCM of the chain
    on a bf16 x (B, T, D) on the card -> p float32 (B, T, D) tensors. The
    trunk after TCM j is read from a launch of TCMs 0 .. j followed by TCM
    j again: it is the trunk input of that launch's last TCM. So TCM j is
    seen alone, on the kernel's own float32 trunk input (the trunk after
    TCM j - 1), with no bf16 rounding of its output."""
    _check(x, weights, dilations)
    if x.device.type != "cuda" or x.dtype != torch.bfloat16:
        raise ValueError("bf16_trunks: reads the bf16 kernel's workspace; "
                         "takes bf16 tensors on the card")
    out = []
    for j in range(len(dilations)):
        pick = list(range(j + 1)) + [j]
        w = tuple(v[pick].contiguous() for v in weights)
        out.append(_launch_fwd(x, w, [int(dilations[i]) for i in pick],
                               twin, trunk=True)[1])
    return out


def _launch_bwd(x, dy, weights, dilations, twin, activations=False):
    """The backward kernel (float32, or bf16 on bf16 tensors): -> (dx,
    (dwi, dwl, dwr, dwo, dalphas, dgammas, dbetas)) in x's dtype, and with
    ``activations`` also the forward it recomputed and the cotangents it
    carried, float32: {"x": trunk inputs of TCMs 1..p-1 (p-1, B, T, D),
    "h": (p, B, T, C), "c": (branch-L, branch-R) conv outputs, each (p, B,
    T, C), "dy": the cotangents at the outputs of TCMs 0..p-2 (p-1, B, T,
    D), "no": the normalised gate outputs (p, B, T, C)} (copies of the
    kernel's workspace, laid out as ``csrc/tcm_chain.cu`` documents in
    ``eabnet_tcm_chain_bwd``; C wide, the chain's own width)."""
    dy = dy.contiguous()
    b, t, d, k, p = _kernel_check(x, weights, dilations)
    narrow, weights = weights, pad_weights(weights)
    if dy.dtype != x.dtype or dy.shape != x.shape:
        raise TypeError("tcm_chain backward: dy must have x's shape and "
                        "dtype")
    lowp = x.dtype == torch.bfloat16
    lib = load_library()
    n_work = int(lib.lib.eabnet_tcm_chain_bwd_workspace(b, t, d, k, p,
                                                        int(twin), int(lowp)))
    if n_work < 0:
        raise RuntimeError("tcm_chain backward: the kernel cannot be sized "
                           "on this device")
    dx = torch.empty_like(x)
    grads = torch.empty(sum(w.numel() for w in weights), dtype=x.dtype,
                        device=x.device)
    work = torch.empty(n_work, dtype=torch.float32, device=x.device)
    dils = (ctypes.c_int * p)(*dilations)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    entry = "bwd_bf16" if lowp else "bwd"
    fn = getattr(lib.lib, "eabnet_tcm_chain_" + entry)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), dy.data_ptr(), *(w.data_ptr() for w in weights),
                 dx.data_ptr(), grads.data_ptr(), work.data_ptr(), b, t, d, k,
                 p, dils, int(twin), stream)
    lib.check(err, "tcm_chain backward kernel launch")
    tcm_chain.bwd_launches += 1
    _count(entry)
    dw = crop_grads(tuple(g.view(w.shape) for g, w in zip(
        torch.split(grads, [w.numel() for w in weights]), weights)), narrow)
    if not activations:
        return dx, dw
    c, cn = weights[0].shape[-1], narrow[0].shape[-1]
    btc, btd = b * t * c, b * t * d
    offs = (ctypes.c_longlong * 3)()
    lib.check(lib.lib.eabnet_tcm_chain_bwd_offsets(
        b, t, d, k, p, int(twin), int(lowp), offs), "tcm_chain offsets")
    o = offs[0] + (btd if lowp else 0)  # bf16: slot 0 is x's copy
    xs = work[o:o + (p - 1) * btd].view(p - 1, b, t, d).clone()
    o += (p - 1) * btd
    hs, cl, cr = (work[o + i * p * btc:o + (i + 1) * p * btc]
                  .view(p, b, t, c)[..., :cn].clone() for i in range(3))
    dys = work[offs[1]:offs[1] + (p - 1) * btd].view(p - 1, b, t, d).clone()
    nos = work[offs[2]:offs[2] + p * btc].view(p, b, t, c)[..., :cn].clone()
    return dx, dw, {"x": xs, "h": hs, "c": (cl, cr), "dy": dys, "no": nos}


class _TCMChain(torch.autograd.Function):
    """The chain on the card, with the backward kernel as its gradient
    (float32 or bf16). Only the group input is saved; the backward
    recomputes the rest."""

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


class _TCMChainPlain(torch.autograd.Function):
    """bf16 on the CPU: the plain forward, with the plain bf16 backward
    (the explicit reverse walk) as its gradient."""

    @staticmethod
    def forward(ctx, x, dilations, twin, *weights):
        ctx.dilations, ctx.twin = dilations, twin
        ctx.save_for_backward(x, *weights)
        return tcm_chain_reference(x, weights, dilations, twin)

    @staticmethod
    def backward(ctx, dy):
        x, *weights = ctx.saved_tensors
        dx, grads = tcm_chain_bwd_reference(x, dy, tuple(weights),
                                            ctx.dilations, ctx.twin)
        return (dx, None, None) + grads


def tcm_chain(x: torch.Tensor, weights: Tuple[torch.Tensor, ...],
              dilations: Sequence[int], twin: bool) -> torch.Tensor:
    """Run one SqueezedTCNGroup: the plain version on a CPU tensor (in
    float32 autograd of it is the gradient there, in bf16 the plain bf16
    backward), the CUDA kernels on a CUDA tensor. bfloat16 tensors take
    the bf16 semantics (module doc) and the bf16 kernels. Forward launches
    of either dtype are counted in ``tcm_chain.launches``, backward
    launches in ``tcm_chain.bwd_launches``, and every launch by its C
    entry in ``tcm_chain.entry_launches`` ({"fwd", "fwd_bf16", "bwd",
    "bwd_bf16"}: count)."""
    _check(x, weights, dilations)
    dilations = tuple(int(v) for v in dilations)
    grad = torch.is_grad_enabled() and any(
        w.requires_grad for w in (x,) + tuple(weights))
    if x.device.type == "cpu":
        if grad and x.dtype == torch.bfloat16:
            return _TCMChainPlain.apply(x, dilations, bool(twin), *weights)
        return tcm_chain_reference(x, weights, dilations, twin)
    if x.device.type != "cuda":
        raise ValueError(f"tcm_chain: no kernel for device {x.device}")
    if grad:
        return _TCMChain.apply(x, dilations, bool(twin), *weights)
    return _launch_fwd(x, weights, dilations, twin)


tcm_chain.launches = 0
tcm_chain.bwd_launches = 0
tcm_chain.entry_launches = {}
