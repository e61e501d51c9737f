"""The block library of EaBNet and GaGNet, in PyTorch.

2-D maps are channel-first ``(B, C, T, F)``: time is the causal, stride-1
axis and frequency the only downsampled one. The squeezed TCN runs on
``(B, T, D)`` frame vectors, the layout of the TCM-chain kernel. Module and
parameter names follow the JAX package's parameter tree so that
``weights.load_jax_params`` maps one onto the other by name; the layouts
are PyTorch's (see ``weights.py``). Inside ``stepping.stepping`` the
time convs take one frame and a ring of the frames before it; inside
``parallel/freq.py``'s ``sharding`` the frequency convs compute the
rank's output columns from the input columns they read.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from eabnet_tpu_torch.kernels.tcm_chain import tcm_chain
from eabnet_tpu_torch.nn.norms import NormSwitch, PReLU
from eabnet_tpu_torch.nn.stepping import current
from eabnet_tpu_torch.parallel import freq


class Dense(nn.Module):
    """``x @ kernel.T + bias`` over the last axis; kernel (out, in)."""

    def __init__(self, in_dim: int, out_dim: int, bias: bool = True):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(out_dim, in_dim))
        nn.init.kaiming_uniform_(self.kernel, a=5 ** 0.5)
        self.bias = nn.Parameter(torch.zeros(out_dim)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.kernel, self.bias)


class Conv2d(nn.Module):
    """2-D conv, kernel (O, I, kt, kf), causal in time: the left pad of
    kt-1 frames is the conv's own padding, and the frames it adds past the
    end are dropped. Frequency-sharded, it computes the rank's output
    columns (``FreqShard.conv_input``)."""

    def __init__(self, cin: int, cout: int, kernel: Tuple[int, int],
                 stride: Tuple[int, int]):
        super().__init__()
        self.stride = tuple(stride)
        self.kernel = nn.Parameter(torch.empty(cout, cin, *kernel))
        nn.init.kaiming_uniform_(self.kernel, a=5 ** 0.5)
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        kt = self.kernel.shape[2]
        fr = current()
        if fr is not None:  # one frame, on the ring of the kt - 1 before
            return F.conv2d(fr.ring(self, x, kt - 1), self.kernel,
                            self.bias, self.stride)
        sh = freq.current()
        if sh is not None:
            x, _ = sh.conv_input(x, self.kernel.shape[3], transposed=False)
        y = F.conv2d(x, self.kernel, self.bias, self.stride,
                     padding=(kt - 1, 0))
        return y[:, :, :x.shape[2]]


class ConvTranspose2d(nn.Module):
    """2-D transposed conv, kernel (I, O, kt, kf), with the causal chomp of
    the last kt-1 frames; frequency-sharded, the rank's output columns."""

    def __init__(self, cin: int, cout: int, kernel: Tuple[int, int],
                 stride: Tuple[int, int]):
        super().__init__()
        self.stride = tuple(stride)
        self.kernel = nn.Parameter(torch.empty(cin, cout, *kernel))
        nn.init.kaiming_uniform_(self.kernel, a=5 ** 0.5)
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        fr = current()
        if fr is not None:
            # one frame: the conv of its kt-frame window, whose output
            # frame kt - 1 is the offline output at the window's last frame
            kt = self.kernel.shape[2]
            y = F.conv_transpose2d(fr.ring(self, x, kt - 1), self.kernel,
                                   self.bias, self.stride)
            return y[:, :, kt - 1:kt]
        sh = freq.current()
        keep = None
        if sh is not None:
            x, keep = sh.conv_input(x, self.kernel.shape[3], transposed=True)
        y = F.conv_transpose2d(x, self.kernel, self.bias, self.stride)
        if keep is not None:
            y = y[..., keep[0]:keep[1]]
        return y[:, :, :x.shape[2]]


class Conv1d(nn.Module):
    """Dilated 1-D conv over time without bias, kernel (O, I, K), on
    (B, C, T). Causal: the left pad is the conv's padding and the frames
    added past the end are dropped."""

    def __init__(self, c: int, k: int, dilation: int, causal: bool = True):
        super().__init__()
        self.dilation = dilation
        self.causal = causal
        self.kernel = nn.Parameter(torch.empty(c, c, k))
        nn.init.kaiming_uniform_(self.kernel, a=5 ** 0.5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        full = (self.kernel.shape[2] - 1) * self.dilation
        fr = current()
        if fr is not None:  # one frame of a causal conv
            return F.conv1d(fr.ring(self, x, full), self.kernel,
                            dilation=self.dilation)
        pad = full if self.causal else full // 2
        y = F.conv1d(x, self.kernel, padding=pad, dilation=self.dilation)
        return y[:, :, :x.shape[2]]


class _GLU(nn.Module):
    """A conv emitting 2*out channels; ``out * sigmoid(gate)`` with
    ``out, gate = split(y, 2)`` in that order."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out, gate = torch.chunk(self.conv(x), 2, dim=1)
        return out * torch.sigmoid(gate)


class GateConv2d(_GLU):
    def __init__(self, cin: int, out_ch: int, kernel, stride):
        super().__init__()
        self.conv = Conv2d(cin, 2 * out_ch, kernel, stride)


class GateConvTranspose2d(_GLU):
    def __init__(self, cin: int, out_ch: int, kernel, stride):
        super().__init__()
        self.conv = ConvTranspose2d(cin, 2 * out_ch, kernel, stride)


class _ConvUnit(nn.Module):
    """Frequency-resampling conv + norm + PReLU."""

    def __init__(self, conv: nn.Module, ch: int, norm_type: str):
        super().__init__()
        self.conv = conv
        self.norm = NormSwitch(norm_type, ch)
        self.act = PReLU(ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.act(self.norm(self.conv(x)))


def Conv2dUnit(cin: int, kernel, ch: int, norm_type: str) -> _ConvUnit:
    return _ConvUnit(Conv2d(cin, ch, kernel, (1, 2)), ch, norm_type)


def Deconv2dUnit(cin: int, kernel, ch: int, norm_type: str) -> _ConvUnit:
    return _ConvUnit(ConvTranspose2d(cin, ch, kernel, (1, 2)), ch, norm_type)


def skip_connect(x_main: torch.Tensor, x_aux: torch.Tensor,
                 connect: str) -> torch.Tensor:
    """add / channel-cat merge."""
    if connect == "add":
        return x_main + x_aux
    return torch.cat([x_main, x_aux], dim=1)


class EnUnetModule(nn.Module):
    """Nested mini-UNet stage: gated in-conv, ``scale`` downsampling units,
    ``scale`` upsampling units with intra skips, residual add."""

    def __init__(self, cin: int, cout: int, k1, k2, intra_connect: str,
                 norm_type: str, scale: int, is_deconv: bool = False):
        super().__init__()
        conv_cls = GateConvTranspose2d if is_deconv else GateConv2d
        self.intra_connect = intra_connect
        self.scale = scale
        self.in_conv = conv_cls(cin, cout, k1, (1, 2))
        self.in_norm = NormSwitch(norm_type, cout)
        self.in_act = PReLU(cout)
        cat = 2 if intra_connect == "cat" else 1
        for i in range(scale):
            self.add_module(f"enco_{i}", Conv2dUnit(cout, k2, cout, norm_type))
        for i in range(scale):
            self.add_module(f"deco_{i}", Deconv2dUnit(
                cout if i == 0 else cat * cout, k2, cout, norm_type))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.in_act(self.in_norm(self.in_conv(x)))
        x_resi = x
        skips = []
        for i in range(self.scale):
            x = getattr(self, f"enco_{i}")(x)
            skips.append(x)
        for i in range(self.scale):
            if i > 0:
                x = skip_connect(x, skips[-(i + 1)], self.intra_connect)
            x = getattr(self, f"deco_{i}")(x)
        return x_resi + x


class U2NetEncoder(nn.Module):
    """Four nested-UNet stages + gated out-conv (freq 161 -> 79 -> 39 -> 19
    -> 9 -> 4). Returns (features, skip list)."""

    def __init__(self, cin: int, c: int, k1, k2, intra_connect: str,
                 norm_type: str, c_end: int = 64, k_beg=(2, 5)):
        super().__init__()
        for i, scale in enumerate((4, 3, 2, 1)):
            self.add_module(f"unet_{i}", EnUnetModule(
                cin if i == 0 else c, c, k_beg if i == 0 else k1, k2,
                intra_connect, norm_type, scale))
        self.last_conv = GateConv2d(c, c_end, k1, (1, 2))
        self.last_norm = NormSwitch(norm_type, c_end)
        self.last_act = PReLU(c_end)

    def forward(self, x: torch.Tensor):
        skips = []
        for i in range(4):
            x = getattr(self, f"unet_{i}")(x)
            skips.append(x)
        x = self.last_act(self.last_norm(self.last_conv(x)))
        skips.append(x)
        return x, skips


class U2NetDecoder(nn.Module):
    """Mirror of U2NetEncoder with skip-cat inputs."""

    def __init__(self, embed_dim: int, c: int, k1, k2, intra_connect: str,
                 norm_type: str, c_end: int = 64, k_end=(2, 5)):
        super().__init__()
        for i, scale in enumerate((1, 2, 3, 4)):
            self.add_module(f"unet_{i}", EnUnetModule(
                (c_end if i == 0 else c) + (c_end if i == 0 else c), c, k1,
                k2, intra_connect, norm_type, scale, is_deconv=True))
        self.last_conv = GateConvTranspose2d(2 * c, embed_dim, k_end, (1, 2))
        self.last_norm = NormSwitch(norm_type, embed_dim)
        self.last_act = PReLU(embed_dim)

    def forward(self, x: torch.Tensor, skips) -> torch.Tensor:
        for i in range(4):
            x = torch.cat([x, skips[-(i + 1)]], dim=1)
            x = getattr(self, f"unet_{i}")(x)
        x = torch.cat([x, skips[0]], dim=1)
        return self.last_act(self.last_norm(self.last_conv(x)))


class UNetEncoder(nn.Module):
    """Plain 5-stage gated-conv encoder (freq 161 -> 79 -> 39 -> 19 -> 9
    -> 4). ``norm_stages`` marks the stages that carry a norm: EaBNet's
    copy has none on stages 1 and 2, GaGNet's norms all five. Returns
    (features, skip list)."""

    def __init__(self, cin: int, c: int, k1, norm_type: str, c_end: int = 64,
                 k_beg=(2, 5),
                 norm_stages: Sequence[bool] = (True, False, False, True,
                                                True)):
        super().__init__()
        self.norm_stages = tuple(norm_stages)
        for i in range(5):
            ch = c_end if i == 4 else c
            self.add_module(f"conv_{i}", GateConv2d(
                cin if i == 0 else c, ch, k_beg if i == 0 else k1, (1, 2)))
            if self.norm_stages[i]:
                self.add_module(f"norm_{i}", NormSwitch(norm_type, ch))
            self.add_module(f"act_{i}", PReLU(ch))

    def forward(self, x: torch.Tensor):
        skips = []
        for i in range(5):
            x = getattr(self, f"conv_{i}")(x)
            if self.norm_stages[i]:
                x = getattr(self, f"norm_{i}")(x)
            x = getattr(self, f"act_{i}")(x)
            skips.append(x)
        return x, skips


class UNetDecoder(nn.Module):
    """Mirror of UNetEncoder: gated transposed convs on skip-cat inputs,
    every stage normed."""

    def __init__(self, embed_dim: int, c: int, k1, norm_type: str,
                 c_end: int = 64, k_end=(2, 5)):
        super().__init__()
        for i in range(5):
            ch = embed_dim if i == 4 else c
            self.add_module(f"conv_{i}", GateConvTranspose2d(
                2 * c_end if i == 0 else 2 * c, ch, k_end if i == 4 else k1,
                (1, 2)))
            self.add_module(f"norm_{i}", NormSwitch(norm_type, ch))
            self.add_module(f"act_{i}", PReLU(ch))

    def forward(self, x: torch.Tensor, skips) -> torch.Tensor:
        for i in range(5):
            x = torch.cat([x, skips[-(i + 1)]], dim=1)
            x = getattr(self, f"conv_{i}")(x)
            x = getattr(self, f"act_{i}")(getattr(self, f"norm_{i}")(x))
        return x


class SqueezedTCM(nn.Module):
    """Squeezed temporal conv module on (B, T, D) frame vectors.

    ``twin_gate=True`` (EaBNet): 1x1 in-conv, two PReLU -> norm -> dilated
    conv branches, ``left * sigmoid(right)``; ``twin_gate=False`` (GaGNet):
    one branch. Then PReLU -> norm -> 1x1 out-conv and the residual.
    ``SqueezedTCNGroup`` runs causal IN chains of them through the
    TCM-chain kernel, and every other chain module by module.
    """

    def __init__(self, kd1: int, cd1: int, d_feat: int, dilation: int,
                 is_causal: bool = True, norm_type: str = "IN",
                 twin_gate: bool = True):
        super().__init__()
        self.branches = ("left", "right") if twin_gate else ("main",)
        self.in_conv = Dense(d_feat, cd1, bias=False)
        for b in self.branches:
            self.add_module(f"{b}_act", PReLU(cd1))
            self.add_module(f"{b}_norm", NormSwitch(norm_type, cd1))
            self.add_module(f"{b}_conv", Conv1d(cd1, kd1, dilation,
                                                is_causal))
        self.out_act = PReLU(cd1)
        self.out_norm = NormSwitch(norm_type, cd1)
        self.out_conv = Dense(cd1, d_feat, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.in_conv(x).transpose(1, 2)  # (B, C, T)
        outs = [getattr(self, f"{b}_conv")(getattr(self, f"{b}_norm")(
            getattr(self, f"{b}_act")(h))) for b in self.branches]
        g = outs[0] * torch.sigmoid(outs[1]) if len(outs) == 2 else outs[0]
        g = self.out_norm(self.out_act(g))
        return x + self.out_conv(g.transpose(1, 2))


class SqueezedTCNGroup(nn.Module):
    """A chain of SqueezedTCMs with the given dilations. A causal IN group
    runs as one call of the TCM-chain kernel wrapper
    (``kernels/tcm_chain.py``): the kernel on a CUDA tensor, its plain
    version on a CPU tensor. Any other group runs its TCM modules one by
    one on every device, as the JAX package routes it (its kernel covers
    causal IN only); the configuration fixes the route, not the device."""

    def __init__(self, kd1: int, cd1: int, d_feat: int,
                 dilations: Sequence[int], is_causal: bool = True,
                 norm_type: str = "IN", twin_gate: bool = True):
        super().__init__()
        self.chain = norm_type == "IN" and is_causal
        self.dilations = tuple(int(d) for d in dilations)
        self.twin_gate = twin_gate
        for i, d in enumerate(self.dilations):
            self.add_module(f"tcm_{i}", SqueezedTCM(
                kd1, cd1, d_feat, d, is_causal, norm_type, twin_gate))

    def stacked_weights(self) -> Tuple[torch.Tensor, ...]:
        """(wi, wl, wr, wo, alphas, gammas, betas) in the kernel's layout:
        wi (p, D, C), wl/wr (p, K, C, C) as (tap, in, out), wo (p, C, D),
        and (p, 3, C) rows [branch L, branch R (L again when single),
        out] for the PReLU slopes and the norms' scale and bias."""
        tcms = [getattr(self, f"tcm_{i}") for i in range(len(self.dilations))]
        left, right = ("left", "right") if self.twin_gate else ("main",) * 2

        def stack(fn):
            return torch.stack([fn(t) for t in tcms]).contiguous()

        def tri(fn):
            return stack(lambda t: torch.stack(
                [fn(t, left), fn(t, right), fn(t, "out")]))

        return (
            stack(lambda t: t.in_conv.kernel.t()),
            stack(lambda t: getattr(t, f"{left}_conv").kernel.permute(2, 1, 0)),
            stack(lambda t: getattr(t, f"{right}_conv").kernel.permute(2, 1, 0)),
            stack(lambda t: t.out_conv.kernel.t()),
            tri(lambda t, n: getattr(t, f"{n}_act").alpha),
            tri(lambda t, n: getattr(t, f"{n}_norm").norm.scale),
            tri(lambda t, n: getattr(t, f"{n}_norm").norm.bias),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.chain:
            return tcm_chain(x.contiguous(), self.stacked_weights(),
                             self.dilations, self.twin_gate)
        for i in range(len(self.dilations)):
            x = getattr(self, f"tcm_{i}")(x)
        return x
