"""The plain reference of the benchmarked models: EaBNet with its LSTM
beamforming head, then the GaGNet post-filter, in plain PyTorch.

A frozen copy of the published architecture as the released
configurations run it (U²Net encoder and decoder, squeezed TCN groups,
the LSTM-BF head, glance/gaze stages), written without any kernel,
batching trick or streaming path: every TCN module runs on its own, the
two LSTMs are a loop over time, every norm is its formula. It imports
nothing of the program under test. Module and parameter names are those
of the released parameter trees, so one set of weights, keyed by name,
serves both sides; layouts are PyTorch's (``weights.py``).

``rounding``: every product (a Dense, a conv, an LSTM matmul) takes its
two operands through ``rounding(x)``, the identity by default. The
controls of the benchmark put a lower precision there (``precision.py``).

Only what the two released configurations use is here: ``is_u2`` with
``intra_connect="cat"``, the ``mimo`` LSTM head, IN and cLN norms.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import torch
import torch.nn.functional as F
from torch import nn


def _identity(x: torch.Tensor) -> torch.Tensor:
    return x


class _Products(nn.Module):
    """A module whose products round their operands through
    ``self.rounding`` (set for a whole tree by ``set_rounding``)."""

    rounding: Callable = staticmethod(_identity)

    def r(self, x: torch.Tensor) -> torch.Tensor:
        return self.rounding(x)


def set_rounding(model: nn.Module, rounding: Callable) -> nn.Module:
    """Route every product of ``model`` through ``rounding``."""
    for m in model.modules():
        if isinstance(m, _Products):
            m.rounding = rounding
    return model


def _bcast(v: torch.Tensor, ndim: int) -> torch.Tensor:
    return v.view(1, -1, *([1] * (ndim - 2)))


class Dense(_Products):
    """y = x W^T + b, W (out, in)."""

    def __init__(self, in_dim: int, out_dim: int, bias: bool = True):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(out_dim, in_dim))
        self.bias = nn.Parameter(torch.zeros(out_dim)) if bias else None

    def forward(self, x):
        return F.linear(self.r(x), self.r(self.kernel), self.bias)


class Conv2d(_Products):
    """Causal in time (left pad kt - 1), strided along frequency."""

    def __init__(self, cin, cout, kernel, stride):
        super().__init__()
        self.stride = tuple(stride)
        self.kernel = nn.Parameter(torch.zeros(cout, cin, *kernel))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x):
        kt = self.kernel.shape[2]
        x = F.pad(x, (0, 0, kt - 1, 0))
        return F.conv2d(self.r(x), self.r(self.kernel), self.bias,
                        self.stride)


class ConvTranspose2d(_Products):
    """Transposed conv along frequency; the last kt - 1 frames dropped."""

    def __init__(self, cin, cout, kernel, stride):
        super().__init__()
        self.stride = tuple(stride)
        self.kernel = nn.Parameter(torch.zeros(cin, cout, *kernel))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x):
        y = F.conv_transpose2d(self.r(x), self.r(self.kernel), self.bias,
                               self.stride)
        return y[:, :, :x.shape[2]]


class Conv1d(_Products):
    """Dilated causal conv over time, no bias, on (B, C, T)."""

    def __init__(self, c, k, dilation):
        super().__init__()
        self.dilation = dilation
        self.kernel = nn.Parameter(torch.zeros(c, c, k))

    def forward(self, x):
        pad = (self.kernel.shape[2] - 1) * self.dilation
        x = F.pad(x, (pad, 0))
        return F.conv1d(self.r(x), self.r(self.kernel),
                        dilation=self.dilation)


class PReLU(nn.Module):
    def __init__(self, features):
        super().__init__()
        self.alpha = nn.Parameter(torch.full((features,), 0.25))

    def forward(self, x):
        return torch.clamp(x, min=0) + _bcast(self.alpha, x.dim()) * \
            torch.clamp(x, max=0)


class _Affine(nn.Module):
    def __init__(self, features, eps=1e-5):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def affine(self, y):
        return y * _bcast(self.scale, y.dim()) + _bcast(self.bias, y.dim())


class InstanceNorm(_Affine):
    """Statistics per item and channel over time and every later axis."""

    def forward(self, x):
        axes = tuple(range(2, x.dim()))
        mean = x.mean(dim=axes, keepdim=True)
        var = torch.square(x - mean).mean(dim=axes, keepdim=True)
        return self.affine((x - mean) / torch.sqrt(var + self.eps))


class CumulativeLayerNorm(_Affine):
    """Frame t normalised by the statistics of frames 0..t over channels
    and later axes, plus one virtual zero-mean, unit-variance frame;
    float32 sums, variance clamped at 0."""

    def forward(self, x):
        red = (1,) + tuple(range(3, x.dim()))
        n = x.numel() // (x.shape[0] * x.shape[2])
        xf = x.float()
        shape = (x.shape[0], 1, x.shape[2]) + (1,) * (x.dim() - 3)
        total = torch.cumsum(xf.sum(dim=red), dim=1).view(shape)
        sq = (torch.cumsum(torch.square(xf).sum(dim=red), dim=1)
              + float(n)).view(shape)
        count = (torch.arange(1, x.shape[2] + 1, dtype=torch.float32,
                              device=x.device) * n + float(n)
                 ).view((1, 1, -1) + (1,) * (x.dim() - 3))
        mean = total / count
        var = torch.clamp(sq / count - torch.square(mean), min=0.0)
        return self.affine(((xf - mean) / torch.sqrt(var + self.eps)
                            ).to(x.dtype))


class NormSwitch(nn.Module):
    def __init__(self, norm_type, features):
        super().__init__()
        if norm_type == "IN":
            self.norm = InstanceNorm(features)
        elif norm_type == "cLN":
            self.norm = CumulativeLayerNorm(features)
        else:
            raise ValueError(f"the reference has no norm {norm_type!r}")

    def forward(self, x):
        return self.norm(x)


class _GLU(nn.Module):
    def forward(self, x):
        out, gate = torch.chunk(self.conv(x), 2, dim=1)
        return out * torch.sigmoid(gate)


class GateConv2d(_GLU):
    def __init__(self, cin, out_ch, kernel, stride):
        super().__init__()
        self.conv = Conv2d(cin, 2 * out_ch, kernel, stride)


class GateConvTranspose2d(_GLU):
    def __init__(self, cin, out_ch, kernel, stride):
        super().__init__()
        self.conv = ConvTranspose2d(cin, 2 * out_ch, kernel, stride)


class _ConvUnit(nn.Module):
    def __init__(self, conv, ch, norm_type):
        super().__init__()
        self.conv = conv
        self.norm = NormSwitch(norm_type, ch)
        self.act = PReLU(ch)

    def forward(self, x):
        return self.act(self.norm(self.conv(x)))


class EnUnetModule(nn.Module):
    """Gated in-conv, ``scale`` down units, ``scale`` up units with
    channel-cat intra skips, residual add."""

    def __init__(self, cin, cout, k1, k2, norm_type, scale, is_deconv=False):
        super().__init__()
        gate = GateConvTranspose2d if is_deconv else GateConv2d
        self.scale = scale
        self.in_conv = gate(cin, cout, k1, (1, 2))
        self.in_norm = NormSwitch(norm_type, cout)
        self.in_act = PReLU(cout)
        for i in range(scale):
            self.add_module(f"enco_{i}", _ConvUnit(
                Conv2d(cout, cout, k2, (1, 2)), cout, norm_type))
        for i in range(scale):
            self.add_module(f"deco_{i}", _ConvUnit(ConvTranspose2d(
                cout if i == 0 else 2 * cout, cout, k2, (1, 2)), cout,
                norm_type))

    def forward(self, x):
        x = self.in_act(self.in_norm(self.in_conv(x)))
        resi, skips = x, []
        for i in range(self.scale):
            x = getattr(self, f"enco_{i}")(x)
            skips.append(x)
        for i in range(self.scale):
            if i > 0:
                x = torch.cat([x, skips[-(i + 1)]], dim=1)
            x = getattr(self, f"deco_{i}")(x)
        return resi + x


class U2NetEncoder(nn.Module):
    def __init__(self, cin, c, k1, k2, norm_type, c_end=64, k_beg=(2, 5)):
        super().__init__()
        for i, scale in enumerate((4, 3, 2, 1)):
            self.add_module(f"unet_{i}", EnUnetModule(
                cin if i == 0 else c, c, k_beg if i == 0 else k1, k2,
                norm_type, scale))
        self.last_conv = GateConv2d(c, c_end, k1, (1, 2))
        self.last_norm = NormSwitch(norm_type, c_end)
        self.last_act = PReLU(c_end)

    def forward(self, x):
        skips = []
        for i in range(4):
            x = getattr(self, f"unet_{i}")(x)
            skips.append(x)
        x = self.last_act(self.last_norm(self.last_conv(x)))
        skips.append(x)
        return x, skips


class U2NetDecoder(nn.Module):
    def __init__(self, embed_dim, c, k1, k2, norm_type, c_end=64,
                 k_end=(2, 5)):
        super().__init__()
        for i, scale in enumerate((1, 2, 3, 4)):
            width = c_end if i == 0 else c
            self.add_module(f"unet_{i}", EnUnetModule(
                2 * width, c, k1, k2, norm_type, scale, is_deconv=True))
        self.last_conv = GateConvTranspose2d(2 * c, embed_dim, k_end, (1, 2))
        self.last_norm = NormSwitch(norm_type, embed_dim)
        self.last_act = PReLU(embed_dim)

    def forward(self, x, skips):
        for i in range(4):
            x = getattr(self, f"unet_{i}")(torch.cat([x, skips[-(i + 1)]],
                                                     dim=1))
        x = torch.cat([x, skips[0]], dim=1)
        return self.last_act(self.last_norm(self.last_conv(x)))


class SqueezedTCM(nn.Module):
    """1x1 in-conv; one branch (or two, gated ``left * sigmoid(right)``) of
    PReLU -> norm -> dilated causal conv; PReLU -> norm -> 1x1 out-conv;
    residual. On (B, T, D) frame vectors."""

    def __init__(self, kd1, cd1, d_feat, dilation, norm_type, twin_gate):
        super().__init__()
        self.branches = ("left", "right") if twin_gate else ("main",)
        self.in_conv = Dense(d_feat, cd1, bias=False)
        for b in self.branches:
            self.add_module(f"{b}_act", PReLU(cd1))
            self.add_module(f"{b}_norm", NormSwitch(norm_type, cd1))
            self.add_module(f"{b}_conv", Conv1d(cd1, kd1, dilation))
        self.out_act = PReLU(cd1)
        self.out_norm = NormSwitch(norm_type, cd1)
        self.out_conv = Dense(cd1, d_feat, bias=False)

    def forward(self, x):
        h = self.in_conv(x).transpose(1, 2)
        outs = [getattr(self, f"{b}_conv")(getattr(self, f"{b}_norm")(
            getattr(self, f"{b}_act")(h))) for b in self.branches]
        g = outs[0] * torch.sigmoid(outs[1]) if len(outs) == 2 else outs[0]
        g = self.out_norm(self.out_act(g))
        return x + self.out_conv(g.transpose(1, 2))


class SqueezedTCNGroup(nn.Module):
    def __init__(self, kd1, cd1, d_feat, dilations: Sequence[int],
                 norm_type, twin_gate):
        super().__init__()
        self.n = len(dilations)
        for i, d in enumerate(dilations):
            self.add_module(f"tcm_{i}", SqueezedTCM(
                kd1, cd1, d_feat, int(d), norm_type, twin_gate))

    def forward(self, x):
        for i in range(self.n):
            x = getattr(self, f"tcm_{i}")(x)
        return x


class _LSTMParams(nn.Module):
    """One LSTM layer: w_ih (in, 4H), w_hh (H, 4H), b_ih, b_hh; gates
    i, f, g, o."""

    def __init__(self, in_dim, hidden):
        super().__init__()
        self.w_ih = nn.Parameter(torch.zeros(in_dim, 4 * hidden))
        self.w_hh = nn.Parameter(torch.zeros(hidden, 4 * hidden))
        self.b_ih = nn.Parameter(torch.zeros(4 * hidden))
        self.b_hh = nn.Parameter(torch.zeros(4 * hidden))


class _ScaleBias(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))


def _cell(gates, c_prev):
    i, f, g, o = torch.chunk(gates, 4, dim=-1)
    c = torch.sigmoid(f) * c_prev + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c


class LSTMBeamformer(_Products):
    """LayerNorm over the embedding; each (item, bin) a lane through two
    stacked LSTMs over time; fc1 / ReLU / fc2 -> (B, T, F, M, 2)."""

    def __init__(self, embed_dim, M, hid_node):
        super().__init__()
        self.M = M
        self.norm = _ScaleBias(embed_dim)
        self.rnn1 = _LSTMParams(embed_dim, hid_node)
        self.rnn2 = _LSTMParams(hid_node, hid_node)
        self.fc1 = Dense(hid_node, hid_node)
        self.fc2 = Dense(hid_node, 2 * M)

    def forward(self, x):
        b, c, t, f = x.shape
        x = x.permute(0, 3, 2, 1).reshape(b * f, t, c)
        mean = x.mean(dim=-1, keepdim=True)
        var = torch.square(x - mean).mean(dim=-1, keepdim=True)
        x = (x - mean) / torch.sqrt(var + 1e-5) * self.norm.scale + \
            self.norm.bias
        r1, r2, r = self.rnn1, self.rnn2, self.r
        xw1 = r(x) @ r(r1.w_ih) + (r1.b_ih + r1.b_hh)  # (L, T, 4H)
        zeros = x.new_zeros((b * f, r1.w_hh.shape[0]))
        h1 = c1 = h2 = c2 = zeros
        w_hh1, w_ih2, w_hh2 = r(r1.w_hh), r(r2.w_ih), r(r2.w_hh)
        b2 = r2.b_ih + r2.b_hh
        outs = []
        for step in range(t):
            h1, c1 = _cell(xw1[:, step] + r(h1) @ w_hh1, c1)
            h2, c2 = _cell(r(h1) @ w_ih2 + r(h2) @ w_hh2 + b2, c2)
            outs.append(h2)
        h = torch.stack(outs, dim=1)  # (L, T, H)
        y = self.fc2(torch.relu(self.fc1(h)))
        return y.reshape(b, f, t, self.M, 2).permute(0, 2, 1, 3, 4)


def beamform_sum(bf_w, inpt):
    wr, wi = bf_w[..., 0], bf_w[..., 1]
    xr, xi = inpt[..., 0], inpt[..., 1]
    return torch.stack([(wr * xr - wi * xi).sum(-1),
                        (wr * xi + wi * xr).sum(-1)], dim=-1)


def _check(cfg: Dict, name: str) -> None:
    if not cfg.get("is_u2", True) or cfg.get("intra_connect", "cat") != "cat":
        raise ValueError(f"the reference's {name} takes is_u2 with "
                         "intra_connect='cat' only")
    if not cfg.get("is_causal", True):
        raise ValueError(f"the reference's {name} is causal only")


class EaBNet(nn.Module):
    def __init__(self, cfg: Dict):
        super().__init__()
        _check(cfg, "EaBNet")
        if cfg.get("bf_type", "lstm") != "lstm" \
                or cfg.get("topo_type", "mimo") != "mimo":
            raise ValueError("the reference's EaBNet has the mimo LSTM head "
                             "only")
        self.q = cfg["q"]
        norm = cfg["norm_type"]
        self.en = U2NetEncoder(2 * cfg["M"], cfg["c"], cfg["k1"], cfg["k2"],
                               norm)
        for i in range(self.q):
            self.add_module(f"stcn_{i}", SqueezedTCNGroup(
                cfg["kd1"], cfg["cd1"], cfg["d_feat"],
                [2 ** j for j in range(cfg["p"])], norm, twin_gate=True))
        self.de = U2NetDecoder(cfg["embed_dim"], cfg["c"], cfg["k1"],
                               cfg["k2"], norm)
        self.bf_map = LSTMBeamformer(cfg["embed_dim"], cfg["M"],
                                     cfg["hid_node"])

    def forward(self, inpt):
        """(B, T, F, M, 2) -> (B, T, F, 2)."""
        b, t, f, m, _ = inpt.shape
        x = inpt.reshape(b, t, f, 2 * m).permute(0, 3, 1, 2)
        x, skips = self.en(x)
        c_b, f_b = x.shape[1], x.shape[3]
        x = x.permute(0, 2, 3, 1).reshape(b, t, f_b * c_b)
        acc = torch.zeros_like(x)
        for i in range(self.q):
            x = getattr(self, f"stcn_{i}")(x)
            acc = acc + x
        x = acc.reshape(b, t, f_b, c_b).permute(0, 3, 1, 2)
        x = self.de(x, skips)
        return beamform_sum(self.bf_map(x), inpt)


class _GatedIn(nn.Module):
    def __init__(self, cfg, bins):
        super().__init__()
        self.in_main = Dense(cfg["d_feat"] + 2 * bins, cfg["d_feat"])
        self.in_gate = Dense(cfg["d_feat"] + 2 * bins, cfg["d_feat"])

    def gated_input(self, feat, pre_flat):
        x = torch.cat([feat, pre_flat], dim=-1)
        return self.in_main(x) * torch.sigmoid(self.in_gate(x))


def _stack(cfg):
    return [SqueezedTCNGroup(cfg["kd1"], cfg["cd1"], cfg["d_feat"],
                             cfg["dilas"], cfg["norm_type"], twin_gate=False)
            for _ in range(cfg["p"])]


class GlanceBlock(_GatedIn):
    def __init__(self, cfg, bins):
        super().__init__(cfg, bins)
        self.acti = {"sigmoid": torch.sigmoid, "tanh": torch.tanh,
                     "relu": torch.relu}[cfg.get("acti_type", "sigmoid")]
        self.p = cfg["p"]
        for i, g in enumerate(_stack(cfg)):
            self.add_module(f"tcn_{i}", g)
        self.head = Dense(cfg["d_feat"], bins)

    def forward(self, feat, pre_flat):
        x = self.gated_input(feat, pre_flat)
        for i in range(self.p):
            x = getattr(self, f"tcn_{i}")(x)
        return self.acti(self.head(x))


class GazeBlock(_GatedIn):
    def __init__(self, cfg, bins):
        super().__init__(cfg, bins)
        if cfg.get("is_squeezed", False):
            raise ValueError("the reference's GazeBlock has separate real "
                             "and imaginary stacks only")
        self.p = cfg["p"]
        for prefix in ("tcn_r", "tcn_i"):
            for i, g in enumerate(_stack(cfg)):
                self.add_module(f"{prefix}_{i}", g)
        self.head_r = Dense(cfg["d_feat"], bins)
        self.head_i = Dense(cfg["d_feat"], bins)

    def forward(self, feat, pre_flat):
        x = self.gated_input(feat, pre_flat)
        xr, xi = x, x
        for i in range(self.p):
            xr = getattr(self, f"tcn_r_{i}")(xr)
            xi = getattr(self, f"tcn_i_{i}")(xi)
        return torch.stack([self.head_r(xr), self.head_i(xi)], dim=-1)


class GlanceGazeModule(nn.Module):
    def __init__(self, cfg, bins):
        super().__init__()
        self.glance = GlanceBlock(cfg, bins)
        self.gaze = GazeBlock(cfg, bins)

    def forward(self, feat, pre_x):
        pre_flat = torch.cat([pre_x[..., 0], pre_x[..., 1]], dim=-1)
        gain = self.glance(feat, pre_flat)
        resi = self.gaze(feat, pre_flat)
        sq = torch.sum(torch.square(pre_x), dim=-1)
        nz = sq > 0
        mag = torch.where(nz, torch.sqrt(torch.where(nz, sq, 1.0)), 0.0)
        phase = torch.atan2(pre_x[..., 1], torch.where(nz, pre_x[..., 0],
                                                       1.0))
        filt = mag * gain
        return torch.stack([filt * torch.cos(phase),
                            filt * torch.sin(phase)], dim=-1) + resi


class GaGNet(nn.Module):
    def __init__(self, cfg: Dict):
        super().__init__()
        _check(cfg, "GaGNet")
        self.q = cfg["q"]
        bins = cfg["fft_num"] // 2 + 1
        self.en = U2NetEncoder(2 * cfg["cin"], cfg["c"], cfg["k1"],
                               cfg["k2"], cfg["norm_type"])
        for i in range(self.q):
            self.add_module(f"gag_{i}", GlanceGazeModule(cfg, bins))

    def forward(self, inpt, pre_x) -> List[torch.Tensor]:
        x = torch.cat([inpt, pre_x], dim=-1).permute(0, 3, 1, 2)
        feat, _ = self.en(x)
        b, t = feat.shape[0], feat.shape[2]
        feat = feat.permute(0, 2, 3, 1).reshape(b, t, -1)
        outs = []
        for i in range(self.q):
            pre_x = getattr(self, f"gag_{i}")(feat, pre_x)
            outs.append(pre_x)
        return outs


class Composed(nn.Module):
    """EaBNet, then GaGNet on (reference mic, EaBNet's estimate held
    constant): {"esti0", "esti1" (the stages), "esti" (the last)}."""

    def __init__(self, model_cfg: Dict):
        super().__init__()
        self.ref_mic = model_cfg.get("ref_mic", 0)
        self.eabnet = EaBNet(model_cfg["eabnet"])
        self.postnet = GaGNet(model_cfg["gagnet"])

    def forward(self, noisy_stft):
        esti0 = self.eabnet(noisy_stft)
        esti1 = self.postnet(noisy_stft[..., self.ref_mic, :],
                             esti0.detach())
        return {"esti0": esti0, "esti1": esti1, "esti": esti1[-1]}
