"""EaBNet, the all-neural causal beamformer, in PyTorch.

U²Net encoder over (time, freq) -> q accumulated squeezed-TCN groups on the
(T, 256) bottleneck -> mirrored decoder -> beamforming head. The head is
one of the JAX package's three (``eabnet_tpu/models/eabnet.py``):

- mimo with ``bf_type="lstm"``: the LSTM head, then a complex
  filter-and-sum over the microphones;
- mimo with ``bf_type="cnn"``: a pointwise Dense ``bf_map`` to 2M
  channels, the same filter-and-sum;
- ``topo_type="miso"``: a Dense ``bf_map`` to 2 channels, a per-TF complex
  product with mic 0 (the JAX package's form, not the reference's sum over
  frequency; ARCHITECTURE.md).

The model's boundary keeps the JAX package's layout: input (B, T, F, M, 2)
-> estimate (B, T, F, 2). Frequency-sharded (``parallel/freq.py``), F is
the rank's bins: the U-Nets exchange halos, the bottleneck runs whole on
every rank (the TCM-chain kernel included), and every head runs on the
rank's own lanes, B·F_r of them for the LSTM-BF kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from eabnet_tpu_torch.config import EaBNetConfig
from eabnet_tpu_torch.kernels.lstm_bf import double_lstm
from eabnet_tpu_torch.nn.blocks import (Dense, SqueezedTCNGroup,
                                        U2NetDecoder, U2NetEncoder,
                                        UNetDecoder, UNetEncoder)
from eabnet_tpu_torch.nn.lstm import step_carried
from eabnet_tpu_torch.nn.stepping import current
from eabnet_tpu_torch.parallel import freq


def to_reference_layout(esti: torch.Tensor) -> torch.Tensor:
    """(B, T, F, 2) -> (B, 2, T, F)."""
    return esti.permute(0, 3, 1, 2)


def from_reference_layout(spec: torch.Tensor) -> torch.Tensor:
    """(B, 2, T, F) -> (B, T, F, 2)."""
    return spec.permute(0, 2, 3, 1)


class _LSTMParams(nn.Module):
    """One LSTM layer's weights in the JAX package's layout: w_ih (in, 4H),
    w_hh (H, 4H), biases (4H,); gate order i, f, g, o."""

    def __init__(self, in_dim: int, hidden: int):
        super().__init__()
        k = 1.0 / hidden ** 0.5
        self.w_ih = nn.Parameter(torch.empty(in_dim, 4 * hidden).uniform_(-k, k))
        self.w_hh = nn.Parameter(torch.empty(hidden, 4 * hidden).uniform_(-k, k))
        self.b_ih = nn.Parameter(torch.empty(4 * hidden).uniform_(-k, k))
        self.b_hh = nn.Parameter(torch.empty(4 * hidden).uniform_(-k, k))


class _ScaleBias(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))


class LSTMBeamformer(nn.Module):
    """LSTM beamforming-weight head: LayerNorm over the embedding, every
    (item, frequency) pair an independent lane, two stacked LSTMs over
    time (the LSTM-BF kernel; inside ``stepping.stepping`` one frame of
    each layer from its carried state), then fc1 / ReLU / fc2 -> (B, T,
    F, M, 2)."""

    def __init__(self, embed_dim: int, M: int, hid_node: int = 64):
        super().__init__()
        self.M = M
        self.norm = _ScaleBias(embed_dim)
        self.rnn1 = _LSTMParams(embed_dim, hid_node)
        self.rnn2 = _LSTMParams(hid_node, hid_node)
        self.fc1 = Dense(hid_node, hid_node)
        self.fc2 = Dense(hid_node, 2 * M)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, C, T, F) decoder embedding -> (B, T, F, M, 2)."""
        b, c, t, f = x.shape
        # (B, C, T, F) -> (B, F, T, C) -> lanes (B*F, T, C)
        x = x.permute(0, 3, 2, 1).reshape(b * f, t, c)
        if x.dtype == torch.float32:
            x = F.layer_norm(x, (c,), self.norm.scale, self.norm.bias,
                             eps=1e-5)
        else:  # each op in x's dtype, as the JAX head computes it in bf16
            mean = x.mean(dim=-1, keepdim=True)
            var = torch.square(x - mean).mean(dim=-1, keepdim=True)
            x = (x - mean) / torch.sqrt(var + 1e-5) * self.norm.scale + \
                self.norm.bias
        r1, r2 = self.rnn1, self.rnn2
        fr = current()
        if fr is not None:  # one frame: (1, L, H)
            h2 = step_carried(fr, r2, step_carried(fr, r1, x[:, 0]))[None]
        else:
            # hoisted layer-1 input projection, time-major for the kernel
            xw1 = (x @ r1.w_ih + (r1.b_ih + r1.b_hh)).transpose(
                0, 1).contiguous()
            h2 = double_lstm(xw1, r1.w_hh, r2.w_ih, r2.w_hh,
                             r2.b_ih + r2.b_hh)
        y = self.fc2(torch.relu(self.fc1(h2.transpose(0, 1))))  # (L, T, 2M)
        return y.reshape(b, f, t, self.M, 2).permute(0, 2, 1, 3, 4)


def beamform_sum(bf_w: torch.Tensor, inpt: torch.Tensor) -> torch.Tensor:
    """Complex filter-and-sum over mics: (B, T, F, M, 2) x2 -> (B, T, F, 2)."""
    wr, wi = bf_w[..., 0], bf_w[..., 1]
    xr, xi = inpt[..., 0], inpt[..., 1]
    return torch.stack([(wr * xr - wi * xi).sum(-1),
                        (wr * xi + wi * xr).sum(-1)], dim=-1)


class EaBNet(nn.Module):
    """Embedding-and-beamforming network. Its norms take batch statistics
    only in training mode (``module.train()``), as the JAX package's do
    under ``train=True``."""

    def __init__(self, cfg: EaBNetConfig):
        super().__init__()
        self.cfg = cfg
        if cfg.is_u2:
            self.en = U2NetEncoder(2 * cfg.M, cfg.c, cfg.k1, cfg.k2,
                                   cfg.intra_connect, cfg.norm_type)
        else:
            self.en = UNetEncoder(2 * cfg.M, cfg.c, cfg.k1, cfg.norm_type)
        for i in range(cfg.q):
            self.add_module(f"stcn_{i}", SqueezedTCNGroup(
                cfg.kd1, cfg.cd1, cfg.d_feat,
                tuple(2 ** j for j in range(cfg.p)), cfg.is_causal,
                cfg.norm_type, twin_gate=True))
        if cfg.is_u2:
            self.de = U2NetDecoder(cfg.embed_dim, cfg.c, cfg.k1, cfg.k2,
                                   cfg.intra_connect, cfg.norm_type)
        else:
            self.de = UNetDecoder(cfg.embed_dim, cfg.c, cfg.k1, cfg.norm_type)
        if cfg.topo_type == "miso":
            self.bf_map = Dense(cfg.embed_dim, 2)
        elif cfg.bf_type == "cnn":
            self.bf_map = Dense(cfg.embed_dim, 2 * cfg.M)
        else:
            self.bf_map = LSTMBeamformer(cfg.embed_dim, cfg.M, cfg.hid_node)

    def forward(self, inpt: torch.Tensor) -> torch.Tensor:
        """inpt (B, T, F, M, 2), or (B, T, F, 2) for one mic -> esti
        (B, T, F, 2)."""
        if inpt.dim() == 4:  # single-mic input
            inpt = inpt.unsqueeze(-2)
        b, t, f, m, _ = inpt.shape
        # fold (mic, ri) into channels mic-major (channel = 2 m + ri), as
        # the JAX package does; then channel-first
        x = inpt.reshape(b, t, f, 2 * m).permute(0, 3, 1, 2)
        sh = freq.current()
        if sh is not None:
            sh.width = sh.bins
        x, skips = self.en(x)  # (B, C', T, F')
        if sh is not None:
            x = sh.whole(x)
        c_b, f_b = x.shape[1], x.shape[3]
        # bottleneck (B, T, F' * C') in the JAX package's (freq, chan) order
        x = x.permute(0, 2, 3, 1).reshape(b, t, f_b * c_b)
        acc = torch.zeros_like(x)
        for i in range(self.cfg.q):
            x = getattr(self, f"stcn_{i}")(x)
            acc = acc + x
        x = acc.reshape(b, t, f_b, c_b).permute(0, 3, 1, 2)
        if sh is not None:
            x = sh.own(x)
        x = self.de(x, skips)  # (B, embed_dim, T, F)
        if isinstance(self.bf_map, LSTMBeamformer):
            return beamform_sum(self.bf_map(x), inpt)
        w = self.bf_map(x.permute(0, 2, 3, 1))  # (B, T, F, 2M or 2)
        if self.cfg.topo_type == "miso":
            # per-TF weights on the reference mic 0: a sum over one mic
            return beamform_sum(w[..., None, :], inpt[..., :1, :])
        return beamform_sum(w.reshape(b, t, f, m, 2), inpt)
