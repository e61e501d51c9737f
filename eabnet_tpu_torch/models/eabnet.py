"""EaBNet, the all-neural causal beamformer, in PyTorch.

U²Net encoder over (time, freq) -> q accumulated squeezed-TCN groups on the
(T, 256) bottleneck -> mirrored decoder -> LSTM beamforming head -> complex
filter-and-sum over the microphones. The model's boundary keeps the JAX
package's layout: input (B, T, F, M, 2) -> estimate (B, T, F, 2).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from eabnet_tpu_torch.config import EaBNetConfig, require_slice
from eabnet_tpu_torch.kernels.lstm_bf import double_lstm
from eabnet_tpu_torch.nn.blocks import (Dense, SqueezedTCNGroup,
                                        U2NetDecoder, U2NetEncoder)


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
    time (the LSTM-BF kernel), then fc1 / ReLU / fc2 -> (B, T, F, M, 2)."""

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
        x = F.layer_norm(x, (c,), self.norm.scale, self.norm.bias, eps=1e-5)
        r1, r2 = self.rnn1, self.rnn2
        # hoisted layer-1 input projection, time-major for the kernel
        xw1 = (x @ r1.w_ih + (r1.b_ih + r1.b_hh)).transpose(0, 1).contiguous()
        h2 = double_lstm(xw1, r1.w_hh, r2.w_ih, r2.w_hh, r2.b_ih + r2.b_hh)
        y = self.fc2(torch.relu(self.fc1(h2.transpose(0, 1))))  # (L, T, 2M)
        return y.reshape(b, f, t, self.M, 2).permute(0, 2, 1, 3, 4)


def beamform_sum(bf_w: torch.Tensor, inpt: torch.Tensor) -> torch.Tensor:
    """Complex filter-and-sum over mics: (B, T, F, M, 2) x2 -> (B, T, F, 2)."""
    wr, wi = bf_w[..., 0], bf_w[..., 1]
    xr, xi = inpt[..., 0], inpt[..., 1]
    return torch.stack([(wr * xr - wi * xi).sum(-1),
                        (wr * xi + wi * xr).sum(-1)], dim=-1)


class EaBNet(nn.Module):
    """Embedding-and-beamforming network."""

    def __init__(self, cfg: EaBNetConfig):
        super().__init__()
        require_slice(cfg)
        self.cfg = cfg
        self.en = U2NetEncoder(2 * cfg.M, cfg.c, cfg.k1, cfg.k2,
                               cfg.intra_connect, cfg.norm_type)
        for i in range(cfg.q):
            self.add_module(f"stcn_{i}", SqueezedTCNGroup(
                cfg.kd1, cfg.cd1, cfg.d_feat,
                tuple(2 ** j for j in range(cfg.p)), cfg.is_causal,
                cfg.norm_type, twin_gate=True))
        self.de = U2NetDecoder(cfg.embed_dim, cfg.c, cfg.k1, cfg.k2,
                               cfg.intra_connect, cfg.norm_type)
        self.bf_map = LSTMBeamformer(cfg.embed_dim, cfg.M, cfg.hid_node)

    def forward(self, inpt: torch.Tensor) -> torch.Tensor:
        """inpt (B, T, F, M, 2) -> esti (B, T, F, 2)."""
        b, t, f, m, _ = inpt.shape
        # fold (mic, ri) into channels mic-major (channel = 2 m + ri), as
        # the JAX package does; then channel-first
        x = inpt.reshape(b, t, f, 2 * m).permute(0, 3, 1, 2)
        x, skips = self.en(x)  # (B, C', T, F')
        c_b, f_b = x.shape[1], x.shape[3]
        # bottleneck (B, T, F' * C') in the JAX package's (freq, chan) order
        x = x.permute(0, 2, 3, 1).reshape(b, t, f_b * c_b)
        acc = torch.zeros_like(x)
        for i in range(self.cfg.q):
            x = getattr(self, f"stcn_{i}")(x)
            acc = acc + x
        x = acc.reshape(b, t, f_b, c_b).permute(0, 3, 1, 2)
        x = self.de(x, skips)  # (B, embed_dim, T, F)
        return beamform_sum(self.bf_map(x), inpt)
