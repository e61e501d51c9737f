"""GaGNet, the glance-and-gaze post-filter, in PyTorch.

A U²Net encoder embeds the (noisy reference, previous estimate) spectra;
q glance/gaze stages refine the estimate as ``mag * gain * e^{j phase} +
residual``. Spectra keep the JAX package's layout (B, T, F, 2).
"""

from __future__ import annotations

from typing import List

import torch
from torch import nn

from eabnet_tpu_torch.config import GaGNetConfig
from eabnet_tpu_torch.nn.blocks import (Dense, SqueezedTCNGroup,
                                        U2NetEncoder, UNetEncoder)


def _flatten_spec(x: torch.Tensor) -> torch.Tensor:
    """(B, T, F, 2) -> (B, T, 2F): real bins first, then imaginary."""
    return torch.cat([x[..., 0], x[..., 1]], dim=-1)


def _tcn_stack(cfg: GaGNetConfig) -> List[SqueezedTCNGroup]:
    return [SqueezedTCNGroup(cfg.kd1, cfg.cd1, cfg.d_feat, cfg.dilas,
                             cfg.is_causal, cfg.norm_type, twin_gate=False)
            for _ in range(cfg.p)]


class _GatedIn(nn.Module):
    """``in_main(x) * sigmoid(in_gate(x))`` on [features, previous]."""

    def __init__(self, cfg: GaGNetConfig):
        super().__init__()
        in_dim = cfg.d_feat + 2 * cfg.freq_bins
        self.in_main = Dense(in_dim, cfg.d_feat)
        self.in_gate = Dense(in_dim, cfg.d_feat)

    def gated_input(self, feat_x, pre_flat):
        x = torch.cat([feat_x, pre_flat], dim=-1)
        return self.in_main(x) * torch.sigmoid(self.in_gate(x))


class GlanceBlock(_GatedIn):
    """Real-valued magnitude-gain branch."""

    def __init__(self, cfg: GaGNetConfig):
        super().__init__(cfg)
        self.acti = {"sigmoid": torch.sigmoid, "tanh": torch.tanh,
                     "relu": torch.relu}[cfg.acti_type]
        for i, group in enumerate(_tcn_stack(cfg)):
            self.add_module(f"tcn_{i}", group)
        self.p = cfg.p
        self.head = Dense(cfg.d_feat, cfg.freq_bins)

    def forward(self, feat_x, pre_flat):
        x = self.gated_input(feat_x, pre_flat)
        for i in range(self.p):
            x = getattr(self, f"tcn_{i}")(x)
        return self.acti(self.head(x))  # (B, T, F)


class GazeBlock(_GatedIn):
    """Complex-residual branch: separate real/imaginary TCN stacks, or one
    shared stack when ``is_squeezed``."""

    def __init__(self, cfg: GaGNetConfig):
        super().__init__(cfg)
        self.p = cfg.p
        self.prefixes = ("tcn_ri",) if cfg.is_squeezed else ("tcn_r", "tcn_i")
        for prefix in self.prefixes:
            for i, group in enumerate(_tcn_stack(cfg)):
                self.add_module(f"{prefix}_{i}", group)
        self.head_r = Dense(cfg.d_feat, cfg.freq_bins)
        self.head_i = Dense(cfg.d_feat, cfg.freq_bins)

    def _stack(self, h, prefix):
        for i in range(self.p):
            h = getattr(self, f"{prefix}_{i}")(h)
        return h

    def forward(self, feat_x, pre_flat):
        x = self.gated_input(feat_x, pre_flat)
        outs = [self._stack(x, prefix) for prefix in self.prefixes]
        x_r, x_i = outs if len(outs) == 2 else outs * 2
        return torch.stack([self.head_r(x_r), self.head_i(x_i)], dim=-1)


class GlanceGazeModule(nn.Module):
    """One refinement stage."""

    def __init__(self, cfg: GaGNetConfig):
        super().__init__()
        self.glance = GlanceBlock(cfg)
        self.gaze = GazeBlock(cfg)

    def forward(self, feat_x, pre_x):
        pre_flat = _flatten_spec(pre_x)
        gain = self.glance(feat_x, pre_flat)
        resi = self.gaze(feat_x, pre_flat)
        # guarded magnitude/phase: zero spectra (padding) stay finite
        sq = torch.sum(torch.square(pre_x), dim=-1)
        nz = sq > 0
        pre_mag = torch.where(nz, torch.sqrt(torch.where(nz, sq, 1.0)), 0.0)
        pre_phase = torch.atan2(pre_x[..., 1],
                                torch.where(nz, pre_x[..., 0], 1.0))
        filt = pre_mag * gain
        coarse = torch.stack([filt * torch.cos(pre_phase),
                              filt * torch.sin(pre_phase)], dim=-1)
        return coarse + resi


class GaGNet(nn.Module):
    """Glance-and-gaze post-filter: inpt, pre_x (B, T, F, 2) -> the q
    stage outputs (B, T, F, 2), the last being the final estimate."""

    def __init__(self, cfg: GaGNetConfig):
        super().__init__()
        self.cfg = cfg
        if cfg.is_u2:
            self.en = U2NetEncoder(2 * cfg.cin, cfg.c, cfg.k1, cfg.k2,
                                   cfg.intra_connect, cfg.norm_type)
        else:  # GaGNet's plain encoder norms all five stages
            self.en = UNetEncoder(2 * cfg.cin, cfg.c, cfg.k1, cfg.norm_type,
                                  norm_stages=(True,) * 5)
        for i in range(cfg.q):
            self.add_module(f"gag_{i}", GlanceGazeModule(cfg))

    def forward(self, inpt: torch.Tensor, pre_x: torch.Tensor
                ) -> List[torch.Tensor]:
        x = torch.cat([inpt, pre_x], dim=-1).permute(0, 3, 1, 2)
        feat, _ = self.en(x)  # (B, C', T, F')
        b, t = feat.shape[0], feat.shape[2]
        feat = feat.permute(0, 2, 3, 1).reshape(b, t, -1)  # (B, T, F' * C')
        outs = []
        for i in range(self.cfg.q):
            pre_x = getattr(self, f"gag_{i}")(feat, pre_x)
            outs.append(pre_x)
        return outs
