"""EaBNet + GaGNet composed model."""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from eabnet_tpu_torch.config import ComposedConfig
from eabnet_tpu_torch.models.eabnet import EaBNet
from eabnet_tpu_torch.models.gagnet import GaGNet


class EaBNetWithPostNet(nn.Module):
    """Causal beamformer followed by glance-gaze refinement."""

    def __init__(self, cfg: ComposedConfig):
        super().__init__()
        self.cfg = cfg
        self.eabnet = EaBNet(cfg.eabnet)
        self.postnet = GaGNet(cfg.gagnet)

    def forward(self, noisy_stft: torch.Tensor) -> Dict[str, torch.Tensor]:
        """noisy_stft (B, T, F, M, 2) -> {"esti0": beamformer estimate,
        "esti1": the post-filter's stage outputs, "esti": the last one},
        each (B, T, F, 2)."""
        esti0 = self.eabnet(noisy_stft)
        ref = noisy_stft[..., self.cfg.ref_mic, :]
        esti1 = self.postnet(ref, esti0.detach())
        return {"esti0": esti0, "esti1": esti1, "esti": esti1[-1]}


def build_model(cfg: ComposedConfig) -> EaBNetWithPostNet:
    return EaBNetWithPostNet(cfg)
