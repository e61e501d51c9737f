"""PReLU and instance norm on channel-first maps (B, C, *spatial)."""

from __future__ import annotations

import torch
from torch import nn


def _bcast(v: torch.Tensor, ndim: int) -> torch.Tensor:
    """(C,) -> (1, C, 1, ...) for a channel-first tensor of rank ndim."""
    return v.view(1, -1, *([1] * (ndim - 2)))


class PReLU(nn.Module):
    """Per-channel parametric ReLU, ``max(x, 0) + alpha * min(x, 0)``."""

    def __init__(self, features: int, init_slope: float = 0.25):
        super().__init__()
        self.alpha = nn.Parameter(torch.full((features,), init_slope))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.clamp(x, min=0) + _bcast(self.alpha, x.dim()) * \
            torch.clamp(x, max=0)


class InstanceNorm(nn.Module):
    """Affine instance norm over all axes but (B, C): per-sample,
    per-channel statistics, biased variance, eps inside the sqrt."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        axes = tuple(range(2, x.dim()))
        mean = x.mean(dim=axes, keepdim=True)
        var = torch.square(x - mean).mean(dim=axes, keepdim=True)
        y = (x - mean) / torch.sqrt(var + self.eps)
        return y * _bcast(self.scale, x.dim()) + _bcast(self.bias, x.dim())


class NormSwitch(nn.Module):
    """The norm selector of the block library. This slice runs IN only;
    the norm sits one level down under the name ``norm``, as in the JAX
    package's parameter tree."""

    def __init__(self, norm_type: str, features: int):
        super().__init__()
        if norm_type != "IN":
            raise NotImplementedError(
                f"norm_type={norm_type!r}: the port runs 'IN' only; cLN "
                "and BN are later slices of the port")
        self.norm = InstanceNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(x)
