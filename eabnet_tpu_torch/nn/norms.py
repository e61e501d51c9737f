"""PReLU and the four norms of the block library on channel-first maps
(B, C, T, *rest): time is dim 2, channels dim 1. Frequency-sharded
(``parallel/freq.py``), IN and cLN take their statistics over every
rank's bins: the sums are all-reduced over the ``freq`` group and the
counts use the global width."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from eabnet_tpu_torch.nn.stepping import Frame, current
from eabnet_tpu_torch.parallel import freq
from eabnet_tpu_torch.parallel.mesh import all_reduce_sum, process_count


def _bcast(v: torch.Tensor, ndim: int) -> torch.Tensor:
    """(C,) -> (1, C, 1, ...) for a channel-first tensor of rank ndim."""
    return v.view(1, -1, *([1] * (ndim - 2)))


class PReLU(nn.Module):
    """Per-channel parametric ReLU, ``max(x, 0) + alpha * min(x, 0)``."""

    def __init__(self, features: int, init_slope: float = 0.25):
        super().__init__()
        self.alpha = nn.Parameter(torch.full((features,), init_slope))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not torch.is_grad_enabled():  # the same values in one launch
            return F.prelu(x, self.alpha)
        return torch.clamp(x, min=0) + _bcast(self.alpha, x.dim()) * \
            torch.clamp(x, max=0)


class _Affine(nn.Module):
    """The per-channel ``scale`` and ``bias`` every norm ends with."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def affine(self, y: torch.Tensor) -> torch.Tensor:
        return y * _bcast(self.scale, y.dim()) + _bcast(self.bias, y.dim())


class InstanceNorm(_Affine):
    """Affine instance norm over all axes but (B, C): per-sample,
    per-channel statistics, biased variance, eps inside the sqrt."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        axes = tuple(range(2, x.dim()))
        sh = freq.current()
        if sh is None or not sh.split_map(x):
            mean = x.mean(dim=axes, keepdim=True)
            var = torch.square(x - mean).mean(dim=axes, keepdim=True)
        else:  # the same two passes over every rank's bins
            n = x.shape[2] * sh.width

            def mean_of(v):
                s = sh.sum_over_freq(v.float().sum(dim=axes, keepdim=True),
                                     "norm")
                return (s / n).to(x.dtype)
            mean = mean_of(x)
            var = mean_of(torch.square(x - mean))
        return self.affine((x - mean) / torch.sqrt(var + self.eps))


class CumulativeLayerNorm(_Affine):
    """Strictly causal cumulative layer norm: frame t is normalised with
    the statistics of channels (and every dim after time) over frames
    0..t, kept as float32 cumulative sums; the variance is clamped at 0.
    With ``prior`` one virtual zero-mean, unit-variance frame (as many
    pseudo elements as a frame has) joins the statistics (the JAX
    package's "cLN", which bounds 1/sigma at the first frames); without
    it, the reference's cumulative norm ("cLN-ref"). A stream's step
    (``stepping.py``) carries (count, sum, sum of squares) per item."""

    def __init__(self, features: int, eps: float = 1e-5, prior: bool = True):
        super().__init__(features, eps)
        self.prior = prior

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        fr = current()
        if fr is not None:
            return self._step(fr, x)
        red = (1,) + tuple(range(3, x.dim()))
        n_per_step = x.numel() // (x.shape[0] * x.shape[2])
        xf = x.float()
        total, sq = xf.sum(dim=red), torch.square(xf).sum(dim=red)
        sh = freq.current()
        if sh is not None and sh.split_map(x):
            # per-frame sums over every rank's bins, before the cumsum
            total, sq = sh.sum_over_freq(torch.stack([total, sq]), "norm")
            n_per_step = n_per_step // x.shape[-1] * sh.width
        pr = float(n_per_step) if self.prior else 0.0
        shape = (x.shape[0], 1, x.shape[2]) + (1,) * (x.dim() - 3)
        total = torch.cumsum(total, dim=1).view(shape)
        sq = (torch.cumsum(sq, dim=1) + pr).view(shape)
        count = (torch.arange(1, x.shape[2] + 1, dtype=torch.float32,
                              device=x.device) * n_per_step + pr
                 ).view((1, 1, -1) + (1,) * (x.dim() - 3))
        mean = total / count
        var = torch.clamp(sq / count - torch.square(mean), min=0.0)
        y = ((xf - mean) / torch.sqrt(var + self.eps)).to(x.dtype)
        return self.affine(y)

    def _step(self, fr: Frame, x: torch.Tensor) -> torch.Tensor:
        """One frame (B, C, 1, ...): the carried (count, sum, sum of
        squares) per item, (B, 3), start from the prior's pseudo elements.
        A stream's step is host-bound (hundreds of norms a frame), so this
        takes few ops: both sums in one reduction, the normalisation as
        one inference-mode batch norm whose channels are the items."""
        b = x.shape[0]
        xf = x.reshape(b, -1)
        n_new = xf.shape[1]  # F * C of a 2-D frame
        pr = float(n_new) if self.prior else 0.0
        stats = fr.carried(self, "stats", lambda: x.new_tensor(
            [pr, 0.0, pr]).repeat(b, 1)) + F.pad(
            torch.stack([xf, xf * xf], dim=1).sum(dim=2), (1, 0),
            value=float(n_new))
        fr.keep(self, "stats", stats)
        count, total, sq = stats.unbind(1)
        mean = total / count
        var = torch.addcmul(sq / count, mean, mean,
                            value=-1.0).clamp_(min=0.0)
        y = F.batch_norm(xf.unsqueeze(0), mean, var, eps=self.eps).view_as(x)
        return torch.addcmul(_bcast(self.bias, x.dim()), y,
                             _bcast(self.scale, x.dim()))


class BatchNorm(_Affine):
    """flax's ``BatchNorm(momentum=0.9, epsilon=1e-5)``: statistics over
    every dim but the channels. In training (``module.train()``) it
    normalises with the batch's mean and biased variance (E[x^2] - E[x]^2,
    clamped at 0, in float32) and moves the running statistics by
    ``ra = 0.9 ra + 0.1 batch``; in evaluation it reads them. They are the
    buffers ``mean`` and ``var``, flax's ``batch_stats`` collection.
    (``torch.nn.BatchNorm`` updates with the unbiased variance, and its
    momentum is the other share.) Inside a process group of more than one
    rank the batch is the global one, as under the JAX package's mesh: the
    ranks' sums of x and x^2 and their counts are all-reduced
    (differentiably), so every rank normalises with the same statistics
    and moves the same running ones."""

    momentum = 0.9

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__(features, eps)
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            axes = (0,) + tuple(range(2, x.dim()))
            xf = x.float()
            if process_count() > 1:
                mean, var = _global_moments(xf, axes)
            else:
                mean = xf.mean(dim=axes)
                var = torch.clamp(torch.square(xf).mean(dim=axes)
                                  - torch.square(mean), min=0.0)
            with torch.no_grad():
                self.mean.mul_(self.momentum).add_(
                    (1 - self.momentum) * mean.detach())
                self.var.mul_(self.momentum).add_(
                    (1 - self.momentum) * var.detach())
        else:
            mean, var = self.mean, self.var
        return self.frozen(x, mean, var)

    def frozen(self, x: torch.Tensor, mean: torch.Tensor,
               var: torch.Tensor) -> torch.Tensor:
        """Normalise with the given statistics: flax's ``(x - mean) *
        (rsqrt(var + eps) * scale) + bias``, computed in the statistics'
        float32 and returned in x's dtype (flax's under bf16 compute)."""
        mul = torch.rsqrt(var + self.eps) * self.scale
        return ((x - _bcast(mean, x.dim())) * _bcast(mul, x.dim()) +
                _bcast(self.bias, x.dim())).to(x.dtype)


def _global_moments(xf: torch.Tensor, axes):
    """The mean and biased variance (E[x^2] - E[x]^2, clamped at 0) per
    channel over the batch of every rank."""
    c = xf.shape[1]
    sums = all_reduce_sum(torch.cat([
        xf.sum(dim=axes), torch.square(xf).sum(dim=axes),
        xf.new_full((1,), float(xf.numel() // c))]))
    count = sums[2 * c].detach()
    mean = sums[:c] / count
    return mean, torch.clamp(sums[c:2 * c] / count - torch.square(mean),
                             min=0.0)


NORMS = {
    "IN": InstanceNorm,
    "cLN": CumulativeLayerNorm,
    "cLN-ref": lambda c: CumulativeLayerNorm(c, prior=False),
    "BN": BatchNorm,
}


class NormSwitch(nn.Module):
    """The norm selector of the block library: "IN", "cLN" (with the
    virtual-frame prior), "cLN-ref" (without) or "BN". The norm sits one
    level down under the name ``norm``, as in the JAX package's trees."""

    def __init__(self, norm_type: str, features: int):
        super().__init__()
        if norm_type not in NORMS:
            raise ValueError(f"unknown norm_type {norm_type!r}")
        self.norm = NORMS[norm_type](features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(x)
