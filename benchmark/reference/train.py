"""The reference's training step: the composite loss of the composed
model, its gradient, clipping by global norm and Adam, in plain PyTorch.

The loss is the released recipe's: on EaBNet's estimate 0.5 (magnitude
MSE + real/imaginary MSE), on the post-filter's stages the same with
weight 0.1 on every stage but the last; every sum is divided by the
batch's frames times the bins (the real/imaginary one by twice that).
The batch's rows are independent (no norm mixes items), so a step may run
in blocks of rows: each block's loss is divided by the whole batch's
frames and the gradients of the blocks add up to the batch's. Clipping
is optax's (scale by max_norm / norm when the global norm reaches it),
Adam optax's (b1 0.9, b2 0.999, eps 1e-8 outside the square root).
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Sequence

import torch

from benchmark.reference import dsp

B1, B2, EPS = 0.9, 0.999, 1e-8


def _mag(x: torch.Tensor) -> torch.Tensor:
    sq = torch.sum(torch.square(x), dim=-1)
    nz = sq > 0
    return torch.where(nz, torch.sqrt(torch.where(nz, sq, 1.0)), 0.0)


def _com_mag(esti, label, denom):
    mag = torch.sum(torch.square(_mag(esti) - _mag(label))) / denom
    ri = torch.sum(torch.square(esti - label)) / (2.0 * denom)
    return mag, ri


def losses(out: Dict, label: torch.Tensor, frames: float
           ) -> Dict[str, torch.Tensor]:
    """{eabnet, postnet, final} of a block of rows whose whole batch has
    ``frames`` frames (every frame valid)."""
    denom = frames * label.shape[2]
    mag, ri = _com_mag(out["esti0"], label, denom)
    loss0 = 0.5 * (mag + ri)
    stages = out["esti1"]
    loss1 = 0.0
    for i, esti in enumerate(stages):
        alpha = 1.0 if i == len(stages) - 1 else 0.1
        mag, ri = _com_mag(esti, label, denom)
        loss1 = loss1 + alpha * 0.5 * (mag + ri)
    return {"eabnet": loss0, "postnet": loss1, "final": loss0 + loss1}


def gradient(model, stft_cfg: dict, noisy: torch.Tensor,
             clean: torch.Tensor, block: int, rows: Sequence[int] = None):
    """-> ({name: gradient}, {loss name: float}, [{name: gradient} of
    each block]) of the batch's loss, computed ``block`` rows at a time;
    the batch's gradient is the sum of the blocks'. ``rows`` picks the
    rows that the loss takes (all by default); the frames it divides by
    are theirs."""
    rows = list(range(noisy.shape[0])) if rows is None else list(rows)
    params = dict(model.named_parameters())
    total = {"eabnet": 0.0, "postnet": 0.0, "final": 0.0}
    t = 1 + noisy.shape[-1] // int(stft_cfg["win_shift"] * stft_cfg["sr"])
    frames = float(len(rows) * t)
    blocks = []
    for lo in range(0, len(rows), block):
        idx = torch.as_tensor(rows[lo:lo + block], device=noisy.device)
        with torch.enable_grad():
            out = model(dsp.features(noisy[idx], stft_cfg))
            ls = losses(out, dsp.target(clean[idx], stft_cfg), frames)
            g = torch.autograd.grad(ls["final"], list(params.values()),
                                    allow_unused=True)
        blocks.append({n: torch.zeros_like(p) if gi is None else gi
                       for (n, p), gi in zip(params.items(), g)})
        for k in total:
            total[k] += float(ls[k].detach())
        del out, ls, g
    grads = {n: sum(b[n] for b in blocks) for n in params}
    return grads, total, blocks


def clip(grads: Dict[str, torch.Tensor], max_norm: float):
    norm = torch.sqrt(sum(torch.sum(g.double() * g.double())
                          for g in grads.values())).float()
    if norm < max_norm:
        return grads
    return {n: g / norm * max_norm for n, g in grads.items()}


class Adam:
    """optax's adam over a dict of float32 parameters."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float):
        self.lr = lr
        self.count = 0
        self.mu = {n: torch.zeros_like(p) for n, p in params.items()}
        self.nu = {n: torch.zeros_like(p) for n, p in params.items()}

    def step(self, params: Dict[str, torch.Tensor],
             grads: Dict[str, torch.Tensor]) -> None:
        self.count += 1
        bc1 = 1 - B1 ** self.count
        bc2 = 1 - B2 ** self.count
        with torch.no_grad():
            for n, p in params.items():
                g = grads[n]
                self.mu[n] = B1 * self.mu[n] + (1 - B1) * g
                self.nu[n] = B2 * self.nu[n] + (1 - B2) * g * g
                p -= self.lr * (self.mu[n] / bc1) / (
                    torch.sqrt(self.nu[n] / bc2) + EPS)


def run_steps(model, stft_cfg: dict, batches: List, lr: float,
              grad_clip: float, block: int, rows: Sequence[int] = None,
              within=contextlib.nullcontext):
    """The first ``len(batches)`` steps from the model's weights ->
    (losses per step, the first step's clipped gradient by leaf, the
    first step's gradient of each block of rows by leaf, unclipped, each
    leaf's change after the last step, what ``within()`` yielded).
    ``batches``: (noisy (B, M, N), clean (B, N)) pairs; ``within()``
    holds each gradient's computation (a control's or a witness's
    precision), the clip and Adam outside it."""
    params = dict(model.named_parameters())
    start = {n: p.detach().clone() for n, p in params.items()}
    opt = Adam(params, lr)
    step_losses, first, first_blocks, seen = [], None, None, None
    for noisy, clean in batches:
        with within() as seen:
            grads, ls, blocks = gradient(model, stft_cfg, noisy, clean,
                                         block, rows)
        grads = clip(grads, grad_clip)
        if first is None:
            first = {n: g.clone() for n, g in grads.items()}
            first_blocks = blocks
        opt.step(params, grads)
        step_losses.append(ls)
        del grads, blocks
    change = {n: (p.detach() - start[n]) for n, p in params.items()}
    return step_losses, first, first_blocks, change, seen
