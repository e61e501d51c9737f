"""Training losses, in PyTorch.

The JAX package's ``losses/losses.py``: spectra in the (B, T, F, 2)
layout, a dense (B, T) 0/1 frame mask from :func:`frame_mask`, and the
composite loss of the composed model.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch


def frame_mask(frame_counts: torch.Tensor, num_frames: int) -> torch.Tensor:
    """(B,) valid-frame counts -> (B, T) 0/1 float mask."""
    counts = torch.as_tensor(frame_counts)
    t = torch.arange(num_frames, device=counts.device)
    return (t[None, :] < counts[:, None]).to(torch.float32)


def safe_mag(x: torch.Tensor) -> torch.Tensor:
    """sqrt(x_r^2 + x_i^2) over the trailing RI axis, with a zero (not NaN)
    gradient at exactly-zero bins: zero-padded frames make the estimate
    exactly 0 there, and the mask's 0 times sqrt's infinite slope would
    poison every parameter. Values are the plain magnitude elsewhere."""
    sq = torch.sum(torch.square(x), dim=-1)
    nonzero = sq > 0
    return torch.where(nonzero, torch.sqrt(torch.where(
        nonzero, sq, torch.ones_like(sq))), torch.zeros_like(sq))


def com_mag_mse_loss(esti: torch.Tensor, label: torch.Tensor,
                     mask: torch.Tensor) -> torch.Tensor:
    """0.5 * (masked magnitude MSE + masked RI MSE); esti, label
    (B, T, F, 2), mask (B, T)."""
    m = mask[:, :, None]
    denom_mag = torch.sum(m) * esti.shape[2]
    loss_mag = torch.sum(torch.square(safe_mag(esti) - safe_mag(label))
                         * m) / denom_mag
    # the RI mask counts both real and imaginary entries
    loss_ri = torch.sum(torch.square(esti - label) * m[..., None]) / (
        2.0 * denom_mag)
    return 0.5 * (loss_mag + loss_ri)


def stagewise_com_mag_mse_loss(esti_list: Sequence[torch.Tensor],
                               label: torch.Tensor, mask: torch.Tensor,
                               alpha_mid: float = 0.1) -> torch.Tensor:
    """Weighted multi-stage loss: ``alpha_mid`` on the intermediate stages,
    1.0 on the last."""
    m = mask[:, :, None]
    denom = torch.sum(m) * label.shape[2]
    mag_l = safe_mag(label)
    loss_ri, loss_mag = 0.0, 0.0
    n = len(esti_list)
    for i, esti in enumerate(esti_list):
        alpha = 1.0 if i == n - 1 else alpha_mid
        loss_ri = loss_ri + alpha * torch.sum(
            torch.square(esti - label) * m[..., None]) / (2.0 * denom)
        loss_mag = loss_mag + alpha * torch.sum(
            torch.square(safe_mag(esti) - mag_l) * m) / denom
    return 0.5 * (loss_ri + loss_mag)


def eabnet_with_postnet_loss(output: Dict, label: torch.Tensor,
                             mask: torch.Tensor) -> Dict[str, torch.Tensor]:
    """{eabnet, postnet, final} of the composed model's output."""
    loss0 = com_mag_mse_loss(output["esti0"], label, mask)
    loss1 = stagewise_com_mag_mse_loss(output["esti1"], label, mask)
    return {"eabnet": loss0, "postnet": loss1, "final": loss0 + loss1}
