"""The reference's front end: STFT and iSTFT (320-point periodic Hann,
160-sample hop, ``center=True`` with reflect padding, 161 bins) as
float32 products with explicit DFT bases, and magnitude^0.5 compression.
Spectra are time-major, (..., T, F, 2)."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _window(n_fft: int, device) -> torch.Tensor:
    n = np.arange(n_fft)
    return torch.as_tensor(0.5 - 0.5 * np.cos(2 * np.pi * n / n_fft),
                           dtype=torch.float32, device=device)


def _bases(n_fft: int, device):
    f = n_fft // 2 + 1
    ang = 2 * np.pi * np.arange(n_fft)[:, None] * np.arange(f)[None] / n_fft
    fwd = np.concatenate([np.cos(ang), -np.sin(ang)], axis=1)
    w = np.full((f, 1), 2.0)
    w[0] = 1.0
    w[-1] = 1.0  # n_fft even
    inv = np.concatenate([w * np.cos(ang.T) / n_fft,
                          -w * np.sin(ang.T) / n_fft], axis=0)
    return (torch.as_tensor(fwd, dtype=torch.float32, device=device),
            torch.as_tensor(inv, dtype=torch.float32, device=device))


def stft(wav: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """(..., N) -> (..., T, F, 2), T = 1 + N // hop."""
    window = _window(n_fft, wav.device)
    basis = _bases(n_fft, wav.device)[0]
    lead = wav.shape[:-1]
    x = F.pad(wav.float().reshape(-1, 1, wav.shape[-1]),
              (n_fft // 2, n_fft // 2), mode="reflect").reshape(*lead, -1)
    spec = (x.unfold(-1, n_fft, hop) * window) @ basis
    f = n_fft // 2 + 1
    return torch.stack([spec[..., :f], spec[..., f:]], dim=-1)


def _overlap_add(frames: torch.Tensor, hop: int, out_len: int):
    n_fft, t = frames.shape[-1], frames.shape[-2]
    idx = (torch.arange(t, device=frames.device)[:, None] * hop
           + torch.arange(n_fft, device=frames.device)[None]).reshape(-1)
    out = frames.new_zeros((*frames.shape[:-2], out_len))
    return out.index_add_(-1, idx, frames.reshape(*frames.shape[:-2], -1))


def istft(spec: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """(..., T, F, 2) -> (..., hop * (T - 1)): windowed overlap-add over
    the overlap-added squared window, the centre padding cut off."""
    window = _window(n_fft, spec.device)
    basis = _bases(n_fft, spec.device)[1]
    t = spec.shape[-3]
    frames = (torch.cat([spec[..., 0], spec[..., 1]], dim=-1) @ basis) \
        * window
    out_len = n_fft + hop * (t - 1)
    wav = _overlap_add(frames, hop, out_len)
    wsq = _overlap_add((window * window).expand(t, n_fft), hop, out_len)
    pad = n_fft // 2
    return wav[..., pad:out_len - pad] / torch.clamp(
        wsq[pad:out_len - pad], min=1e-11)


def compress(spec: torch.Tensor, power: float) -> torch.Tensor:
    """Magnitude to mag**power, phase kept; exact zeros stay zero."""
    mag = torch.sqrt(torch.sum(spec * spec, dim=-1, keepdim=True))
    return spec * torch.where(mag > 0, mag.pow(power - 1.0),
                              torch.zeros_like(mag))


def features(noisy: torch.Tensor, stft_cfg: dict) -> torch.Tensor:
    """(B, M, N) -> compressed (B, T, F, M, 2)."""
    spec = stft(noisy, stft_cfg["fft_num"], _hop(stft_cfg))
    return compress(spec.permute(0, 2, 3, 1, 4), stft_cfg["compression"])


def target(clean: torch.Tensor, stft_cfg: dict) -> torch.Tensor:
    """(B, N) -> compressed (B, T, F, 2)."""
    return compress(stft(clean, stft_cfg["fft_num"], _hop(stft_cfg)),
                    stft_cfg["compression"])


def to_wav(esti: torch.Tensor, stft_cfg: dict) -> torch.Tensor:
    """(B, T, F, 2) compressed estimate -> (B, N)."""
    if stft_cfg.get("decompress_output", True):
        esti = compress(esti, 1.0 / stft_cfg["compression"])
    return istft(esti, stft_cfg["fft_num"], _hop(stft_cfg))


def _hop(stft_cfg: dict) -> int:
    return int(stft_cfg["win_shift"] * stft_cfg["sr"])
