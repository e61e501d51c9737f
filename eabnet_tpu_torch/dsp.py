"""STFT / iSTFT front end and power compression, in PyTorch.

The same transform as the JAX package's ``dsp/stft.py``: ``torch.stft``
semantics with ``center=True``, reflect padding, onesided output and a
periodic Hann window, computed as a float32 product with explicit DFT
bases so that both packages round alike. Spectra are time-major:
``stft`` gives ``(..., T, F, 2)`` (real, imag). ``StreamingStft`` and
``StreamingIstft`` are the same transforms one hop at a time, for
streaming.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from eabnet_tpu_torch.config import StftConfig


def hann_window(win_size: int, device=None) -> torch.Tensor:
    """Periodic Hann window, identical to ``torch.hann_window(win_size)``."""
    n = np.arange(win_size)
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_size)
    return torch.as_tensor(w, dtype=torch.float32, device=device)


@functools.lru_cache(maxsize=8)
def _dft_bases(n_fft: int) -> np.ndarray:
    """(n_fft, 2F) [cos | -sin] basis of the onesided forward DFT."""
    f = n_fft // 2 + 1
    ang = 2.0 * np.pi * np.arange(n_fft)[:, None] * np.arange(f)[None] / n_fft
    return np.concatenate([np.cos(ang), -np.sin(ang)], axis=1)


@functools.lru_cache(maxsize=8)
def _idft_bases(n_fft: int) -> np.ndarray:
    """(2F, n_fft) basis of the onesided inverse DFT:
    x[n] = sum_f w_f (Re X_f cos(2 pi f n/N) - Im X_f sin(2 pi f n/N)) / N,
    w_f = 2 except at the DC and Nyquist bins."""
    f = n_fft // 2 + 1
    ang = 2.0 * np.pi * np.arange(f)[:, None] * np.arange(n_fft)[None] / n_fft
    w = np.full((f, 1), 2.0)
    w[0] = 1.0
    if n_fft % 2 == 0:
        w[-1] = 1.0
    return np.concatenate([w * np.cos(ang) / n_fft,
                           -w * np.sin(ang) / n_fft], axis=0)


def _window(win_size: int, n_fft: int, device) -> torch.Tensor:
    window = hann_window(win_size, device)
    if win_size < n_fft:  # torch centres the window in the fft buffer
        lpad = (n_fft - win_size) // 2
        window = F.pad(window, (lpad, n_fft - win_size - lpad))
    return window


@functools.lru_cache(maxsize=16)
def _constants(n_fft: int, win_size: int, device: torch.device,
               inverse: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """(window, DFT or inverse DFT basis) on ``device``, made once per
    device: a copy from host memory inside a forward would make the host
    wait for the device's queue (and serialise the replicas of a mesh,
    ``inference.py``). Read only."""
    bases = _idft_bases(n_fft) if inverse else _dft_bases(n_fft)
    return (_window(win_size, n_fft, device),
            torch.as_tensor(bases, dtype=torch.float32, device=device))


def stft(wav: torch.Tensor, n_fft: int = 320, hop: int = 160,
         win_size: Optional[int] = None) -> torch.Tensor:
    """Onesided STFT of ``wav (..., N)`` -> ``(..., T, F, 2)``."""
    win_size = win_size or n_fft
    window, basis = _constants(n_fft, win_size, wav.device, False)
    lead = wav.shape[:-1]
    pad = n_fft // 2
    x = F.pad(wav.float().reshape(-1, 1, wav.shape[-1]), (pad, pad),
              mode="reflect").reshape(*lead, -1)
    frames = x.unfold(-1, n_fft, hop) * window  # (..., T, n_fft)
    spec = frames @ basis
    f = n_fft // 2 + 1
    return torch.stack([spec[..., :f], spec[..., f:]], dim=-1)


def _overlap_add(frames: torch.Tensor, hop: int, out_len: int):
    """Overlap-add ``frames (..., T, n_fft)`` at stride ``hop``."""
    n_fft, t = frames.shape[-1], frames.shape[-2]
    lead = frames.shape[:-2]
    if n_fft % hop == 0:
        k = n_fft // hop
        sub = frames.reshape(*lead, t, k, hop)
        out = frames.new_zeros((*lead, t + k - 1, hop))
        for i in range(k):
            out[..., i:i + t, :] += sub[..., :, i, :]
        return out.reshape(*lead, -1)[..., :out_len]
    idx = (torch.arange(t, device=frames.device)[:, None] * hop
           + torch.arange(n_fft, device=frames.device)[None]).reshape(-1)
    out = frames.new_zeros((*lead, out_len))
    return out.index_add_(-1, idx, frames.reshape(*lead, -1))


def istft(spec: torch.Tensor, n_fft: int = 320, hop: int = 160,
          win_size: Optional[int] = None,
          length: Optional[int] = None) -> torch.Tensor:
    """Inverse of :func:`stft`: ``(..., T, F, 2)`` -> ``(..., N)``; the
    windowed overlap-add divided by the overlap-added squared window."""
    win_size = win_size or n_fft
    window, basis = _constants(n_fft, win_size, spec.device, True)
    t = spec.shape[-3]
    ri = torch.cat([spec[..., 0], spec[..., 1]], dim=-1)  # (..., T, 2F)
    frames = (ri @ basis) * window
    out_len = n_fft + hop * (t - 1)
    wav = _overlap_add(frames, hop, out_len)
    wsq = _overlap_add((window * window).expand(t, n_fft), hop, out_len)
    pad = n_fft // 2
    wav = wav[..., pad:out_len - pad] / torch.clamp(
        wsq[pad:out_len - pad], min=1e-11)
    return wav if length is None else wav[..., :length]


def power_compress(spec_ri: torch.Tensor, power: float = 0.5,
                   dim: int = -1) -> torch.Tensor:
    """Compress the magnitude to ``mag**power``, keeping the phase
    (``ri * mag**(power - 1)``; exact zeros stay zero)."""
    mag = torch.sqrt(torch.sum(spec_ri * spec_ri, dim=dim, keepdim=True))
    scale = torch.where(mag > 0, mag.pow(power - 1.0),
                        torch.zeros_like(mag))
    return spec_ri * scale


def power_uncompress(spec_ri: torch.Tensor, power: float = 0.5,
                     dim: int = -1) -> torch.Tensor:
    """Invert :func:`power_compress`."""
    return power_compress(spec_ri, power=1.0 / power, dim=dim)


def prepare_data(noisy_wav: torch.Tensor, target_wav: Optional[torch.Tensor],
                 cfg: StftConfig
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """noisy (B, M, N) [, target (B, N) or (B, 1, N)] ->
    noisy_stft (B, T, F, M, 2) [, target_stft (B, 2, T, F)], compressed."""
    spec = stft(noisy_wav, cfg.fft_num, cfg.hop_samples, cfg.win_samples)
    noisy = power_compress(spec.permute(0, 2, 3, 1, 4), cfg.compression)
    target = None
    if target_wav is not None:
        if target_wav.dim() == 3:
            target_wav = target_wav[:, 0]
        tspec = stft(target_wav, cfg.fft_num, cfg.hop_samples,
                     cfg.win_samples)
        target = power_compress(tspec, cfg.compression).permute(0, 3, 1, 2)
    return noisy, target


def stft_to_wav(esti_stft: torch.Tensor, cfg: StftConfig,
                length: Optional[int] = None) -> torch.Tensor:
    """(B, 2, T, F) compressed spectrum -> waveform (B, N). Inverts the
    power compression first unless ``cfg.decompress_output`` is False."""
    spec = esti_stft.permute(0, 2, 3, 1)  # (B, T, F, 2)
    if cfg.decompress_output:
        spec = power_uncompress(spec, cfg.compression)
    return istft(spec, cfg.fft_num, cfg.hop_samples, cfg.win_samples,
                 length=length)


class StreamingStft:
    """Sample-in, frame-out STFT: each push of hop samples gives one
    power-compressed (..., F, 2) frame. Equals :func:`stft` once the
    window lies inside the signal (the offline transform reflect-pads its
    first n_fft/2 samples; a stream starts from silence)."""

    def __init__(self, cfg: StftConfig, device=None):
        self.cfg = cfg
        self.device = device
        self.window = _window(cfg.win_samples, cfg.fft_num, device)
        self.basis = torch.as_tensor(_dft_bases(cfg.fft_num),
                                     dtype=torch.float32, device=device)

    def init_state(self, *lead: int) -> torch.Tensor:
        """The carried input tail: the last n_fft - hop samples."""
        return torch.zeros(lead + (self.cfg.fft_num - self.cfg.hop_samples,),
                           device=self.device)

    def push(self, state: torch.Tensor, samples: torch.Tensor):
        """state, (..., hop) samples -> (new state, (..., F, 2) frame)."""
        buf = torch.cat([state, samples], dim=-1)  # (..., n_fft)
        spec = (buf * self.window) @ self.basis
        f = self.cfg.freq_bins
        out = torch.stack([spec[..., :f], spec[..., f:]], dim=-1)
        return buf[..., self.cfg.hop_samples:], power_compress(
            out, self.cfg.compression)


class StreamingIstft:
    """Frame-in, sample-out iSTFT: each pushed (..., F, 2) frame gives hop
    samples, n_fft - hop samples after its window's start (the
    overlap-add's look-ahead), divided by the steady-state overlap-added
    squared window. Equals the interior of :func:`istft`."""

    def __init__(self, cfg: StftConfig, device=None):
        self.cfg = cfg
        self.device = device
        n, hop = cfg.fft_num, cfg.hop_samples
        window = _window(cfg.win_samples, n, device)
        self.window = window
        self.basis = torch.as_tensor(_idft_bases(n), dtype=torch.float32,
                                     device=device)
        w = window.cpu().numpy() ** 2  # float32, as the JAX package
        wsq = np.zeros(n)
        for k in range(-(n // hop) + 1, n // hop):
            lo, hi = max(0, k * hop), min(n, n + k * hop)
            wsq[lo:hi] += w[lo - k * hop:hi - k * hop]
        self.envelope = torch.as_tensor(np.maximum(wsq[:hop], 1e-11),
                                        dtype=torch.float32, device=device)

    def init_state(self, *lead: int) -> torch.Tensor:
        """The carried overlap-add tail of n_fft - hop samples."""
        return torch.zeros(lead + (self.cfg.fft_num - self.cfg.hop_samples,),
                           device=self.device)

    def push(self, state: torch.Tensor, frame_ri: torch.Tensor):
        """state, (..., F, 2) frame -> (new state, (..., hop) samples)."""
        hop = self.cfg.hop_samples
        ri = torch.cat([frame_ri[..., 0], frame_ri[..., 1]], dim=-1)
        acc = (ri @ self.basis) * self.window
        acc = torch.cat([acc[..., :state.shape[-1]] + state,
                         acc[..., state.shape[-1]:]], dim=-1)
        return acc[..., hop:], acc[..., :hop] / self.envelope
