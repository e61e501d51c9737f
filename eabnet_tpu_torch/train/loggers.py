"""TensorBoard scalars and audio of a training run, and the parameter
count. The writer (tensorboardX) is imported at its first use, so a run
with the logger disabled needs no TensorBoard package; without
tensorboardX the logger says so once and logs nothing, and without the
package tensorboardX encodes audio with (soundfile) it logs no audio, and
without matplotlib no spectrogram images."""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
from torch import nn


class TrainLogger:
    """Lazy TensorBoard writer under ``logdir``; every call is a no-op when
    ``enabled`` is False."""

    def __init__(self, logdir: str, enabled: bool = True):
        self.logdir = logdir
        self.enabled = enabled
        self.audio_enabled = True
        self._writer = None

    @property
    def writer(self):
        if self._writer is None and self.enabled:
            try:
                from tensorboardX import SummaryWriter
            except ImportError:
                print("tensorboardX is not installed: no TensorBoard logs")
                self.enabled = False
                return None
            os.makedirs(self.logdir, exist_ok=True)
            self._writer = SummaryWriter(self.logdir)
        return self._writer

    def scalars(self, tag_prefix: str, values: Dict[str, float],
                step: int) -> None:
        if self.writer is None:
            return
        for k, v in values.items():
            self.writer.add_scalar(f"{tag_prefix}/{k}", float(v), step)

    def audio(self, tag: str, wav: np.ndarray, step: int, sr: int) -> None:
        if not self.audio_enabled or self.writer is None:
            return
        wav = np.asarray(wav, np.float32).reshape(1, -1)
        peak = np.abs(wav).max()
        if peak > 1.0:
            wav = wav / peak
        try:
            self.writer.add_audio(tag, wav, step, sr)
        except ImportError as e:  # tensorboardX encodes with soundfile
            print(f"no audio in the TensorBoard logs: {e}")
            self.audio_enabled = False

    def spectrogram(self, tag: str, spec_mag: np.ndarray, step: int) -> None:
        """A (T, F) magnitude spectrogram as an inferno-coloured image."""
        if self.writer is None:
            return
        try:
            import matplotlib
        except ImportError:
            return  # no spectrogram images without matplotlib

        s = np.log(np.abs(spec_mag) + 1e-6)
        s = (s - s.min()) / (s.max() - s.min() + 1e-12)
        img = matplotlib.colormaps["inferno"](s.T[::-1])[..., :3]
        self.writer.add_image(tag, img.transpose(2, 0, 1).astype(np.float32),
                              step)

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()
            self._writer = None


def num_params(model: nn.Module) -> int:
    """Trainable parameter count."""
    return sum(p.numel() for p in model.parameters())
