"""Frame-by-frame enhancement with O(1) carried state, in PyTorch.

The models are causal when their norms are, so a stream that carries the
right state from frame to frame reproduces the offline output. A stepper
runs the offline model's own ``forward`` on one frame at a time inside
``nn/stepping.stepping``, so one set of modules and weights serves both.
The leaves that look along time carry the state:

- time convs and transposed convs a ring of their last k_t - 1 input
  frames ((K - 1) * dilation for a TCM's dilated conv);
- cumulative layer norms (count, sum, sum of squares) per item, in
  float32, from the same virtual-frame prior as offline;
- each LSTM layer of the LSTM beamforming head (h, c) over its B * F
  lanes (``nn/lstm.py``; the LSTM-BF kernel runs whole utterances only).
  The cnn and miso heads are pointwise Dense maps and carry nothing, so
  their models' state holds no LSTM leaves, as the JAX stepper's.

Batch norms read their running statistics: the stepper puts the model in
evaluation mode. The state is a flat dict of tensors on the model's
device, keyed by module name and field; every stream of a batch is an
independent item. Instance norm cannot stream (its statistics span the
utterance), nor can a non-causal TCN; both raise ``ValueError``, as the
JAX package's stepper refuses IN.
"""

from __future__ import annotations

from typing import Tuple

import torch

from eabnet_tpu_torch.models.composed import EaBNetWithPostNet
from eabnet_tpu_torch.models.eabnet import EaBNet
from eabnet_tpu_torch.nn.stepping import Frame, State, stepping


def _check_streamable(cfg) -> None:
    if cfg.norm_type == "IN":
        raise ValueError(
            "InstanceNorm cannot stream (non-causal statistics); train with "
            "norm_type='cLN' or 'BN'")
    if not cfg.is_causal:
        raise ValueError("a non-causal TCN cannot stream: its dilated convs "
                         "look ahead in time")


class _Stepper:
    """init_state / step / run over an offline model in evaluation mode,
    whose modules and weights it uses in place. A subclass's ``_forward``
    runs the model's offline forward on one frame (B, 1, F, M, 2)."""

    def __init__(self, model: torch.nn.Module, mics: int, freq_bins: int):
        self.model = model.eval()
        self.mics, self.freq_bins = mics, freq_bins
        self._names = {mod: name for name, mod in model.named_modules()}

    def _step(self, fr: Frame, frame: torch.Tensor):
        if frame.dim() == 3:  # one mic
            frame = frame.unsqueeze(-2)
        with stepping(fr):
            return self._forward(frame.unsqueeze(1))

    @torch.no_grad()
    def init_state(self, batch: int) -> State:
        """The state of ``batch`` streams at their start (zero rings and
        LSTM states, the cLN prior), read off a first step."""
        p = next(self.model.parameters())
        frame = torch.zeros((batch, self.freq_bins, self.mics, 2),
                            dtype=p.dtype, device=p.device)
        fr = Frame(self._names, None)
        self._step(fr, frame)
        return fr.start

    @torch.no_grad()
    def step(self, state: State, frame: torch.Tensor) -> Tuple[State, object]:
        """state, one frame (B, F, M, 2) of every stream -> (new state,
        this frame's estimate)."""
        fr = Frame(self._names, state)
        out = self._step(fr, frame)
        return fr.new, out

    def run(self, frames: torch.Tensor):
        """(B, T, F, M, 2) frames from a fresh state, one at a time; the
        estimates stacked over T."""
        state = self.init_state(frames.shape[0])
        outs = []
        for t in range(frames.shape[1]):
            state, out = self.step(state, frames[:, t])
            outs.append(out)
        if isinstance(outs[0], dict):
            return {k: torch.stack([o[k] for o in outs], dim=1)
                    for k in outs[0]}
        return torch.stack(outs, dim=1)


class StreamingEaBNet(_Stepper):
    """Frame-by-frame EaBNet: ``step(state, frame (B, F, M, 2)) -> (state,
    esti (B, F, 2))``."""

    def __init__(self, model: EaBNet):
        _check_streamable(model.cfg)
        # the encoder's stride-2 stages take 161 bins (a 320-point FFT)
        super().__init__(model, model.cfg.M, 161)

    def _forward(self, x):
        return self.model(x)[:, 0]


class StreamingComposed(_Stepper):
    """Frame-by-frame EaBNet + GaGNet: ``step(state, frame (B, F, M, 2))
    -> (state, {"esti0": beamformer, "esti": post-filtered}, each (B, F,
    2))``."""

    def __init__(self, model: EaBNetWithPostNet):
        cfg = model.cfg
        _check_streamable(cfg.eabnet)
        _check_streamable(cfg.gagnet)
        super().__init__(model, cfg.eabnet.M, cfg.gagnet.freq_bins)

    def _forward(self, x):
        out = self.model(x)
        return {k: out[k][:, 0] for k in ("esti0", "esti")}


def state_bytes(state: State) -> int:
    """The bytes a stream state holds."""
    return sum(v.numel() * v.element_size() for v in state.values())
