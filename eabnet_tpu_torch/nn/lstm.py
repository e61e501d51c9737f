"""One frame of one LSTM layer, for streaming.

The offline beamforming head runs its two stacked LSTMs over a whole
utterance through the LSTM-BF kernel wrapper (``kernels/lstm_bf.py``); a
stream advances them one frame at a time with this step, as the JAX
package does outside any Pallas kernel.
"""

from __future__ import annotations

from typing import Tuple

import torch


def step_fn(layer, h_c: Tuple[torch.Tensor, torch.Tensor],
            x_t: torch.Tensor):
    """``layer``: one LSTM layer's weights in the JAX layout (``w_ih``
    (in, 4H), ``w_hh`` (H, 4H), ``b_ih``, ``b_hh``; gate order i, f, g,
    o), as the port's ``LSTMBeamformer`` holds them; ``h_c``: (h, c), each
    (L, H); ``x_t``: (L, in). Returns ((h, c), h) after the frame."""
    h_prev, c_prev = h_c
    gates = (x_t @ layer.w_ih + h_prev @ layer.w_hh + layer.b_ih
             + layer.b_hh)
    i, f, g, o = torch.chunk(gates, 4, dim=-1)
    c = torch.sigmoid(f) * c_prev + torch.sigmoid(i) * torch.tanh(g)
    h = torch.sigmoid(o) * torch.tanh(c)
    return (h, c), h


def step_carried(frame, layer, x_t: torch.Tensor) -> torch.Tensor:
    """One frame of ``layer`` on ``x_t`` (L, in), its (h, c) carried by
    ``frame`` (``nn/stepping.py``) and zero at a stream's start; returns
    h (L, H)."""
    hidden = layer.w_hh.shape[0]
    h_c = tuple(frame.carried(layer, f, lambda: x_t.new_zeros(
        x_t.shape[0], hidden)) for f in ("h", "c"))
    (h, c), out = step_fn(layer, h_c, x_t)
    frame.keep(layer, "h", h)
    frame.keep(layer, "c", c)
    return out
