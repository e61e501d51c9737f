"""The model's operations per frame, from the reference's module shapes.

The composed model is causal and its convolutions and products all run
along time, so its matmul and conv FLOPs grow with the frames alone:
``frame_flops`` is the count of one item's forward over ``frames``
frames divided by ``frames``, taken by ``torch.utils.flop_counter`` over
the reference run on a few frames of zeros on the CPU. The front end's
DFT products are not the model's and are not counted. ``tcn_groups``
lists the squeezed-TCN groups of one forward, the work that the
TCM-chain kernel runs as chains.
"""

from __future__ import annotations

import functools
import json

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.reference.model import Composed


@functools.lru_cache(maxsize=8)
def _frame_flops(model_json: str, bins: int, frames: int) -> float:
    cfg = json.loads(model_json)
    model = Composed(cfg)
    x = torch.zeros((1, frames, bins, cfg["eabnet"]["M"], 2))
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        model(x)
    return fc.get_total_flops() / frames


def frame_flops(model_cfg: dict, bins: int, frames: int = 4) -> float:
    """Forward FLOPs per frame of one item of the model ``model_cfg``."""
    return _frame_flops(json.dumps(model_cfg, sort_keys=True), bins, frames)


def tcn_groups(model_cfg: dict):
    """[(p, K, C, D, branches)] of every TCN group of one forward: a
    chain of p squeezed TCMs on D-wide frame vectors at the model's own
    width C (cd1) and kernel K (kd1); EaBNet's q groups of p twin-gated
    TCMs, GaGNet's q stages of p glance and 2p gaze groups of
    single-branch TCMs."""
    e, g = model_cfg["eabnet"], model_cfg["gagnet"]
    out = [(e["p"], e["kd1"], e["cd1"], e["d_feat"], 2)] * e["q"]
    out += [(len(g["dilas"]), g["kd1"], g["cd1"], g["d_feat"], 1)] * (
        3 * g["p"] * g["q"])
    return out
