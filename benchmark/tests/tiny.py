"""Tiny cells for the CPU tests: the released configurations cut to a
few channels and mics, short utterances and clips, on the CPU."""

from __future__ import annotations

import copy
import json

from benchmark import harness

ROOT = harness.BENCH_DIR.parent


def tiny_config(name: str = "composed_9mic") -> dict:
    with open(ROOT / "benchmark" / "configs" / f"{name}.json") as f:
        cfg = json.load(f)
    e, g = cfg["model"]["eabnet"], cfg["model"]["gagnet"]
    e.update(c=8, M=3, embed_dim=8, cd1=8, p=2, q=1, hid_node=16)
    g.update(c=8, cd1=8, p=1, q=1, dilas=[1, 2])
    return cfg


def tiny_cell(kind: str, config: str = "composed_9mic",
              compute_dtype: str = "float32") -> harness.Cell:
    """A cell of ``kind`` ("serve" or "train") at a tiny size; training
    in ``compute_dtype``."""
    spec = harness.load_spec(ROOT)
    name = next(w["name"] for w in spec["workloads"]
                if w["name"].endswith(config)
                and (w["traffic"].startswith("serve") == (kind == "serve")))
    cell = harness.find_cell(name, ROOT)
    cell = copy.deepcopy(cell)
    cell.config = tiny_config(config)
    cell.config["train"]["compute_dtype"] = compute_dtype
    wl = cell.workload
    if kind == "serve":
        wl["traffic"].update(batch=2, ring_batches=3, min_seconds=0.3,
                             max_seconds=0.9, bucket_seconds=0.25)
        wl["check"]["calls"] = 2
        wl["trace_calls"] = 3
    else:
        wl["traffic"].update(batch=4, ring_batches=2, clip_seconds=0.3)
        wl["check"]["block"] = 2
        wl["trace_steps"] = 2
    return cell
