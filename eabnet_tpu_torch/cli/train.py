"""Training CLI of the port:

    python -m eabnet_tpu_torch.cli.train --config exp.json [--max-steps N]
        [--device cuda] [--set train.compute_dtype=float32 ...]

Runs ``train.trainer.train`` on one device (the card by default; ``cpu``
runs every kernel's plain version). ``--set key=value`` overrides one
dotted config key, as the JAX package's CLIs do: the value is read as
JSON where it parses, else kept as a string. A released config records
``train.compute_dtype: "bfloat16"`` and trains in bf16 mixed precision as
recorded; ``--set train.compute_dtype=float32`` trains it in float32."""

from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Any, Dict, List


def parse_value(text: str) -> Any:
    try:
        return json.loads(text)
    except json.JSONDecodeError:
        return text


def apply_overrides(d: Dict, overrides: List[str]) -> Dict:
    """Set each ``key.sub=value`` of ``overrides`` in the nested dict ``d``
    (in place; missing levels are created) and return ``d``."""
    for item in overrides:
        key, _, value = item.partition("=")
        node = d
        parts = key.strip().split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = parse_value(value)
    return d


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="train EaBNet+GaGNet on one device (PyTorch port)")
    parser.add_argument("--config", type=str, default=None,
                        help="experiment config JSON (defaults if omitted)")
    parser.add_argument(
        "--set", action="append", default=[], metavar="KEY=VALUE",
        help="dotted config override, e.g. --set train.lr=1e-4 "
        "--set model.eabnet.M=8 (repeatable)")
    parser.add_argument("--max-steps", type=int, default=None,
                        help="stop after N optimizer steps")
    parser.add_argument("--device", default="cuda",
                        help="torch device to train on (default: cuda)")
    args = parser.parse_args(argv)

    from eabnet_tpu_torch.config import ExperimentConfig
    from eabnet_tpu_torch.train.trainer import train

    cfg = (ExperimentConfig.load(args.config) if args.config
           else ExperimentConfig())
    if args.set:
        cfg = ExperimentConfig.from_dict(
            apply_overrides(dataclasses.asdict(cfg), args.set))
    train(cfg, max_steps=args.max_steps, device=args.device)


if __name__ == "__main__":
    main()
