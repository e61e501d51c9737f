"""Shared CLI plumbing of the port, as the JAX package's CLIs have it: one
typed JSON config (``--config exp.json``) plus dotted-key overrides
(``--set train.lr=1e-4``, repeatable). A value is read as JSON where it
parses, else kept as a string."""

from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Any, Dict, List

from eabnet_tpu_torch.config import ExperimentConfig


def add_config_args(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--config", type=str, default=None,
                        help="experiment config JSON (defaults used if "
                        "omitted)")
    parser.add_argument(
        "--set", action="append", default=[], metavar="KEY=VALUE",
        help="dotted config override, e.g. --set train.lr=1e-4 "
        "--set model.eabnet.M=8 (repeatable)")


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


def load_config(args: argparse.Namespace) -> ExperimentConfig:
    """The config of ``--config`` (defaults without it) with every
    ``--set`` applied."""
    cfg = (ExperimentConfig.load(args.config) if args.config
           else ExperimentConfig())
    if args.set:
        cfg = ExperimentConfig.from_dict(
            apply_overrides(dataclasses.asdict(cfg), args.set))
    return cfg
