"""Training CLI of the port:

    python -m eabnet_tpu_torch.cli.train --config exp.json [--max-steps N]
        [--device cuda]

Runs ``train.trainer.train`` on one device (the card by default; ``cpu``
runs every kernel's plain version)."""

from __future__ import annotations

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="train EaBNet+GaGNet on one device (PyTorch port)")
    parser.add_argument("--config", type=str, default=None,
                        help="experiment config JSON (defaults if omitted)")
    parser.add_argument("--max-steps", type=int, default=None,
                        help="stop after N optimizer steps")
    parser.add_argument("--device", default="cuda",
                        help="torch device to train on (default: cuda)")
    args = parser.parse_args(argv)

    from eabnet_tpu_torch.config import ExperimentConfig
    from eabnet_tpu_torch.train.trainer import train

    cfg = (ExperimentConfig.load(args.config) if args.config
           else ExperimentConfig())
    train(cfg, max_steps=args.max_steps, device=args.device)


if __name__ == "__main__":
    main()
