"""Training CLI of the port:

    python -m eabnet_tpu_torch.cli.train --config exp.json [--max-steps N]
        [--device cuda] [--set train.compute_dtype=float32 ...]

Runs ``train.trainer.train`` on one device (the card by default; ``cpu``
runs every kernel's plain version). ``--config`` and ``--set`` are those
of ``cli/common.py``. A released config records
``train.compute_dtype: "bfloat16"`` and trains in bf16 mixed precision as
recorded; ``--set train.compute_dtype=float32`` trains it in float32."""

from __future__ import annotations

import argparse

from eabnet_tpu_torch.cli.common import add_config_args, load_config


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="train EaBNet+GaGNet on one device (PyTorch port)")
    add_config_args(parser)
    parser.add_argument("--max-steps", type=int, default=None,
                        help="stop after N optimizer steps")
    parser.add_argument("--device", default="cuda",
                        help="torch device to train on (default: cuda)")
    args = parser.parse_args(argv)

    from eabnet_tpu_torch.train.trainer import train

    train(load_config(args), max_steps=args.max_steps, device=args.device)


if __name__ == "__main__":
    main()
