"""Evaluation CLI of the port: score a checkpoint on a config's validation
set and write the metric report, as the JAX package's ``cli/test.py``
does (reference: test.py:155-212).

    python -m eabnet_tpu_torch.cli.test --config exp.json [--set K=V ...]
        [--ckpt X.ckpt|X.params|X.pth] [--output esti0|esti] [--limit N]
        [--out-prefix P] [--device cuda]

The model runs on ``--device`` (the card by default, through the
hand-written kernels; ``cpu`` runs their plain versions); the metric
battery (``eval/harness.py``) runs on the host. Writes ``<prefix>.csv``
(one row per item) and ``<prefix>.txt`` (``metric: mean ± std``, the PESQ
backend and the stage) and prints the report.
"""

from __future__ import annotations

import argparse
import os


def main(argv=None):
    from eabnet_tpu_torch.cli.common import add_config_args, load_config

    parser = argparse.ArgumentParser(description="metric evaluation")
    add_config_args(parser)
    parser.add_argument("--ckpt", default=None,
                        help="checkpoint path (.ckpt, .params or reference "
                        ".pth); default: newest in train.checkpoint_dir")
    parser.add_argument("--out-prefix", default=None,
                        help="report path prefix (default: next to ckpt)")
    parser.add_argument("--limit", type=int, default=None,
                        help="score only the first N utterances")
    parser.add_argument("--output", default="esti0",
                        choices=["esti0", "esti"],
                        help="stage to score: esti0 = bare EaBNet (what "
                        "the reference's test.py evaluates, lines "
                        "160-165), esti = composed with GaGNet postnet")
    parser.add_argument("--device", default="cuda",
                        help="torch device of the model (default: cuda)")
    args = parser.parse_args(argv)

    cfg = load_config(args)

    import numpy as np

    from eabnet_tpu_torch.data.datasets import make_dataset
    from eabnet_tpu_torch.eval import evaluate_dataset, write_report
    from eabnet_tpu_torch.inference import Enhancer
    from eabnet_tpu_torch.train.checkpoint import (latest_checkpoint,
                                                   load_checkpoint)
    from eabnet_tpu_torch.train.step import create_train_state
    from eabnet_tpu_torch.weights import to_jax_params

    ckpt = args.ckpt or latest_checkpoint(cfg.train.checkpoint_dir)
    if not ckpt:
        raise SystemExit("no checkpoint found; pass --ckpt")
    state = create_train_state(cfg, device="cpu")
    state, _ = load_checkpoint(ckpt, state, cfg)
    enhancer = Enhancer(cfg, to_jax_params(state.model), output=args.output,
                        device=args.device)
    del state

    _, val_ds = make_dataset(cfg.data, mics=cfg.model.eabnet.M)
    if val_ds is None:
        raise SystemExit("config has no validation set")
    n = len(val_ds) if args.limit is None else min(args.limit, len(val_ds))

    def items():
        for i in range(n):
            noisy, clean = val_ds[i]
            yield np.atleast_2d(noisy), np.asarray(clean).reshape(-1)

    acc, rows = evaluate_dataset(enhancer, items(), sr=cfg.stft.sr)
    # the stage goes into both the default file name and the report body,
    # so score files of the two stages stay apart
    prefix = args.out_prefix or f"{os.path.splitext(ckpt)[0]}_{args.output}"
    path = write_report(acc, rows, prefix, extra={"stage": args.output})
    with open(path) as f:
        print(f.read())
    print(f"report: {path}")


if __name__ == "__main__":
    main()
