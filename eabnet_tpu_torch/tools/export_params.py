"""Export a trained run as a compact release artifact, as the repo's
``tools/export_params.py`` does with the JAX package.

Takes an experiment dir (config.json + full ``<iter>.ckpt`` training
checkpoints) and writes ``<out>/config.json`` + ``<out>/<iter>.params``,
the params-only format (``train/checkpoint.py::save_params``, the JAX
package's bytes), one third the size of a training checkpoint (no Adam
moments). The artifact dir is a valid ``--exp-root`` for every surface of
both packages (``cli.enhance``, ``cli.test``, ``cli.stream``,
``inference.load_enhancer``); resuming training from it reinitializes the
optimizer. The checkpoint is restored on the card unless ``--platform
cpu`` is given.

    python -m eabnet_tpu_torch.tools.export_params --exp-root longrun \\
        --out release_dir/
"""

from __future__ import annotations

import argparse
import dataclasses
import os


def main(argv=None) -> str:
    from eabnet_tpu_torch.tools.e2e_demo import (add_platform, device_for,
                                                 restore)

    ap = argparse.ArgumentParser()
    ap.add_argument("--exp-root", required=True,
                    help="experiment dir with config.json + checkpoints")
    ap.add_argument("--ckpt", default=None,
                    help="explicit checkpoint (default: latest under "
                    "<exp-root>/ckpt or <exp-root>)")
    ap.add_argument("--out", required=True, help="release dir to write")
    add_platform(ap)
    args = ap.parse_args(argv)

    from eabnet_tpu_torch.config import ExperimentConfig
    from eabnet_tpu_torch.train.checkpoint import (latest_checkpoint,
                                                   save_params)

    cfg = ExperimentConfig.load(os.path.join(args.exp_root, "config.json"))
    ckpt = args.ckpt or latest_checkpoint(
        os.path.join(args.exp_root, "ckpt")
    ) or latest_checkpoint(args.exp_root)
    if ckpt is None:
        raise FileNotFoundError(f"no checkpoint under {args.exp_root}")
    state = restore(cfg, ckpt, device_for(args.platform))

    os.makedirs(args.out, exist_ok=True)
    # point the released config's checkpoint_dir at the artifact itself so
    # load_enhancer(exp_root=<out>) finds the .params file
    cfg = dataclasses.replace(
        cfg, train=dataclasses.replace(cfg.train, checkpoint_dir=".",
                                       exp_root="."))
    cfg.save(os.path.join(args.out, "config.json"))
    path = save_params(state.model, args.out, state.step)
    size = os.path.getsize(path) / 1e6
    print(f"[export] {ckpt} -> {path} ({size:.1f} MB)")
    return path


if __name__ == "__main__":
    main()
