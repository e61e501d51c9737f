"""The release eval report of the port: noisy vs esti0 vs esti, with
margins, as the repo's ``tools/release_report.py`` writes it.

Scores a release artifact (or experiment dir) on one or more offline val
sets (paired clean/ + noisy/ dirs) at every stage and writes the same
markdown: a header, one ``## <val dir> (<n> items)`` table per set with
mean ± 95 % CI for the full metric battery, and the esti − esti0 margins.
The model runs on the card unless ``--platform cpu`` is given (the JAX
tool defaults to the CPU); the metrics are host code. ``--pad-mode`` is
the Enhancer's: ``tail`` (default, the JAX Enhancer's) or ``reference``,
no zero tail, the featurization ``release/REPORT.md`` was scored with.

    python -m eabnet_tpu_torch.tools.release_report \\
        --exp-root release/composed_9mic --val release/val_set \\
        --out REPORT.md --pad-mode reference
"""

from __future__ import annotations

import argparse
import os

from eabnet_tpu_torch.tools.e2e_demo import METRICS as KEYS


def score(cfg, params, val_dir, output, device="cuda", pad_mode="tail"):
    """{metric: ((mean, std), (mean, ci))} of one stage over a val set,
    and its item count."""
    from eabnet_tpu_torch.data.datasets import OfflineMcseDataset
    from eabnet_tpu_torch.eval import evaluate_dataset
    from eabnet_tpu_torch.inference import Enhancer
    from eabnet_tpu_torch.tools.e2e_demo import val_items

    val = OfflineMcseDataset(val_dir)
    fn = (lambda n: n[0]) if output == "noisy" else Enhancer(
        cfg, params, output=output, pad_mode=pad_mode, device=device)
    acc, _ = evaluate_dataset(fn, val_items(val), sr=cfg.stft.sr)
    return {k: (acc.mean_std(k), acc.mean_ci(k)) for k in KEYS}, len(val)


def main(argv=None) -> None:
    from eabnet_tpu_torch.tools.e2e_demo import (add_platform, device_for,
                                                 restore)

    ap = argparse.ArgumentParser()
    ap.add_argument("--exp-root", required=True)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--val", action="append", required=True,
                    help="offline val dir (repeatable)")
    ap.add_argument("--out", required=True)
    add_platform(ap)
    ap.add_argument("--pad-mode", default="tail",
                    choices=["tail", "reference"],
                    help="the Enhancer's padding: tail (a zero tail of "
                    "n_fft/2 + 1 samples) or reference (none: how "
                    "release/REPORT.md was scored)")
    args = ap.parse_args(argv)
    device = device_for(args.platform)

    from eabnet_tpu_torch.config import ExperimentConfig
    from eabnet_tpu_torch.eval.pesq import pesq_backend
    from eabnet_tpu_torch.train.checkpoint import latest_checkpoint
    from eabnet_tpu_torch.weights import to_jax_params

    cfg = ExperimentConfig.load(os.path.join(args.exp_root, "config.json"))
    ckpt = args.ckpt or latest_checkpoint(
        os.path.join(args.exp_root, "ckpt")
    ) or latest_checkpoint(args.exp_root)
    state = restore(cfg, ckpt)
    params = to_jax_params(state.model)

    lines = [
        "# Release eval report",
        "",
        f"Checkpoint: `{os.path.basename(ckpt)}` "
        f"(step {int(state.step)}); "
        f"PESQ backend: {pesq_backend()}.",
        "Stages: `noisy` = unprocessed reference mic, `esti0` = bare "
        "EaBNet beamformer, `esti` = composed EaBNet->GaGNet "
        "(reference: EaBNet.py:127-155). mean ± 95 % CI.",
        "",
    ]
    for val_dir in args.val:
        rows = {}
        for stage in ("noisy", "esti0", "esti"):
            rows[stage], n = score(cfg, params, val_dir, stage, device,
                                   args.pad_mode)
            print(f"[report] {val_dir} {stage}: "
                  + " ".join(f"{k}={rows[stage][k][0][0]:.3f}"
                             for k in KEYS), flush=True)
        lines += [f"## {val_dir} ({n} items)", "",
                  "| stage | " + " | ".join(KEYS) + " |",
                  "|---|" + "---|" * len(KEYS)]
        for stage in ("noisy", "esti0", "esti"):
            cells = []
            for k in KEYS:
                (m, _), (_, ci) = rows[stage][k]
                cells.append(f"{m:.3f} ± {ci:.3f}")
            lines.append(f"| {stage} | " + " | ".join(cells) + " |")
        margins = {k: rows["esti"][k][0][0] - rows["esti0"][k][0][0]
                   for k in KEYS}
        lines += ["",
                  "esti − esti0 margins: "
                  + ", ".join(f"{k} {margins[k]:+.4f}" for k in KEYS),
                  ""]
    with open(args.out, "w") as f:
        f.write("\n".join(lines))
    print(f"[report] wrote {args.out}")


if __name__ == "__main__":
    main()
