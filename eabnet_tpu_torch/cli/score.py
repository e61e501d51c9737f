"""Dir-of-wavs scorer: rate pre-rendered enhanced wavs against clean
references, no checkpoint or dataset required.

The reference's standalone scorer (reference: test.py:50-123,
``cal_metrics``) walks three directories whose files share basenames,
resamples everything to 16 kHz, zero-pads to the longest, and runs the
metric battery. This CLI reproduces that tool for scoring *any* system's
output — including other frameworks' — through the same
``eval/harness.py`` battery the checkpoint evaluator uses:

    python -m eabnet_tpu_torch.cli.score --clean ref/ --enhanced out/ \
        [--noisy noisy/] [--out-prefix scores]

``--noisy`` adds the SI-SIR / SI-SAR decomposition (it defines the noise
component n = noisy - clean, reference test.py:79); without it the
battery still reports PESQ wb/nb, STOI, ESTOI, SI-SDR, SegSNR and LSD.
The port's copy of the JAX package's ``cli/score.py``: host code in numpy,
the same CSV and report.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, List, Optional

import numpy as np

WAV_EXTS = (".wav", ".WAV", ".flac")


def _list_wavs(root: str) -> Dict[str, str]:
    out = {}
    for name in sorted(os.listdir(root)):
        if name.endswith(WAV_EXTS):
            out[name] = os.path.join(root, name)
    return out


def _load_16k(path: str, sr_target: int) -> np.ndarray:
    from eabnet_tpu_torch.utils.audio_io import read_wav, resample

    sr, data = read_wav(path)
    if data.ndim == 2:   # multichannel file: score the first channel
        data = data[0]
    return resample(data.astype(np.float64), sr, sr_target)


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser(
        description="score a directory of enhanced wavs vs clean wavs "
        "(reference: test.py:50-123 cal_metrics)")
    parser.add_argument("--clean", required=True,
                        help="directory of clean reference wavs")
    parser.add_argument("--enhanced", required=True,
                        help="directory of enhanced/system-output wavs "
                        "(basenames must match --clean)")
    parser.add_argument("--noisy", default=None,
                        help="optional directory of unprocessed noisy "
                        "wavs; enables SI-SIR/SI-SAR")
    parser.add_argument("--sr", type=int, default=16000,
                        help="scoring sample rate (everything is "
                        "resampled to this; default 16000)")
    parser.add_argument("--out-prefix", default=None,
                        help="report path prefix (default: "
                        "<enhanced>/scores)")
    parser.add_argument("--limit", type=int, default=None,
                        help="score only the first N files")
    args = parser.parse_args(argv)

    from eabnet_tpu_torch.eval.harness import (cal_single_metrics,
                                               write_report)
    from eabnet_tpu_torch.eval.metrics import MetricAccumulator

    clean = _list_wavs(args.clean)
    enhanced = _list_wavs(args.enhanced)
    noisy = _list_wavs(args.noisy) if args.noisy else None

    names = sorted(set(clean) & set(enhanced))
    missing = sorted(set(enhanced) - set(clean))
    if missing:
        print(f"warning: {len(missing)} enhanced files have no clean "
              f"counterpart (e.g. {missing[0]}); skipped")
    if not names:
        raise SystemExit("no basename-matched (clean, enhanced) pairs")
    if args.limit is not None:
        names = names[: args.limit]

    acc = None
    rows = []
    for name in names:
        gt = _load_16k(clean[name], args.sr)
        esti = _load_16k(enhanced[name], args.sr)
        mix = (_load_16k(noisy[name], args.sr)
               if noisy is not None and name in noisy else None)
        scores = cal_single_metrics(gt, mix, esti, args.sr)
        if acc is None:
            acc = MetricAccumulator(tuple(scores.keys()))
        acc.update(scores)
        row = {"filename": name}
        row.update({k: (np.nan if v is None else v)
                    for k, v in scores.items()})
        rows.append(row)

    prefix = args.out_prefix or os.path.join(args.enhanced, "scores")
    path = write_report(acc, rows, prefix,
                        extra={"clean": args.clean,
                               "enhanced": args.enhanced,
                               "noisy": args.noisy or "(none)"})
    print(open(path).read())
    print(f"report: {path}")


if __name__ == "__main__":
    main()
