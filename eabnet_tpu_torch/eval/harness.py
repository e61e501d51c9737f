"""Batch evaluation harness — the analog of the reference's test.py.

Scores a model over a validation set: forward -> iSTFT -> per-utterance
metric battery (PESQ wb/nb when available, STOI, ESTOI, SI-SDR/SIR/SAR) ->
per-file CSV + "metric: mean ± std" txt report
(reference: test.py:126-153, 155-212).

The port's own copy of the JAX package's ``eval/harness.py``: host code in
numpy, whatever device the enhancer runs on; ``tests/test_torch_eval.py``
holds the two equal.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np

from eabnet_tpu_torch.eval.metrics import (
    MetricAccumulator,
    energy_ratios,
    log_spectral_distance,
    mean_std,
    seg_snr,
    si_sdr,
)
from eabnet_tpu_torch.eval.pesq import pesq
from eabnet_tpu_torch.eval.stoi import stoi

METRICS = ("pesq", "nb_pesq", "stoi", "estoi", "si_sdr", "si_sir",
           "si_sar", "seg_snr", "lsd")


def _align(*audios: np.ndarray) -> Tuple[np.ndarray, ...]:
    """Zero-pad all signals to the longest (reference: test.py:129-137)."""
    maxlen = max(a.shape[0] for a in audios)
    out = []
    for a in audios:
        if a.shape[0] != maxlen:
            b = np.zeros((maxlen,) + a.shape[1:], a.dtype)
            b[: a.shape[0]] = a
            a = b
        out.append(a)
    return tuple(out)


def cal_single_metrics(
    gt: np.ndarray, noisy: Optional[np.ndarray], esti: np.ndarray,
    sr: int = 16000
) -> Dict[str, Optional[float]]:
    """Score one utterance (reference: test.py:126-153). ``noisy`` is the
    reference-mic mixture used to derive the noise component; pass None
    when no mixture exists (dir-of-wavs scoring of third-party output) —
    SI-SDR then falls back to the direct definition and the SI-SIR/SAR
    decomposition is omitted."""
    if noisy is None:
        gt, esti = _align(gt, esti)
    else:
        gt, noisy, esti = _align(gt, noisy, esti)
    ret: Dict[str, Optional[float]] = {}
    try:
        ret["pesq"] = pesq(sr, gt, esti, "wb")
        ret["nb_pesq"] = pesq(sr, gt, esti, "nb")
    except ValueError:
        # clip too short / silent for P.862; all other metrics still score
        ret["pesq"] = None
        ret["nb_pesq"] = None
    ret["stoi"] = stoi(gt, esti, sr, extended=False)
    ret["estoi"] = stoi(gt, esti, sr, extended=True)
    if noisy is None:
        ret["si_sdr"] = si_sdr(gt, esti)
    else:
        sdr, sir, sar = energy_ratios(esti, gt, noisy - gt)
        ret["si_sdr"], ret["si_sir"], ret["si_sar"] = sdr, sir, sar
    ret["seg_snr"] = seg_snr(gt, esti, sr)
    ret["lsd"] = log_spectral_distance(gt, esti)
    return ret


def evaluate_dataset(
    enhance_fn: Callable[[np.ndarray], np.ndarray],
    items: Iterable[Tuple[np.ndarray, np.ndarray]],
    sr: int = 16000,
    names: Optional[Iterable[str]] = None,
) -> Tuple[MetricAccumulator, list]:
    """Run ``enhance_fn`` (noisy (M, N) -> esti (N,)) over (noisy, clean)
    pairs; returns the metric accumulator + per-file rows."""
    acc = MetricAccumulator(METRICS)
    rows = []
    names = list(names) if names is not None else None
    for i, (noisy, clean) in enumerate(items):
        esti = np.asarray(enhance_fn(noisy))
        scores = cal_single_metrics(clean, noisy[0], esti, sr)
        acc.update(scores)
        row = {"filename": names[i] if names else f"{i:05d}"}
        row.update(
            {k: (np.nan if v is None else v) for k, v in scores.items()}
        )
        rows.append(row)
    return acc, rows


def write_report(acc: MetricAccumulator, rows: list, out_prefix: str,
                 extra: Optional[Dict[str, str]] = None) -> str:
    """CSV of per-file scores + `mean ± std` txt summary
    (reference: test.py:202-212). ``extra`` key/values (e.g. the scored
    model stage) are appended as `# key: value` comment lines so score
    files stay interpretable across config changes."""
    os.makedirs(os.path.dirname(out_prefix) or ".", exist_ok=True)
    csv_path = out_prefix + ".csv"
    txt_path = out_prefix + ".txt"
    if rows:
        keys = list(rows[0].keys())
        with open(csv_path, "w") as f:
            f.write(",".join(keys) + "\n")
            for r in rows:
                f.write(",".join(str(r[k]) for k in keys) + "\n")
    lines = []
    for metric, values in acc.metrics.items():
        vals = np.asarray(values, float)
        if len(vals) == 0 or np.all(np.isnan(vals)):
            continue
        m, s = mean_std(vals)
        lines.append(f"{metric}: {m:.2f} ± {s:.2f}")
    from eabnet_tpu_torch.eval.pesq import pesq_backend

    lines.append(f"# pesq backend: {pesq_backend()}")
    for k, v in (extra or {}).items():
        lines.append(f"# {k}: {v}")
    with open(txt_path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return txt_path
