"""Offline serving: one caller, back-to-back ``Enhancer.enhance_batch``
calls of a fixed batch of utterances (a closed loop).

Set-up draws the weights, builds the Enhancer through its normal
loading path, cuts the ring of batches from the corpus and warms up
every padded length the ring holds. The window then calls the Enhancer
on the ring's batches in turn for ``--seconds`` (the traced run: for the
workload's ``trace_calls`` calls at most, after as many calls on the
same batches untraced, timed for the call's own time), each call timed
on the host clock from handing over the list of wavs to getting back the
trimmed outputs. Once the window has closed the outputs of a seeded sample of
calls (and of the call that held the longest utterance) are held against
the plain reference, run on the same padded batches.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from benchmark import harness, traffic, weights
from benchmark.reference import dsp
from benchmark.reference.model import Composed, set_rounding
from benchmark.reference.precision import ROUNDINGS, float32_products
from benchmark.trace import Window


def setup(cell: harness.Cell, seed: int, device):
    """-> (Enhancer, reference model, ring of batches)."""
    from eabnet_tpu_torch.config import ExperimentConfig
    from eabnet_tpu_torch.inference import Enhancer

    cfg, tr = cell.config, cell.workload["traffic"]
    exp = ExperimentConfig.from_dict({"model": cfg["model"],
                                      "stft": cfg["stft"]})
    ref = Composed(cfg["model"])
    drawn = weights.draw(ref, seed, device)
    enh = Enhancer(exp, weights.jax_tree(ref, drawn),
                   bucket_seconds=tr["bucket_seconds"],
                   compute_dtype=cfg["serve_dtype"], device=str(device))
    sr = cfg["stft"]["sr"]
    corpus = traffic.load_corpus(cell.root / tr["corpus"],
                                 cfg["model"]["eabnet"]["M"], sr)
    ring = traffic.serve_ring(corpus, tr, sr, seed)
    return enh, ref, ring


def _padded(cell, batch) -> int:
    stft = cell.config["stft"]
    return traffic.padded_length(
        [w.shape[-1] for w in batch], stft["fft_num"],
        int(cell.workload["traffic"]["bucket_seconds"] * stft["sr"]))


def reference_outputs(cell, ref, batch, device, rounding=None
                      ) -> List[np.ndarray]:
    """The reference's trimmed outputs of one batch, padded as the
    program pads it, in float32 (``rounding``: a control's precision)."""
    stft = cell.config["stft"]
    n = _padded(cell, batch)
    x = np.stack([np.pad(w, ((0, 0), (0, n - w.shape[-1]))) for w in batch])
    set_rounding(ref, ROUNDINGS[rounding] if rounding else (lambda v: v))
    with torch.no_grad(), float32_products():
        out = ref(dsp.features(torch.from_numpy(x).to(device), stft))
        wav = dsp.to_wav(out["esti"], stft).cpu().numpy()
    set_rounding(ref, lambda v: v)
    return [wav[i, :w.shape[-1]] for i, w in enumerate(batch)]


def wav_error(got: List[np.ndarray], want: List[np.ndarray]) -> float:
    """The worst item's RMS of (got - want) over the RMS of want; inf
    for an item of another length or with a non-finite sample."""
    worst = 0.0
    for g, w in zip(got, want):
        if g.shape != w.shape or not np.all(np.isfinite(g)):
            return float("inf")
        d = np.sqrt(np.mean((g.astype(np.float64) - w) ** 2))
        worst = max(worst, float(d / max(np.sqrt(np.mean(
            w.astype(np.float64) ** 2)), 1e-30)))
    return worst


def sample_calls(calls: List[Dict], n: int, seed: int) -> List[int]:
    """Indices of ``n`` calls of the window drawn from the seed, and of
    the first call that held the longest utterance."""
    rng = np.random.default_rng((int(seed) + 1) & 0xFFFF_FFFF_FFFF_FFFF)
    picked = set(rng.choice(len(calls), size=min(n, len(calls)),
                            replace=False).tolist())
    picked.add(max(range(len(calls)), key=lambda i: calls[i]["longest"]))
    return sorted(picked)


def end_to_end(calls: List[Dict], window_s: float, setup_s: float) -> Dict:
    """The seconds of the items' own audio finished per second of the
    window, the 95th percentile of every call's time, the set-up time."""
    return {
        "audio_s_per_s": harness.metric(
            sum(c["audio_s"] for c in calls) / window_s, "s/s"),
        "call_ms_p95": harness.metric(
            harness.quantile([c["ms"] for c in calls], 0.95), "ms"),
        "setup_s": harness.metric(setup_s, "s")}


def run(cell: harness.Cell, seed: int, seconds: float, trace: bool,
        device="cuda"):
    """One run: -> (result line without its checks, the checks, the
    forbidden modules found once the window closed)."""
    wl = cell.workload
    stft = cell.config["stft"]
    hop = int(stft["win_shift"] * stft["sr"])
    enh, ref, ring = setup(cell, seed, device)
    warmed = set()
    for batch in ring:  # every padded length the window can meet
        n = _padded(cell, batch)
        if n not in warmed:
            enh.enhance_batch(batch)
            warmed.add(n)
    harness.sync(device)
    setup_s = harness.process_seconds()
    plain_s = None
    if trace:  # the traced calls' batches, untraced, for the call's time
        t0 = time.perf_counter()
        for k in range(wl["trace_calls"]):
            enh.enhance_batch(ring[k % len(ring)])
        plain_s = (time.perf_counter() - t0) / wl["trace_calls"]
    calls, outs = [], []
    with Window(trace, device) as w:
        deadline = time.perf_counter() + seconds
        while time.perf_counter() < deadline and not (
                trace and len(calls) >= wl["trace_calls"]):
            k = len(calls) % len(ring)
            batch = ring[k]
            t0 = time.perf_counter()
            out = enh.enhance_batch(batch)
            t1 = time.perf_counter()
            outs.append(out)
            lengths = [x.shape[-1] for x in batch]
            calls.append({"ring": k, "ms": 1e3 * (t1 - t0),
                          "rows": len(batch),
                          "frames": 1 + _padded(cell, batch) // hop,
                          "useful_frames": sum(1 + n // hop
                                               for n in lengths),
                          "audio_s": sum(lengths) / stft["sr"],
                          "longest": max(lengths)})
    found = harness.forbidden_modules()
    result = {"attempted": sum(c["rows"] for c in calls)}
    if torch.device(device).type == "cuda":
        result["device"] = harness.device_description(cell.chips)
    del enh
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    failed = sum(1 for out, c in zip(outs, calls)
                 for o, x in zip(out, ring[c["ring"]])
                 if o.shape != (x.shape[-1],) or not np.all(np.isfinite(o)))
    err = 0.0
    for i in sample_calls(calls, wl["check"]["calls"], seed):
        want = reference_outputs(cell, ref, ring[calls[i]["ring"]], device)
        err = max(err, wav_error(outs[i], want))
    checks = [harness.Check("wav_err", err, wl["limits"]["wav_err"]),
              harness.Check("answers_failed", float(failed), 0.0)]
    result["failed"] = failed
    if trace:
        harness.traced(result, cell, harness.Context(
            w.trace, calls, cell.config, cell.config["serve_dtype"],
            plain_s))
    else:
        result["metrics"] = end_to_end(calls, w.seconds, setup_s)
    result["correct"] = all(c.ok for c in checks) and not found
    return result, checks, found
