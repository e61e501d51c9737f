"""The one traffic generator: utterances and training clips cut from a
corpus of multichannel wavs, by the parameters of a workload file and
the seed.

Serving: the seed draws each utterance's length, uniform over the
workload's range, and the audio it is cut from; the client batches them
in the order drawn. Training: every seed gets the same clips' sizes; the
seed picks the audio, each clip's circular shift and its gain.
"""

from __future__ import annotations

import wave
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np


def _read(path: Path) -> np.ndarray:
    """A 16-bit PCM wav -> float32 (channels, N) in [-1, 1)."""
    with wave.open(str(path), "rb") as w:
        if w.getsampwidth() != 2:
            raise ValueError(f"{path}: 16-bit PCM expected")
        ch, n = w.getnchannels(), w.getnframes()
        data = np.frombuffer(w.readframes(n), dtype="<i2")
    return (data.reshape(n, ch).T.astype(np.float32) / 32768.0)


def load_corpus(root: Path, mics: int, sr: int) -> Dict[str, np.ndarray]:
    """{"noisy": (items, mics, N), "clean": (items, N)} of the corpus's
    ``noisy/`` and ``clean/`` wavs, in name order, all of one length."""
    names = sorted(p.name for p in (root / "noisy").glob("*.wav"))
    if not names:
        raise FileNotFoundError(f"no wavs under {root / 'noisy'}")
    noisy, clean = [], []
    for name in names:
        with wave.open(str(root / "noisy" / name), "rb") as w:
            if w.getframerate() != sr:
                raise ValueError(f"{name}: {w.getframerate()} Hz, not {sr}")
        x = _read(root / "noisy" / name)
        if x.shape[0] < mics:
            raise ValueError(f"{name}: {x.shape[0]} channels, {mics} needed")
        noisy.append(x[:mics])
        clean.append(_read(root / "clean" / name)[0])
    return {"noisy": np.stack(noisy), "clean": np.stack(clean)}


def serve_ring(corpus: Dict, traffic: Dict, sr: int, seed: int
               ) -> List[List[np.ndarray]]:
    """The ring of serving batches: ``ring_batches`` lists of ``batch``
    (mics, n) float32 utterances, in the order drawn. Each length is
    uniform over [min_seconds, max_seconds] and each utterance is cut
    from the corpus's items joined end to end (and wrapped round) at a
    uniform start, both from the seed; views, not copies."""
    rng = np.random.default_rng(int(seed) & 0xFFFF_FFFF_FFFF_FFFF)
    n = traffic["ring_batches"] * traffic["batch"]
    lengths = np.round(rng.uniform(traffic["min_seconds"],
                                   traffic["max_seconds"], size=n)
                       * sr).astype(np.int64)
    joined = np.concatenate(list(corpus["noisy"]), axis=-1)
    total = joined.shape[-1]
    joined = np.concatenate([joined, joined[:, :int(lengths.max())]], -1)
    starts = rng.integers(0, total, size=n)
    cut = [joined[:, s:s + m] for s, m in zip(starts, lengths)]
    b = traffic["batch"]
    return [cut[i:i + b] for i in range(0, n, b)]


def padded_length(lengths, fft_num: int, bucket: int) -> int:
    """The length the program pads a batch to: the longest item plus a
    zero tail of fft_num / 2 + 1 samples, up to a whole bucket."""
    return -(-(max(lengths) + fft_num // 2 + 1) // bucket) * bucket


def train_ring(corpus: Dict, traffic: Dict, sr: int, seed: int
               ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """``ring_batches`` (noisy (B, mics, N), clean (B, N)) float32 pairs:
    each row an item of the corpus (a seeded order over all items, round
    and round), circularly shifted by a seeded offset and scaled by a
    seeded gain in dB, the same for its noisy and clean sides."""
    rng = np.random.default_rng(int(seed) & 0xFFFF_FFFF_FFFF_FFFF)
    items = corpus["noisy"].shape[0]
    n = int(round(traffic["clip_seconds"] * sr))
    if n > corpus["noisy"].shape[-1]:
        raise ValueError("clip_seconds is longer than the corpus's items")
    rows = traffic["ring_batches"] * traffic["batch"]
    order = np.concatenate([rng.permutation(items)
                            for _ in range(-(-rows // items))])[:rows]
    shifts = rng.integers(0, corpus["noisy"].shape[-1], size=rows)
    lo, hi = traffic["gain_db"]
    gains = (10.0 ** (rng.uniform(lo, hi, size=rows) / 20.0)).astype(
        np.float32)
    noisy = np.stack([np.roll(corpus["noisy"][i], -s, axis=-1)[:, :n] * g
                      for i, s, g in zip(order, shifts, gains)])
    clean = np.stack([np.roll(corpus["clean"][i], -s)[:n] * g
                      for i, s, g in zip(order, shifts, gains)])
    b = traffic["batch"]
    return [(noisy[i:i + b], clean[i:i + b]) for i in range(0, rows, b)]
