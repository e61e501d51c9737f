"""Randomized formant speech synthesizer for test/demo corpora (the port's
own copy of the JAX package's ``data/synth_speech.py``).

The environment ships no real speech corpus, and the reference's own
fake-data fixtures (reference: dataset/utility_functions.py:363-374
`gen_dummy_waveforms`) are plain noise — useless for intelligibility
metrics. This module synthesizes *speech-like* utterances the
source-filter way: a jittered glottal pulse train (voiced) or shaped
noise (fricatives) driven through per-syllable formant resonators with
a syllabic energy envelope. The band-wise temporal modulations this
produces are exactly what STOI/ESTOI correlate and what PESQ's Bark
loudness pipeline weighs, so clean-vs-degraded scores become
discriminative on corpora built from it (a pink-noise corpus pins
ESTOI at ~0.05 even for clean-vs-noisy).
"""

from __future__ import annotations

import numpy as np
from scipy.signal import lfilter

# (F1, F2, F3) vowel targets in Hz (adult neutral averages); F4 is added
# as a fixed high resonance. Values are the classic Peterson-Barney
# style vowel-triangle anchors.
_VOWELS = np.array([
    [730.0, 1090.0, 2440.0],   # /a/
    [530.0, 1840.0, 2480.0],   # /e/
    [270.0, 2290.0, 3010.0],   # /i/
    [570.0, 840.0, 2410.0],    # /o/
    [300.0, 870.0, 2240.0],    # /u/
    [660.0, 1720.0, 2410.0],   # /ae/
    [490.0, 1350.0, 1690.0],   # /er/
])
_BANDWIDTHS = (80.0, 120.0, 160.0, 250.0)
_F4 = 3400.0


def _resonator_bank(x: np.ndarray, formants, fs: int) -> np.ndarray:
    """Cascade of 2-pole resonators at the given center freqs."""
    for fc, bw in zip(formants, _BANDWIDTHS):
        r = np.exp(-np.pi * bw / fs)
        th = 2 * np.pi * fc / fs
        x = lfilter([1 - r], [1, -2 * r * np.cos(th), r * r], x)
    return x


def _glottal_train(n: int, f0: float, fs: int,
                   rng: np.random.Generator) -> np.ndarray:
    """Impulse train at f0 with slow pitch drift and cycle jitter."""
    t = np.arange(n) / fs
    drift = 1.0 + 0.06 * np.sin(2 * np.pi * rng.uniform(1.5, 3.5) * t
                                + rng.uniform(0, 2 * np.pi))
    jitter = 1.0 + 0.01 * rng.standard_normal(n)
    phase = np.cumsum(f0 * drift * jitter) / fs
    return (np.diff(np.floor(phase), prepend=0.0) > 0).astype(float)


def synth_utterance(seconds: float, fs: int = 16000,
                    rng: np.random.Generator | None = None,
                    seed: int | None = None) -> np.ndarray:
    """One randomized speech-like utterance, peak-normalized to 0.5.

    Per call: a random speaker f0 (85-250 Hz), a random syllable rate
    (2.5-5 /s), and a random vowel sequence; ~20% of syllables are
    unvoiced (fricative-like shaped noise). Segments are windowed and
    overlap-added so formant transitions read as syllables to the
    third-octave envelope analysis STOI/ESTOI perform.
    """
    if rng is None:
        rng = np.random.default_rng(seed)
    n = int(seconds * fs)
    out = np.zeros(n)
    f0 = rng.uniform(85.0, 250.0)
    syl_rate = rng.uniform(2.5, 5.0)
    syl_len = int(fs / syl_rate)
    pos = int(rng.uniform(0, 0.3) * fs)
    while pos < n - syl_len // 4:
        dur = int(syl_len * rng.uniform(0.6, 1.3))
        dur = min(dur, n - pos)
        seg_t = np.arange(dur) / fs
        if rng.random() < 0.2:
            # fricative: high-passed noise burst through a broad resonance
            src = rng.standard_normal(dur)
            src = np.diff(src, prepend=0.0)
            fc = rng.uniform(2500.0, 6000.0)
            r = np.exp(-np.pi * 900.0 / fs)
            th = 2 * np.pi * min(fc, fs * 0.45) / fs
            seg = lfilter([1 - r], [1, -2 * r * np.cos(th), r * r], src)
            seg *= 0.35
        else:
            vowel = _VOWELS[rng.integers(len(_VOWELS))]
            # per-token formant scatter (speaker/coarticulation variety)
            formants = np.append(vowel * rng.uniform(0.92, 1.08, 3), _F4)
            src = _glottal_train(dur, f0 * rng.uniform(0.9, 1.1), fs, rng)
            seg = _resonator_bank(src, formants, fs)
        # raised-cosine syllable energy envelope
        env = 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(dur) / max(dur, 1))
        env = env ** rng.uniform(0.7, 1.5)
        amp = rng.uniform(0.5, 1.0)
        rms = np.sqrt(np.mean(seg**2)) + 1e-12
        out[pos:pos + dur] += seg * env * (amp / rms)
        # inter-syllable gap (sometimes none: connected speech)
        pos += dur + int(syl_len * rng.uniform(0.0, 0.5))
        del seg_t
    peak = np.max(np.abs(out))
    if peak < 1e-9:   # pathological draw: retry deterministically
        return synth_utterance(seconds, fs, rng)
    return 0.5 * out / peak


def synth_noise(seconds: float, fs: int = 16000, kind: int = 0,
                rng: np.random.Generator | None = None,
                seed: int | None = None) -> np.ndarray:
    """Noise for mixing corpora: 0=stationary white, 1=babble-ish
    lowpassed, 2=impulsive clicks over a noise floor."""
    if rng is None:
        rng = np.random.default_rng(seed)
    n = int(seconds * fs)
    if kind % 3 == 0:
        x = rng.standard_normal(n)
    elif kind % 3 == 1:
        x = np.convolve(rng.standard_normal(n), np.ones(8) / 8, "same")
    else:
        x = rng.standard_normal(n) * (rng.random(n) > 0.98)
        x = np.convolve(x, np.hanning(64), "same") \
            + 0.1 * rng.standard_normal(n)
    return 0.5 * x / np.max(np.abs(x))
