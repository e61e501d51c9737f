"""First-party PESQ — full ITU-T P.862 algorithm pipeline in NumPy.

The reference repo scores PESQ-wb/nb through the `pesq` PyPI wrapper around
the ITU reference C implementation (reference: metrics.py:101-108,
test.py:140-141). That package (and the ITU sources) are not available in
this image, so this module implements the complete P.862 pipeline
first-party:

  1. level alignment to a fixed internal power (``fix_power_level``),
  2. receive-characteristic input filtering (IRS-style for narrowband,
     the P.862.2 high-pass biquad for wideband),
  3. time alignment: envelope VAD, crude FFT cross-correlation, utterance
     segmentation, per-utterance fine alignment via a weighted
     delay histogram of frame-wise phase-weighted cross-correlations,
  4. the psychoacoustic model: 32 ms Hann frames, Bark-warped pitch power
     densities, partial frequency-response compensation, smoothed partial
     gain compensation, Zwicker-law loudness, masked (center-clipped)
     disturbance, asymmetric disturbance weighting,
  5. bad-interval re-alignment of high-disturbance frames,
  6. L_p aggregation over Bark bands / 20-frame syllables / time, and the
     final ``4.5 - 0.1 D - 0.0309 DA`` raw score,
  7. MOS-LQO mapping (P.862.1 narrowband / P.862.2 wideband logistic maps).

Conformance note (honest): steps 1-7 follow the published P.862 algorithm
and use the ITU calibration constants (Sp/Sl, D/A weights, clip points,
aggregation powers). The *numeric band tables* (Bark band edges, absolute
hearing thresholds, band-power corrections) are NOT transcribed from the
ITU sources — they are derived here from the published psychoacoustic
formulas (Zwicker-Terhardt frequency warping, Terhardt threshold-in-quiet
curve). Scores therefore track ITU PESQ closely in rank and range but are
not digit-for-digit P.862-conformant.

Quantified deviation bound vs ITU PESQ (certified wherever the
ITU-wrapped `pesq` package is importable — the JAX package's
tests/test_pesq.py cross-checks auto-run there and the suite FAILS if
these are exceeded):
- absolute MOS-LQO:      |ours - ITU| <= 0.35 per condition (wb and nb,
  SNR 10-30 dB speech+noise conditions);
- score DIFFERENCES:     |(ours_a - ours_b) - (ITU_a - ITU_b)| <= 0.20
  for condition pairs on the same reference — the systematic band-table
  offset largely cancels, so comparative judgements (is system A better
  than B?) track ITU more tightly than absolute scores.
In-image anchors that hold without the ITU package: the exact P.862.1 /
P.862.2 logistic MOS-LQO maps (published constants, pinned to 1e-12),
the 4.5 raw ceiling / -0.5 floor, SNR monotonicity, and the alignment
behaviors (constant-delay invariance; piecewise delay recovery via the
recursive split aligner). `eabnet_tpu_torch.eval.pesq` automatically
prefers the ITU backend when importable; golden regression vectors for this
implementation are pinned in the JAX package's tests/test_pesq.py.

The port's own copy of the JAX package's ``eval/p862.py`` (numpy and scipy
only); ``tests/test_torch_eval.py`` holds the two equal.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

# ----------------------------------------------------------------- constants
# ITU P.862 calibration constants (pesqpar.h equivalents).
DATAPADDING_MSECS = 320
SEARCHBUFFER = 75          # in coarse (Downsample) blocks
MINSPEECHLGTH = 4          # min utterance length, coarse blocks
JOINSPEECHLGTH = 50        # gaps shorter than this join utterances
TARGET_AVG_POWER = 1e7

D_POW_F, D_POW_S, D_POW_T = 2.0, 6.0, 2.0
A_POW_F, A_POW_S, A_POW_T = 1.0, 6.0, 2.0
D_WEIGHT, A_WEIGHT = 0.1, 0.0309
FRAMES_PER_SYLLABLE = 20
THRESHOLD_BAD_FRAMES = 30.0
ZWICKER_POWER = 0.23
ABS_THRESH_POWER_SCALE = 1.0

# Band-pass used only to measure power for level alignment: pass 350-3250 Hz
# (piecewise-linear gain in dB over Hz).
_ALIGN_FILTER_DB = np.array([
    (0, -500), (50, -500), (100, -500), (125, -500), (160, -500),
    (200, -500), (250, -500), (300, -500), (350, 0), (400, 0),
    (500, 0), (600, 0), (630, 0), (800, 0), (1000, 0), (1250, 0),
    (1600, 0), (2000, 0), (2500, 0), (3000, 0), (3250, 0),
    (3500, -500), (4000, -500), (5000, -500), (6300, -500), (8000, -500),
], dtype=np.float64)

# IRS receive characteristic (narrowband mode input filter), piecewise
# linear in dB — the standard IRS weighting shape.
_IRS_FILTER_DB = np.array([
    (0, -200), (50, -40), (100, -20), (125, -12), (160, -6), (200, 0),
    (250, 4), (300, 6), (350, 8), (400, 10), (500, 11), (600, 12),
    (700, 12), (800, 12), (1000, 12), (1300, 12), (1600, 12), (2000, 12),
    (2500, 12), (3000, 12), (3250, 12), (3500, 4), (4000, -200),
    (5000, -200), (6300, -200), (8000, -200),
], dtype=np.float64)

# P.862.2 wideband mode input filter: one high-pass biquad
# (b0, b1, b2, a1, a2) applied forward only.
_WB_IIR_SOS = (2.6657628, -5.3315255, 2.6657628, -1.8890331, 0.89487434)


@dataclass(frozen=True)
class _ModeConfig:
    fs: int
    nb_bands: int        # Bark bands
    frame_len: int       # Nf (32 ms)
    downsample: int      # coarse block for VAD / crude align
    align_nfft: int      # fine-alignment frame
    sp: float            # pitch-power-density calibration
    sl: float            # loudness calibration


def _mode_config(fs: int) -> _ModeConfig:
    if fs == 16000:
        return _ModeConfig(16000, 49, 512, 64, 1024, 6.910853e-6,
                           1.866055e-1)
    if fs == 8000:
        return _ModeConfig(8000, 42, 256, 32, 512, 2.764344e-5,
                           1.866055e-1)
    raise ValueError(f"P.862 supports fs of 8000 or 16000, got {fs}")


# ----------------------------------------------------------- derived tables
def _bark_of_hz(f: np.ndarray) -> np.ndarray:
    """Zwicker-Terhardt critical-band rate (Bark) of frequency in Hz."""
    f = np.asarray(f, np.float64)
    return 13.0 * np.arctan(7.6e-4 * f) + 3.5 * np.arctan((f / 7500.0) ** 2)


def _hz_of_bark(z: np.ndarray) -> np.ndarray:
    """Numeric inverse of `_bark_of_hz` by bisection (monotone)."""
    z = np.asarray(z, np.float64)
    lo = np.zeros_like(z)
    hi = np.full_like(z, 22050.0)
    for _ in range(60):
        mid = 0.5 * (lo + hi)
        too_low = _bark_of_hz(mid) < z
        lo = np.where(too_low, mid, lo)
        hi = np.where(too_low, hi, mid)
    return 0.5 * (lo + hi)


def _threshold_in_quiet_db(f_hz: np.ndarray) -> np.ndarray:
    """Terhardt absolute hearing threshold (dB SPL)."""
    f = np.maximum(np.asarray(f_hz, np.float64), 20.0) / 1000.0
    return (3.64 * f ** -0.8
            - 6.5 * np.exp(-0.6 * (f - 3.3) ** 2)
            + 1e-3 * f ** 4)


@dataclass(frozen=True)
class _BandTables:
    nr_bins: np.ndarray            # (Nb,) int, FFT bins per Bark band
    bin_start: np.ndarray          # (Nb,) int, first FFT bin of each band
    centre_hz: np.ndarray          # (Nb,)
    centre_bark: np.ndarray        # (Nb,)
    width_hz: np.ndarray           # (Nb,)
    width_bark: np.ndarray         # (Nb,)
    pow_corr: np.ndarray           # (Nb,) band power correction factors
    abs_thresh_power: np.ndarray   # (Nb,) internal power units


_TABLE_CACHE: dict = {}


def _band_tables(cfg: _ModeConfig) -> _BandTables:
    """Bark binning tables derived from the published warping formulas.

    Bands are equal-width on the Bark axis between the Bark values of the
    first usable FFT bin and Nyquist, mirroring the ITU layout (42 bands at
    8 kHz, 49 at 16 kHz). Each FFT bin (excluding DC) is assigned to one
    band; empty low bands absorb their nearest bin. ``pow_corr`` normalizes
    each band's summed bin power by the band's nominal Hz width so the
    pitch power density is a density, as in P.862.
    """
    key = (cfg.fs, cfg.nb_bands, cfg.frame_len)
    if key in _TABLE_CACHE:
        return _TABLE_CACHE[key]
    n_bins = cfg.frame_len // 2          # usable rfft bins 0..n_bins-1
    df = cfg.fs / cfg.frame_len
    nyq = cfg.fs / 2.0
    z_lo = float(_bark_of_hz(np.array(df / 2.0)))
    z_hi = float(_bark_of_hz(np.array(nyq)))
    edges_bark = np.linspace(z_lo, z_hi, cfg.nb_bands + 1)
    edges_hz = _hz_of_bark(edges_bark)

    bin_freqs = np.arange(n_bins) * df   # bin 0 = DC (always excluded)
    band_of_bin = np.clip(
        np.searchsorted(edges_hz, bin_freqs, side="right") - 1,
        0, cfg.nb_bands - 1,
    )
    band_of_bin[0] = -1                  # drop DC
    nr_bins = np.zeros(cfg.nb_bands, np.int64)
    bin_start = np.zeros(cfg.nb_bands, np.int64)
    cursor = 1
    for b in range(cfg.nb_bands):
        members = np.nonzero(band_of_bin == b)[0]
        if members.size == 0:
            # narrow low band with no own bin: share the cursor bin
            bin_start[b] = min(cursor, n_bins - 1)
            nr_bins[b] = 1
        else:
            bin_start[b] = members[0]
            nr_bins[b] = members.size
            cursor = members[-1] + 1

    centre_hz = 0.5 * (edges_hz[:-1] + edges_hz[1:])
    centre_bark = 0.5 * (edges_bark[:-1] + edges_bark[1:])
    width_hz = np.diff(edges_hz)
    width_bark = np.diff(edges_bark)
    # density correction: summed bin powers cover nr_bins*df Hz; rescale to
    # the band's nominal width so unevenly-binned bands stay comparable.
    pow_corr = width_hz / (nr_bins * df)

    thresh_db = _threshold_in_quiet_db(centre_hz)
    # Internal intensity calibration: the level aligner pins active speech
    # power to TARGET_AVG_POWER; Sp maps FFT band power into the model's
    # intensity axis where these dB thresholds live.
    abs_thresh_power = (10.0 ** (thresh_db / 10.0)) * ABS_THRESH_POWER_SCALE
    t = _BandTables(nr_bins, bin_start, centre_hz, centre_bark,
                    width_hz, width_bark, pow_corr, abs_thresh_power)
    _TABLE_CACHE[key] = t
    return t


# ------------------------------------------------------------------ filters
def _apply_db_filter(x: np.ndarray, fs: int,
                     table_db: np.ndarray) -> np.ndarray:
    """FFT filter with piecewise-linear (Hz, dB) gain, P.862 apply_filter."""
    n = len(x)
    nfft = 1 << max(1, int(math.ceil(math.log2(max(n, 2)))))
    spec = np.fft.rfft(x, nfft)
    freqs = np.fft.rfftfreq(nfft, 1.0 / fs)
    gain_db = np.interp(freqs, table_db[:, 0], table_db[:, 1],
                        left=table_db[0, 1], right=table_db[-1, 1])
    spec *= 10.0 ** (gain_db / 20.0)
    return np.fft.irfft(spec, nfft)[:n]


def _apply_wb_iir_fast(x: np.ndarray) -> np.ndarray:
    """P.862.2 wideband input high-pass (single biquad, forward)."""
    from scipy.signal import lfilter

    b0, b1, b2, a1, a2 = _WB_IIR_SOS
    return lfilter([b0, b1, b2], [1.0, a1, a2], x)


# --------------------------------------------------------- level alignment
def _fix_power_level(x: np.ndarray, fs: int, n_active: int) -> np.ndarray:
    """Scale so the 350-3250 Hz band power over the active region is
    TARGET_AVG_POWER (P.862 fix_power_level)."""
    filtered = _apply_db_filter(x, fs, _ALIGN_FILTER_DB)
    seg = filtered[: n_active] if n_active > 0 else filtered
    power = float(np.mean(seg ** 2)) if len(seg) else 0.0
    if power <= 0.0:
        return x.copy()
    return x * math.sqrt(TARGET_AVG_POWER / power)

# ----------------------------------------------------------- time alignment
def _block_powers(x: np.ndarray, downsample: int) -> np.ndarray:
    n = len(x) // downsample
    if n == 0:
        return np.zeros(0)
    return np.mean(x[: n * downsample].reshape(n, downsample) ** 2, axis=1)


def _apply_vad(powers: np.ndarray) -> np.ndarray:
    """Speech-activity measure per coarse block (P.862 apply_VAD shape):
    iterative noise-floor threshold, then log(power/threshold) clipped at 0.
    """
    vad = powers.copy()
    if len(vad) == 0:
        return vad
    level_min = max(float(vad.max()) * 1e-4, 1e-20)
    vad = np.maximum(vad, level_min)
    thresh = float(vad.mean())
    # converge the threshold onto the noise floor
    for _ in range(12):
        below = vad[vad <= thresh]
        if len(below) == 0:
            break
        new_thresh = 1.001 * float(below.mean())
        if abs(new_thresh - thresh) < 1e-12:
            thresh = new_thresh
            break
        thresh = new_thresh
    margin = 3.0  # speech must exceed the noise floor by ~5 dB
    out = np.log(np.maximum(vad / (thresh * margin), 1e-20))
    return np.maximum(out, 0.0)


def _crude_align(ref_vad: np.ndarray, deg_vad: np.ndarray,
                 downsample: int) -> int:
    """Global delay estimate in samples via FFT cross-correlation of the
    VAD envelopes (P.862 crude_align)."""
    n = max(len(ref_vad), len(deg_vad))
    if n == 0:
        return 0
    nfft = 1 << int(math.ceil(math.log2(2 * n)))
    r = np.fft.rfft(ref_vad, nfft)
    d = np.fft.rfft(deg_vad, nfft)
    corr = np.fft.irfft(np.conj(r) * d, nfft)
    # lag k means deg is delayed by k blocks relative to ref
    lags = np.concatenate([np.arange(0, n), np.arange(-n, 0)])
    vals = np.concatenate([corr[:n], corr[nfft - n:]])
    if not np.any(np.isfinite(vals)) or float(np.max(vals)) <= 0:
        return 0
    return int(lags[int(np.argmax(vals))]) * downsample


@dataclass
class _Utterance:
    start_block: int      # coarse blocks, inclusive
    end_block: int        # coarse blocks, exclusive
    delay: int = 0        # samples: deg = ref shifted by +delay
    confidence: float = 0.0


def _id_utterances(ref_vad: np.ndarray) -> List[_Utterance]:
    """Speech utterances from the VAD track: active runs, gaps under
    JOINSPEECHLGTH joined, runs under MINSPEECHLGTH dropped."""
    active = ref_vad > 0.0
    utts: List[_Utterance] = []
    i, n = 0, len(active)
    while i < n:
        if not active[i]:
            i += 1
            continue
        j = i
        while j < n and active[j]:
            j += 1
        utts.append(_Utterance(i, j))
        i = j
    # join across short gaps
    joined: List[_Utterance] = []
    for u in utts:
        if joined and u.start_block - joined[-1].end_block < JOINSPEECHLGTH:
            joined[-1].end_block = u.end_block
        else:
            joined.append(u)
    joined = [u for u in joined
              if u.end_block - u.start_block >= MINSPEECHLGTH]
    if not joined and n > 0:
        joined = [_Utterance(0, n)]
    return joined


def _fine_align(ref: np.ndarray, deg: np.ndarray, start: int, stop: int,
                crude_delay: int, cfg: _ModeConfig) -> Tuple[int, float]:
    """Per-utterance fine delay via a weighted histogram of frame-wise
    phase-weighted cross-correlations (P.862 time_align shape).

    ref/deg are full padded signals; [start, stop) are ref sample bounds of
    the utterance. Returns (delay_samples, confidence in [0, 1]).
    """
    nfft = cfg.align_nfft
    window = 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(nfft) / nfft))
    hist = np.zeros(2 * nfft)
    total = 0.0
    step = nfft // 4
    for fstart in range(start, max(stop - nfft, start) + 1, step):
        r = ref[fstart: fstart + nfft]
        dstart = fstart + crude_delay
        if dstart < 0 or dstart + nfft > len(deg) or len(r) < nfft:
            continue
        d = deg[dstart: dstart + nfft]
        rw = r * window
        dw = d * window
        R = np.fft.rfft(rw)
        D = np.fft.rfft(dw)
        cross = np.conj(R) * D
        mag = np.abs(cross)
        # 0.25-power magnitude weighting (phase-transform-ish)
        w = np.where(mag > 0, mag ** -0.75, 0.0)
        corr = np.fft.irfft(cross * w, nfft)
        acorr = np.abs(corr)
        vmax = float(acorr.max())
        if vmax <= 0:
            continue
        keep = acorr > 0.99 * vmax
        contrib = acorr[keep] ** 0.125
        idx = np.nonzero(keep)[0]
        # lag k in [0, nfft): positive lags k, negative lags k-nfft
        lags = np.where(idx < nfft // 2, idx, idx - nfft)
        hist[lags + nfft] += contrib
        total += float(contrib.sum())
    if total <= 0:
        return crude_delay, 0.0
    # triangular smoothing of the delay histogram
    kw = max(nfft // 64, 1)
    tri = 1.0 - np.abs(np.arange(-kw, kw + 1)) / (kw + 1)
    smoothed = np.convolve(hist, tri / tri.sum(), mode="same")
    best = int(np.argmax(smoothed)) - nfft
    # peak sharpness of the delay histogram as alignment confidence
    confidence = float(smoothed.max() / (smoothed.sum() + 1e-20))
    return crude_delay + best, confidence


def _align(ref: np.ndarray, deg: np.ndarray,
           cfg: _ModeConfig) -> List[_Utterance]:
    """Full time-alignment: crude global delay, utterance segmentation,
    per-utterance fine delays, one level of utterance splitting when the
    two halves align with distinctly different delays."""
    ds = cfg.downsample
    ref_vad = _apply_vad(_block_powers(ref, ds))
    deg_vad = _apply_vad(_block_powers(deg, ds))
    crude = _crude_align(ref_vad, deg_vad, ds)
    utts = _id_utterances(ref_vad)

    def refine(u: _Utterance) -> None:
        # per-utterance crude alignment (P.862 utterance_locate does a
        # crude pass per utterance before fine alignment): correlate just
        # this utterance's VAD envelope against the degraded track, so a
        # per-utterance delay far outside the fine aligner's +-nfft/2
        # correction range around the *global* crude delay is still found
        seg_vad = np.zeros_like(ref_vad)
        seg_vad[u.start_block: u.end_block] = \
            ref_vad[u.start_block: u.end_block]
        uc = (_crude_align(seg_vad, deg_vad, ds)
              if np.any(seg_vad > 0.0) else crude)
        s = u.start_block * ds
        e = u.end_block * ds
        u.delay, u.confidence = _fine_align(ref, deg, s, e, uc, cfg)

    for u in utts:
        refine(u)

    # recursive utterance splitting (P.862 split_align): search several
    # split points, accept a split when both halves align confidently at
    # *different* delays, and recurse into the halves — so a degraded
    # signal whose delay changes more than once inside one utterance
    # (packet loss, clock drift) still gets piecewise-correct per-frame
    # delays. Constant-delay signals never satisfy the acceptance test,
    # so their scores are bit-identical to the unsplit path.
    def split(u: _Utterance, depth: int) -> List[_Utterance]:
        length = u.end_block - u.start_block
        if depth <= 0 or length < 2 * MINSPEECHLGTH * 4:
            return [u]
        best = None
        for frac in (0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8):
            mid = u.start_block + int(length * frac)
            if (mid - u.start_block < MINSPEECHLGTH * 4
                    or u.end_block - mid < MINSPEECHLGTH * 4):
                continue
            a = _Utterance(u.start_block, mid)
            b = _Utterance(mid, u.end_block)
            refine(a)
            refine(b)
            conf = min(a.confidence, b.confidence)
            if (abs(a.delay - b.delay) > ds
                    and conf > 1.1 * u.confidence
                    and (best is None or conf > best[0])):
                best = (conf, a, b)
        if best is None:
            return [u]
        return split(best[1], depth - 1) + split(best[2], depth - 1)

    out: List[_Utterance] = []
    for u in utts:
        out.extend(split(u, depth=3))
    return out

# ------------------------------------------------------- perceptual model
def _frame_power_spectra(x: np.ndarray, starts: np.ndarray,
                         cfg: _ModeConfig) -> np.ndarray:
    """Hann-windowed power spectra for frames at the given sample starts.

    Returns (n_frames, Nf/2) — rfft bins 0..Nf/2-1, Nyquist dropped,
    matching the P.862 short_term_fft layout.
    """
    nf = cfg.frame_len
    window = 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(nf) / nf))
    frames = np.zeros((len(starts), nf))
    for i, s in enumerate(starts):
        s = int(s)
        if 0 <= s and s + nf <= len(x):
            frames[i] = x[s: s + nf]
    spec = np.fft.rfft(frames * window, axis=-1)[:, : nf // 2]
    return (spec.real ** 2 + spec.imag ** 2)


def _freq_warp(hz_pow: np.ndarray, tab: _BandTables,
               cfg: _ModeConfig) -> np.ndarray:
    """Hz power spectra (n_frames, Nf/2) → pitch power densities
    (n_frames, Nb): band-summed, density-corrected, Sp-calibrated."""
    n_frames = hz_pow.shape[0]
    out = np.zeros((n_frames, len(tab.nr_bins)))
    for b in range(len(tab.nr_bins)):
        s, n = int(tab.bin_start[b]), int(tab.nr_bins[b])
        out[:, b] = hz_pow[:, s: s + n].sum(axis=1) * tab.pow_corr[b]
    return out * cfg.sp


def _total_audible(pitch_pow: np.ndarray, tab: _BandTables,
                   factor: float) -> np.ndarray:
    """Per-frame total power in bands that exceed factor*abs_threshold
    (P.862 total_audible; band 0 excluded)."""
    audible = np.where(
        pitch_pow[:, 1:] > factor * tab.abs_thresh_power[None, 1:],
        pitch_pow[:, 1:], 0.0)
    return audible.sum(axis=1)


def _loudness(pitch_pow: np.ndarray, tab: _BandTables,
              cfg: _ModeConfig) -> np.ndarray:
    """Zwicker-law loudness densities (P.862 intensity_warping_of)."""
    thresh = tab.abs_thresh_power[None, :]
    h = 6.0 / (tab.centre_bark + 2.0)
    h = np.minimum(np.where(tab.centre_bark < 4.0, h, 1.0), 2.0)
    zw = ZWICKER_POWER * h ** 0.15
    ratio = np.maximum(pitch_pow, 0.0) / thresh
    loud = (cfg.sl * (thresh / 0.5) ** zw[None, :]
            * ((0.5 + 0.5 * ratio) ** zw[None, :] - 1.0))
    return np.where(ratio < 1.0, 0.0, loud)


def _pseudo_lp(x: np.ndarray, p: float, width_bark: np.ndarray) -> float:
    """Weighted band norm (P.862 pseudo_Lp; band 0 excluded)."""
    w = width_bark[1:]
    h = np.abs(x[1:]) * w
    total_w = float(w.sum())
    return float((np.sum(h ** p) / total_w) ** (1.0 / p) * total_w)


def _disturbances_for_frame(ref_pp: np.ndarray, deg_pp: np.ndarray,
                            tab: _BandTables, cfg: _ModeConfig
                            ) -> Tuple[float, float, float]:
    """(D_frame, DA_frame, total_audible_ref) for one frame's pitch power
    density pair — the P.862 masked + asymmetric disturbance."""
    ref_loud = _loudness(ref_pp[None, :], tab, cfg)[0]
    deg_loud = _loudness(deg_pp[None, :], tab, cfg)[0]
    d = deg_loud - ref_loud
    m = 0.25 * np.minimum(deg_loud, ref_loud)
    d = np.where(d > m, d - m, np.where(d < -m, d + m, 0.0))

    ratio = ((deg_pp + 50.0) / (ref_pp + 50.0)) ** 1.2
    asym = np.where(ratio < 3.0, 0.0, np.minimum(ratio, 12.0))
    da = d * asym

    d_frame = _pseudo_lp(d, D_POW_F, tab.width_bark)
    da_frame = _pseudo_lp(da, A_POW_F, tab.width_bark)
    tot_ref = float(np.where(
        ref_pp[1:] > tab.abs_thresh_power[1:], ref_pp[1:], 0.0).sum())
    return d_frame, da_frame, tot_ref


def _lpq_weight(frame_dist: np.ndarray, time_weight: np.ndarray,
                power_syllable: float, power_time: float) -> float:
    """Two-stage L_p aggregation: L_ps over 20-frame syllables with 50%
    overlap, then weighted L_pt over syllables (P.862 Lpq_weight)."""
    n = len(frame_dist)
    if n == 0:
        return 0.0
    result_time = 0.0
    total_w = 0.0
    half = FRAMES_PER_SYLLABLE // 2
    for start in range(0, n, half):
        chunk = frame_dist[start: start + FRAMES_PER_SYLLABLE]
        count = FRAMES_PER_SYLLABLE
        syl = float(np.sum(chunk ** power_syllable)) / count
        syl = syl ** (1.0 / power_syllable)
        w = float(time_weight[start])
        result_time += (w * syl) ** power_time
        total_w += w ** power_time
    if total_w <= 0:
        return 0.0
    return float((result_time / total_w) ** (1.0 / power_time))


def _realign_bad_interval(ref: np.ndarray, deg: np.ndarray,
                          starts_ref: np.ndarray, delays: np.ndarray,
                          bad: np.ndarray, tab: _BandTables,
                          cfg: _ModeConfig,
                          d_frames: np.ndarray, da_frames: np.ndarray,
                          tot_ref_frames: np.ndarray) -> None:
    """P.862 bad-interval handling: for runs of frames whose disturbance
    exceeds THRESHOLD_BAD_FRAMES, search a better local delay by time-domain
    cross-correlation and keep the per-frame minimum disturbance."""
    nf = cfg.frame_len
    n = len(d_frames)
    i = 0
    while i < n:
        if not bad[i]:
            i += 1
            continue
        j = i
        while j < n and bad[j]:
            j += 1
        # search window around the interval in the degraded signal
        s_ref = int(starts_ref[i])
        e_ref = int(starts_ref[j - 1]) + nf
        base_delay = int(delays[i])
        seg_ref = ref[s_ref:e_ref]
        search = nf  # +/- one frame of extra delay
        s_deg = s_ref + base_delay - search
        e_deg = e_ref + base_delay + search
        if s_deg < 0 or e_deg > len(deg) or len(seg_ref) == 0:
            i = j
            continue
        seg_deg = deg[s_deg:e_deg]
        nfft = 1 << int(math.ceil(math.log2(len(seg_deg) + len(seg_ref))))
        R = np.fft.rfft(seg_ref, nfft)
        D = np.fft.rfft(seg_deg, nfft)
        corr = np.abs(np.fft.irfft(np.conj(R) * D, nfft))
        best = int(np.argmax(corr[: 2 * search + 1]))
        new_delay = base_delay - search + best
        if new_delay != base_delay:
            for f in range(i, j):
                s = int(starts_ref[f])
                ref_pp = _freq_warp(
                    _frame_power_spectra(ref, np.array([s]), cfg), tab, cfg
                )[0]
                deg_pp = _freq_warp(
                    _frame_power_spectra(deg, np.array([s + new_delay]),
                                         cfg), tab, cfg)[0]
                d2, da2, _t = _disturbances_for_frame(
                    ref_pp, deg_pp, tab, cfg)
                h = ((tot_ref_frames[f] + 1e5) / 1e7) ** 0.04
                d2 = min(d2 / h, 45.0)
                da2 = min(da2 / h, 45.0)
                d_frames[f] = min(d_frames[f], d2)
                da_frames[f] = min(da_frames[f], da2)
        i = j

# ----------------------------------------------------------------- pipeline
def _raw_pesq(fs: int, ref_in: np.ndarray, deg_in: np.ndarray,
              wideband: bool) -> float:
    """Raw P.862 PESQ score (pre MOS-LQO mapping)."""
    cfg = _mode_config(fs)
    tab = _band_tables(cfg)
    ds = cfg.downsample
    pad = SEARCHBUFFER * ds
    datapad = (DATAPADDING_MSECS * fs) // 1000

    ref = np.concatenate([np.zeros(pad), np.asarray(ref_in, np.float64),
                          np.zeros(pad + datapad)])
    deg = np.concatenate([np.zeros(pad), np.asarray(deg_in, np.float64),
                          np.zeros(pad + datapad)])
    n_active = len(ref) - 2 * pad

    ref = _fix_power_level(ref, fs, len(ref))
    deg = _fix_power_level(deg, fs, len(deg))
    if wideband:
        ref = _apply_wb_iir_fast(ref)
        deg = _apply_wb_iir_fast(deg)
    else:
        ref = _apply_db_filter(ref, fs, _IRS_FILTER_DB)
        deg = _apply_db_filter(deg, fs, _IRS_FILTER_DB)

    utts = _align(ref, deg, cfg)

    # ---- frame layout over the active region
    half = cfg.frame_len // 2
    n_frames = max((n_active + datapad) // half - 1, 1)
    starts_ref = pad + np.arange(n_frames) * half
    frame_block = starts_ref // ds  # coarse block of each frame start

    # per-frame delay from the covering utterance (nearest for gaps)
    delays = np.zeros(n_frames, np.int64)
    if utts:
        centers = np.array(
            [(u.start_block + u.end_block) / 2 for u in utts])
        for f in range(n_frames):
            blk = frame_block[f] - SEARCHBUFFER
            covering = [u for u in utts
                        if u.start_block <= blk < u.end_block]
            if covering:
                delays[f] = covering[0].delay
            else:
                delays[f] = utts[int(np.argmin(np.abs(centers - blk)))].delay

    # ---- pitch power densities
    ref_pp = _freq_warp(_frame_power_spectra(ref, starts_ref, cfg),
                        tab, cfg)
    deg_pp = _freq_warp(_frame_power_spectra(deg, starts_ref + delays, cfg),
                        tab, cfg)

    # ---- partial frequency-response compensation (on the reference)
    tot_ref_raw = _total_audible(ref_pp, tab, 1.0)
    not_silent = tot_ref_raw > 1e7
    if not np.any(not_silent):
        not_silent = np.ones(n_frames, bool)
    avg_ref = ref_pp[not_silent].mean(axis=0)
    avg_deg = deg_pp[not_silent].mean(axis=0)
    comp = np.clip((avg_deg + 1000.0) / (avg_ref + 1000.0), 0.01, 100.0)
    ref_pp = ref_pp * comp[None, :]

    # ---- smoothed partial gain compensation (on the degraded)
    tot_ref = _total_audible(ref_pp, tab, 1.0)
    tot_deg = _total_audible(deg_pp, tab, 1.0)
    scale = np.empty(n_frames)
    prev = 1.0
    for f in range(n_frames):
        target = (tot_ref[f] + 5e3) / (tot_deg[f] + 5e3)
        s = target if f == 0 else 0.2 * prev + 0.8 * target
        s = min(max(s, 3e-4), 5.0)
        scale[f] = s
        prev = s
    deg_pp = deg_pp * scale[:, None]

    # ---- per-frame disturbances
    d_frames = np.zeros(n_frames)
    da_frames = np.zeros(n_frames)
    tot_ref_frames = np.zeros(n_frames)
    for f in range(n_frames):
        d_frames[f], da_frames[f], tot_ref_frames[f] = \
            _disturbances_for_frame(ref_pp[f], deg_pp[f], tab, cfg)
    bad = d_frames > THRESHOLD_BAD_FRAMES
    h = ((tot_ref_frames + 1e5) / 1e7) ** 0.04
    d_frames = np.minimum(d_frames / h, 45.0)
    da_frames = np.minimum(da_frames / h, 45.0)

    # ---- bad-interval re-alignment
    if np.any(bad):
        _realign_bad_interval(ref, deg, starts_ref, delays, bad, tab, cfg,
                              d_frames, da_frames, tot_ref_frames)

    # ---- aggregation
    time_weight = np.ones(n_frames)
    d_ind = _lpq_weight(d_frames, time_weight, D_POW_S, D_POW_T)
    a_ind = _lpq_weight(da_frames, time_weight, A_POW_S, A_POW_T)
    raw = 4.5 - D_WEIGHT * d_ind - A_WEIGHT * a_ind
    return max(raw, -0.5)


def mos_lqo_nb(raw: float) -> float:
    """P.862.1 narrowband raw-PESQ → MOS-LQO logistic map."""
    return 0.999 + 4.0 / (1.0 + math.exp(-1.4945 * raw + 4.6607))


def mos_lqo_wb(raw: float) -> float:
    """P.862.2 wideband raw-PESQ → MOS-LQO logistic map."""
    return 0.999 + 4.0 / (1.0 + math.exp(-1.3669 * raw + 3.8224))


def pesq_p862(fs: int, ref: np.ndarray, deg: np.ndarray,
              mode: str = "wb") -> float:
    """First-party PESQ MOS-LQO (see module docstring for conformance).

    Mirrors the `pesq.pesq(fs, ref, deg, mode)` signature the reference
    wraps (reference: metrics.py:101-108). mode: 'wb' (P.862.2, fs=16000)
    or 'nb' (P.862 + P.862.1 map, fs 8000 or 16000).
    """
    ref = np.asarray(ref, np.float64).reshape(-1)
    deg = np.asarray(deg, np.float64).reshape(-1)
    if mode == "wb" and fs != 16000:
        raise ValueError("wb mode requires fs=16000")
    if mode not in ("wb", "nb"):
        raise ValueError(f"mode must be 'wb' or 'nb', got {mode!r}")
    if min(len(ref), len(deg)) < fs // 4:
        raise ValueError("signals must be at least 0.25 s long")
    if not (np.any(ref) and np.any(deg)):
        # all-silent input: no speech to judge; report the floor
        return mos_lqo_wb(-0.5) if mode == "wb" else mos_lqo_nb(-0.5)
    raw = _raw_pesq(fs, ref, deg, wideband=(mode == "wb"))
    return mos_lqo_wb(raw) if mode == "wb" else mos_lqo_nb(raw)
