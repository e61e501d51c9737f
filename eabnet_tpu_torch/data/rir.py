"""Room impulse response engine, the port's own copy of the JAX package's
``data/rir.py`` (numpy; the same seed gives the same bits).

Replaces the reference's pyroomacoustics C++ dependency
(dataset/audio_util.py:49-88) with a self-contained shoebox image-source
model (Allen & Berkley) plus a geometrically exact late field:

- ``method='ism'``     : pure image sources up to ``max_order``;
- ``method='hybrid'``  : image sources to order 3 + a late tail shaped by
  the EXACT high-order image-source energy histogram. The reference's
  hybrid mode is ISM(3) + stochastic C++ ray tracing with air absorption
  (audio_util.py:55-63, ``pra.ShoeBox(max_order=3, ray_tracing=True,
  air_absorption=True)``). For a shoebox whose walls have no scattering
  coefficient — exactly what ``pra.Material(e_absorption)`` builds —
  specular ray tracing *converges to the image-source energy histogram*
  as the ray count grows: every specular ray path in a box unfolds to a
  straight line toward one lattice image. Computing that histogram in
  closed form (energy-only image enumeration binned at pra's 4 ms
  resolution, reflection orders > 3 only, air absorption applied) is the
  zero-variance limit of the reference's own late-field generator; the
  tail waveform is then histogram-shaped noise, the same synthesis pra
  uses for its ray-traced energy. Validated against the brute-force
  full-order ISM in tests/test_rir_hist.py.
- ``method='hybrid-sabine'``: the previous lightweight tail — white noise
  under the Polack diffuse-field envelope c/(4 pi V) 10^(-6 t / rt60).
  Kept as a fast fallback and as the A/B arm of the in-image late-tail
  conformance test.

A vectorized numpy implementation is the reference path; a C++ engine with
identical semantics (``native/rir.cpp``, bound by ``data/rir_native.py``)
is used automatically when it builds —
RIR synthesis is the dominant host-side cost of online training data
(SURVEY.md §3.1 marks it the hot CPU loop).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np

SPEED_OF_SOUND = 343.0
FDL = 81  # fractional-delay filter length (odd)

# Energy air-absorption coefficient (1/m): speech-band average of the
# ISO 9613-1 atmospheric attenuation at 20 degC / 50 % RH that
# pyroomacoustics applies per octave band when air_absorption=True (the
# reference's hybrid rooms always enable it, audio_util.py:55-63).
# 1 kHz is ~3.7 dB/km -> 8.5e-4 /m energy; 2 kHz ~9.7 dB/km -> 2.2e-3.
DEFAULT_AIR_ABSORPTION = 1.5e-3

HIST_BIN_S = 0.004  # pra's ray-tracing energy histogram resolution


def inverse_sabine(rt60: float, room_dim: Sequence[float],
                   c: float = SPEED_OF_SOUND) -> Tuple[float, int]:
    """Sabine absorption + ISM order for a target RT60.

    Mirrors pyroomacoustics' ``inverse_sabine`` so reference-compatible
    settings JSONs produce the same (absorption, order) pairs: raises
    ValueError when the room is too large for the requested RT60
    (consumed by the sampling retry loop, dataset/mcse_dataset.py:196-204).
    """
    lx, ly, lz = [float(v) for v in room_dim]
    vol = lx * ly * lz
    surf = 2.0 * (lx * ly + lx * lz + ly * lz)
    e_abs = 24.0 * math.log(10.0) * vol / (c * surf * rt60)
    if e_abs > 1.0:
        raise ValueError("room too large for the requested rt60")
    max_order = max(0, math.ceil(c * rt60 / min(lx, ly, lz) - 1.0))
    return e_abs, max_order


def _frac_delay_filter(frac: np.ndarray) -> np.ndarray:
    """Hann-windowed sinc fractional-delay filters.

    frac: (K,) fractional parts in [0, 1) -> (K, FDL) filters centered at
    FDL//2 + frac.
    """
    n = np.arange(FDL)[None, :] - FDL // 2
    t = n - frac[:, None]
    h = np.sinc(t)
    win = 0.5 * (1.0 + np.cos(2.0 * np.pi * t / FDL))
    return h * win


def _image_sources(
    src: np.ndarray, room: np.ndarray, order: int
) -> Tuple[np.ndarray, np.ndarray]:
    """All image-source positions and reflection counts up to ``order``.

    Returns (positions (K, 3), n_reflections (K,)).
    """
    per_axis = []  # per axis: (coords, reflection counts)
    for ax in range(3):
        coords, refl = [], []
        lo = -(order + 1) // 2 - 1
        hi = order // 2 + 2
        for r in range(lo, hi + 1):
            for p in (0, 1):
                n_hits = abs(r - p) + abs(r)
                if n_hits > order:
                    continue
                coords.append((1 - 2 * p) * src[ax] + 2 * r * room[ax])
                refl.append(n_hits)
        per_axis.append((np.asarray(coords), np.asarray(refl)))

    cx, rx = per_axis[0]
    cy, ry = per_axis[1]
    cz, rz = per_axis[2]
    # outer product of the three axes, pruned by total order
    total = (
        rx[:, None, None] + ry[None, :, None] + rz[None, None, :]
    )
    keep = total <= order
    ix, iy, iz = np.nonzero(keep)
    pos = np.stack([cx[ix], cy[iy], cz[iz]], axis=1)
    return pos, total[keep]


def _fibonacci_directions(n: int = 512) -> np.ndarray:
    """Deterministic quasi-uniform unit directions (N, 3)."""
    i = np.arange(n) + 0.5
    phi = np.pi * (3.0 - math.sqrt(5.0)) * i
    z = 1.0 - 2.0 * i / n
    r = np.sqrt(np.maximum(0.0, 1.0 - z * z))
    return np.stack([r * np.cos(phi), r * np.sin(phi), z], axis=1)


def ism_energy_histogram(
    room_dim: Sequence[float],
    src: Sequence[float],
    mics: np.ndarray,
    e_absorption: float,
    ism_order: int,
    t_max: float,
    air_absorption: float = DEFAULT_AIR_ABSORPTION,
    c: float = SPEED_OF_SOUND,
    bin_s: float = HIST_BIN_S,
    images_per_bin: float = 300.0,
    n_dirs: int = 512,
) -> np.ndarray:
    """Late-field energy histogram: (M, n_bins) of arriving energy per
    ``bin_s`` window from reflection orders > ``ism_order``.

    The exact limit of the reference's specular ray tracer (see module
    docstring). Two regimes, stitched at the mixing time ``t_ex`` where
    the image shell population reaches ``images_per_bin`` per bin:

    * ``t < t_ex``: exact lattice enumeration — every image source with
      order > ism_order contributes beta2^n * e^(-alpha d) / (4 pi d)^2
      to its arrival bin (per mic; keeps the true early-late structure
      and mic-position dependence).
    * ``t >= t_ex``: the lattice continuum (image density 1/V — Cremer's
      anisotropic decay): E(t) = c/(4 pi V) * e^(-alpha c t) *
      <beta2^(c t sum_i |u_i| / L_i)>_directions, evaluated with a
      deterministic Fibonacci quadrature (|u_i|/L_i = wall hits per
      meter along u; its spherical mean is the classical S/4V). This is
      the large-t limit of the same lattice sum (bins hold hundreds of
      images, so the binned sum self-averages to its expectation); the
      isotropic-exponent special case of this integral is the
      Polack/Sabine envelope of :func:`apply_diffuse_tail`.
    """
    room = np.asarray(room_dim, np.float64)
    src = np.asarray(src, np.float64)
    mics = np.atleast_2d(np.asarray(mics, np.float64))
    if mics.shape[0] == 3 and mics.shape[1] != 3:
        mics = mics.T
    m = mics.shape[0]
    vol = float(np.prod(room))
    beta2 = max(0.0, 1.0 - e_absorption)
    n_bins = max(1, int(math.ceil(t_max / bin_s)))
    hist = np.zeros((m, n_bins), np.float64)
    if beta2 <= 0.0:
        return hist

    # mixing time: image shell population per bin = 4 pi (ct)^2 c bin / V
    t_ex = math.sqrt(
        images_per_bin * vol / (4.0 * np.pi * c**3 * bin_s)
    )
    t_ex = min(t_ex, t_max)

    # ---- exact enumeration below t_ex ----
    r_ex = c * t_ex + float(np.linalg.norm(room))
    per_axis = []
    for ax in range(3):
        k = int(math.ceil(r_ex / (2.0 * room[ax]))) + 1
        r = np.arange(-k, k + 1)
        coords = np.concatenate([2 * r * room[ax] + src[ax],
                                 2 * r * room[ax] - src[ax]])
        refl = np.concatenate([2 * np.abs(r),
                               np.abs(2 * r - 1)])
        per_axis.append((coords, refl))
    cx, rx = per_axis[0]
    cy, ry = per_axis[1]
    cz, rz = per_axis[2]
    # chunk the x axis to bound the (kx, Ky, Kz) broadcast
    chunk = max(1, int(4e6 // max(1, len(cy) * len(cz))))
    for s in range(0, len(cx), chunk):
        pxc, rxc = cx[s : s + chunk], rx[s : s + chunk]
        n = (rxc[:, None, None] + ry[None, :, None]
             + rz[None, None, :])
        base_e = beta2 ** n  # (kx, Ky, Kz)
        for mi in range(m):
            d2 = (
                np.square(pxc - mics[mi, 0])[:, None, None]
                + np.square(cy - mics[mi, 1])[None, :, None]
                + np.square(cz - mics[mi, 2])[None, None, :]
            )
            d = np.sqrt(d2)
            t = d / c
            sel = (n > ism_order) & (t < t_ex)
            if not sel.any():
                continue
            ds = d[sel]
            e = base_e[sel] * np.exp(-air_absorption * ds) / (
                16.0 * np.pi**2 * np.maximum(d2[sel], 1e-6)
            )
            bins = (t[sel] / bin_s).astype(np.int64)
            hist[mi] += np.bincount(bins, weights=e, minlength=n_bins)

    # ---- lattice continuum beyond t_ex ----
    if t_ex < t_max:
        u = np.abs(_fibonacci_directions(n_dirs))  # (N, 3)
        rate = (u / room[None, :]).sum(axis=1)  # (N,) wall hits per m
        tb = (np.arange(n_bins) + 0.5) * bin_s
        late = tb >= t_ex
        ctb = c * tb[late]
        a_t = np.mean(
            np.power(beta2, ctb[:, None] * rate[None, :]), axis=1
        )
        e_t = (c * bin_s / (4.0 * np.pi * vol)) * np.exp(
            -air_absorption * ctb
        ) * a_t
        hist[:, late] += e_t[None, :]
    return hist


def resolve_rir_method(
    method: str,
    max_order: int,
    rt60: Optional[float],
    air_absorption: Optional[float],
) -> tuple:
    """Shared method-dispatch policy for the numpy and native ISM paths
    -> ``(ism_order, air_absorption, hybrid_hist)``.

    One function so the two backends cannot desynchronize: 'hybrid'
    (with an rt60) caps the ISM at order 3 and defaults air absorption
    on (the reference's pra.ShoeBox(max_order=3, air_absorption=True,
    ray_tracing=True), audio_util.py:55-63); 'hybrid-sabine' likewise
    caps the ISM (its tail comes from the Polack envelope instead);
    'ism' is the pure image-source model at the requested order.
    Unknown names raise instead of silently degrading to pure ISM.
    """
    if method not in ("ism", "hybrid", "hybrid-sabine"):
        raise ValueError(
            f"unknown rir method {method!r}; expected 'ism', 'hybrid' "
            "or 'hybrid-sabine'")
    hybrid_hist = method == "hybrid" and rt60 is not None
    if hybrid_hist:
        ism_order = 3
    elif method in ("hybrid", "hybrid-sabine"):
        ism_order = min(max_order, 3)
    else:
        ism_order = max_order
    if air_absorption is None:
        air_absorption = DEFAULT_AIR_ABSORPTION if hybrid_hist else 0.0
    return ism_order, air_absorption, hybrid_hist


def histogram_tail(
    hist: np.ndarray,
    fs: int,
    rng: Optional[np.random.Generator],
    bin_s: float = HIST_BIN_S,
) -> np.ndarray:
    """Synthesize the late-field waveform from an energy histogram:
    per-bin white noise carrying exactly the bin's energy — the same
    noise-carrier synthesis pyroomacoustics applies to its ray-traced
    histogram."""
    if rng is None:
        rng = np.random.default_rng(0)
    m, n_bins = hist.shape
    true_spb = bin_s * fs
    amp_b = np.sqrt(np.maximum(hist, 0.0))
    if abs(true_spb - round(true_spb)) < 1e-9:
        # integral samples per bin (16 kHz: exactly 64) — vectorized
        spb = max(1, int(round(true_spb)))
        length = n_bins * spb
        g = rng.standard_normal((m, length))
        # normalize each bin's noise to unit energy, then scale to E_bin
        gb = g.reshape(m, n_bins, spb)
        norm = np.sqrt(np.sum(gb**2, axis=2, keepdims=True))
        norm = np.maximum(norm, 1e-12)
        return (gb / norm * amp_b[:, :, None]).reshape(
            m, length).astype(np.float32)
    # non-integral (e.g. 44.1 kHz: 176.4): place every bin at its TRUE
    # sample offset so the tail's timeline cannot drift vs the
    # histogram's bin times (a fixed rounded width would compress the
    # tail by the accumulated rounding over hundreds of bins)
    edges = np.round(np.arange(n_bins + 1) * true_spb).astype(np.int64)
    length = int(edges[-1])
    g = rng.standard_normal((m, length))
    out = np.empty((m, length), np.float32)
    for b in range(n_bins):
        seg = g[:, edges[b]:edges[b + 1]]
        norm = np.maximum(
            np.sqrt(np.sum(seg**2, axis=1, keepdims=True)), 1e-12)
        out[:, edges[b]:edges[b + 1]] = seg / norm * amp_b[:, b:b + 1]
    return out


def ism_image_params(
    room_dim: Sequence[float],
    src: Sequence[float],
    mics: np.ndarray,
    e_absorption: float,
    ism_order: int,
    fs: int,
    air_absorption: float = 0.0,
    c: float = SPEED_OF_SOUND,
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-(mic, image) fractional delays and amplitudes of the truncated
    ISM -> (delays (M, K) samples, amps (M, K)), both float64.

    The K image count depends only on ``ism_order`` (the image lattice is
    geometry-independent), so batches of scenes share a static K — the
    device-side scene synthesis (data/scene_mix.py) ships exactly these
    two arrays instead of dense RIRs.
    """
    room = np.asarray(room_dim, np.float64)
    src = np.asarray(src, np.float64)
    mics = np.atleast_2d(np.asarray(mics, np.float64))
    if mics.shape[0] == 3 and mics.shape[1] != 3:
        mics = mics.T
    beta = math.sqrt(max(0.0, 1.0 - e_absorption))
    pos, n_refl = _image_sources(src, room, ism_order)
    damp = beta ** n_refl  # (K,)
    d = np.linalg.norm(pos[None, :, :] - mics[:, None, :], axis=2)
    d = np.maximum(d, 1e-3)  # (M, K)
    amps = damp[None, :] / (4.0 * np.pi * d)
    if air_absorption > 0.0:
        amps = amps * np.exp(-0.5 * air_absorption * d)
    return d * fs / c, amps


def ism_early_rir(
    room_dim: Sequence[float],
    src: Sequence[float],
    mics: np.ndarray,
    e_absorption: float,
    ism_order: int,
    fs: int,
    air_absorption: float = 0.0,
    c: float = SPEED_OF_SOUND,
) -> Tuple[np.ndarray, float]:
    """Dense truncated-ISM RIR -> ((M, L) float32, max image distance m).

    The early half of every method of :func:`shoebox_rir`; factored out
    so the device-side reconstruction (data/scene_mix.py) can be parity-
    tested against the exact host construction.
    """
    mics = np.atleast_2d(np.asarray(mics, np.float64))
    if mics.shape[0] == 3 and mics.shape[1] != 3:
        mics = mics.T
    delays, amps = ism_image_params(
        room_dim, src, mics, e_absorption, ism_order, fs,
        air_absorption=air_absorption, c=c,
    )
    m = mics.shape[0]
    rirs = []
    for mi in range(m):
        base = np.floor(delays[mi]).astype(np.int64)
        frac = delays[mi] - base
        filt = _frac_delay_filter(frac) * amps[mi][:, None]
        length = int(base.max()) + FDL
        # scatter-add all filters at once via bincount on a left-padded
        # buffer (offset FDL//2 keeps all indices non-negative)
        idx = (base[:, None] + np.arange(FDL)[None, :]).ravel()
        h_pad = np.bincount(
            idx, weights=filt.ravel(), minlength=length + FDL // 2
        )
        rirs.append(h_pad[FDL // 2 :])
    length = max(len(h) for h in rirs)
    out = np.zeros((m, length), np.float32)
    for mi, h in enumerate(rirs):
        out[mi, : len(h)] = h
    max_dist = float(delays.max()) * c / fs
    return out, max_dist


def shoebox_rir(
    room_dim: Sequence[float],
    src: Sequence[float],
    mics: np.ndarray,
    e_absorption: float,
    max_order: int,
    fs: int,
    method: str = "ism",
    rt60: Optional[float] = None,
    rng: Optional[np.random.Generator] = None,
    c: float = SPEED_OF_SOUND,
    air_absorption: Optional[float] = None,
) -> np.ndarray:
    """RIRs from one source to ``mics (M, 3)`` -> (M, L) float32.

    method='hybrid' runs the ISM at order 3 and adds the late field from
    the exact image-source energy histogram — the reference's hybrid
    semantics (ISM(3) + specular ray tracing + air absorption,
    audio_util.py:55-63) in closed form; ``rt60`` bounds the tail length.
    method='hybrid-sabine' appends the lightweight Polack-envelope noise
    tail instead. ``air_absorption`` (energy, 1/m) defaults to the
    speech-band ISO 9613-1 average for 'hybrid' (the reference always
    enables air absorption in hybrid rooms) and 0 otherwise.
    """
    room = np.asarray(room_dim, np.float64)
    src = np.asarray(src, np.float64)
    mics = np.atleast_2d(np.asarray(mics, np.float64))
    if mics.shape[0] == 3 and mics.shape[1] != 3:
        mics = mics.T  # accept (3, M)

    ism_order, air_absorption, hybrid_hist = resolve_rir_method(
        method, max_order, rt60, air_absorption)
    out, max_dist = ism_early_rir(
        room, src, mics, e_absorption, ism_order, fs,
        air_absorption=air_absorption, c=c,
    )

    if hybrid_hist:
        out = add_histogram_tail(out, room, src, mics, e_absorption,
                                 ism_order, rt60, fs, rng, c,
                                 air_absorption)
    elif method == "hybrid-sabine" and rt60 is not None and max_order > 3:
        out = apply_diffuse_tail(out, max_dist, rt60, fs, rng, c,
                                 volume=float(np.prod(room)))
    return out


def add_histogram_tail(
    out: np.ndarray,
    room: np.ndarray,
    src: np.ndarray,
    mics: np.ndarray,
    e_absorption: float,
    ism_order: int,
    rt60: float,
    fs: int,
    rng: Optional[np.random.Generator],
    c: float = SPEED_OF_SOUND,
    air_absorption: float = DEFAULT_AIR_ABSORPTION,
) -> np.ndarray:
    """Overlay the exact-histogram late field onto the truncated ISM.

    Tail length: 1.25 * rt60 (-75 dB under the Sabine envelope), capped
    at 2 s — beyond that the tail is below any trainable signal level
    for the data envelope (RT60 0.05-0.7 s, mcse settings)."""
    t_max = min(max(1.25 * float(rt60), HIST_BIN_S), 2.0)
    hist = ism_energy_histogram(
        room, src, mics, e_absorption, ism_order, t_max,
        air_absorption=air_absorption, c=c,
    )
    tail = histogram_tail(hist, fs, rng)
    m, ism_len = out.shape
    length = max(ism_len, tail.shape[1])
    full = np.zeros((m, length), np.float32)
    full[:, :ism_len] = out
    full[:, : tail.shape[1]] += tail
    return full


def apply_diffuse_tail(
    out: np.ndarray,
    max_dist: float,
    rt60: float,
    fs: int,
    rng: Optional[np.random.Generator],
    c: float = SPEED_OF_SOUND,
    volume: Optional[float] = None,
) -> np.ndarray:
    """Append a Sabine-decay stochastic late tail after the truncated ISM.

    The tail is white noise under the *absolute* Polack diffuse-field
    envelope: expected reverberant energy density E(t) = c/(4*pi*V) *
    10^(-6 t / rt60) (t from source emission), i.e. per-sample RMS
    sigma(t) = sqrt(c / (4 pi V fs)) * 10^(-3 t / rt60). Leveling the tail
    from first principles — rather than from the trailing RMS of the
    truncated order-3 image response, which undershoots the true late
    field — keeps the measured RT60 of hybrid RIRs on the requested value
    (validated quantitatively in tests/test_rir_golden.py). ``volume``
    (m^3) is required for the absolute level; legacy calls without it fall
    back to trailing-RMS matching.
    """
    if rng is None:
        rng = np.random.default_rng(0)
    m, ism_len = out.shape
    t_switch = min(int(max_dist * fs / c), ism_len - 1)
    tail_len = int(rt60 * fs)
    length = max(ism_len, t_switch + tail_len)
    decay = np.log(10.0 ** (-3.0)) / (rt60 * fs)  # -60 dB over rt60
    full = np.zeros((m, length), np.float32)
    full[:, :ism_len] = out
    t = np.arange(length - t_switch)
    env = np.exp(decay * (t + t_switch))
    for mi in range(m):
        if volume is not None:
            level = math.sqrt(c / (4.0 * math.pi * volume * fs))
        else:
            seg = full[mi, max(0, t_switch - fs // 100) : t_switch + 1]
            level = float(np.sqrt(np.mean(seg**2))) if len(seg) else 0.0
            level /= math.exp(decay * t_switch) or 1.0
        if level <= 0.0:
            continue
        full[mi, t_switch:] += (
            rng.standard_normal(len(t)) * env * level
        ).astype(np.float32)
    return full


def direct_path_rir(
    src: Sequence[float], mic: Sequence[float], fs: int,
    c: float = SPEED_OF_SOUND,
) -> np.ndarray:
    """Anechoic propagation (delay + 1/4πd) — the reference's
    `AnechoicRoom` clean target (dataset/audio_util.py:67, 82-83)."""
    d = float(np.linalg.norm(np.asarray(src, float) - np.asarray(mic, float)))
    d = max(d, 1e-3)
    delay = d * fs / c
    base = int(np.floor(delay))
    frac = np.array([delay - base])
    filt = _frac_delay_filter(frac)[0] / (4.0 * np.pi * d)
    h = np.zeros(base + FDL, np.float64)
    s = base - FDL // 2
    lo = max(0, -s)
    h[s + lo : s + FDL] = filt[lo:]
    return h.astype(np.float32)


def _convolve(sig: np.ndarray, h: np.ndarray, n_out: int) -> np.ndarray:
    from scipy.signal import fftconvolve

    y = fftconvolve(sig, h)
    if len(y) < n_out:
        y = np.pad(y, (0, n_out - len(y)))
    return y[:n_out]


def _mix_through_rirs(sources, rirs, m: int, n: int) -> np.ndarray:
    """Frequency-domain batched room propagation.

    Instead of one fftconvolve per (source, mic) pair (n_src*M separate
    FFTs — the dominant cost of online synthesis), accumulate
    sum_s S_s(f) * H_{s,m}(f) per mic and invert once: n_src forward FFTs
    + n_src batched RIR FFTs + one batched inverse FFT.
    """
    from scipy.fft import irfft, next_fast_len, rfft

    max_l = max(h.shape[1] for h in rirs)
    nfft = next_fast_len(n + max_l - 1)
    acc = np.zeros((m, nfft // 2 + 1), np.complex128)
    for sig, h in zip(sources, rirs):
        s_f = rfft(sig, nfft)
        h_f = rfft(h, nfft, axis=-1)  # (M, F) batched
        acc += s_f[None, :] * h_f
    out = irfft(acc, nfft, axis=-1)[:, :n]
    return out.astype(np.float32)


def simulate_scene(
    room_dim,
    e_absorption: float,
    max_order: int,
    rir_method: str,
    fs: int,
    ref_mic: int,
    p_mics: np.ndarray,
    p_target,
    p_noise_list,
    clean: np.ndarray,
    noises: Sequence[np.ndarray],
    rt60: Optional[float] = None,
    rng: Optional[np.random.Generator] = None,
    backend: str = "auto",
) -> Tuple[np.ndarray, np.ndarray]:
    """Propagate pre-scaled dry signals through the room.

    Returns (noisy (M, N), clean_anechoic_ref (N,)) — the reference's
    `make_audio` contract (dataset/audio_util.py:49-88): the training target
    is the *anechoic* clean at the reference mic.
    """
    p_mics = np.asarray(p_mics, np.float64)
    if p_mics.shape[0] == 3 and p_mics.shape[1] != 3:
        p_mics = p_mics.T  # (M, 3)
    m = p_mics.shape[0]
    n = len(clean)

    from eabnet_tpu_torch.data.rir_native import resolve_rir_fn

    rir_fn = resolve_rir_fn(backend)

    sources = [(p_target, clean)] + [
        (p, s) for p, s in zip(p_noise_list, noises)
    ]
    rirs = [
        rir_fn(
            room_dim, p_src, p_mics, e_absorption, max_order, fs,
            method=rir_method, rt60=rt60, rng=rng,
        )
        for p_src, _ in sources
    ]
    noisy = _mix_through_rirs([s for _, s in sources], rirs, m, n)

    h_direct = direct_path_rir(p_target, p_mics[ref_mic], fs)
    clean_ref = _convolve(clean, h_direct, n).astype(np.float32)
    return noisy, clean_ref
