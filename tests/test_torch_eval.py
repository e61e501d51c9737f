"""The port's evaluation layer (eabnet_tpu_torch.eval) against the JAX
package's (eabnet_tpu.eval): the same numpy code on the same inputs, so
every case is held equal (|difference| <= 1e-9 * max(1, |x|)) and any
difference is a copying error. Inputs: seeded numpy signals, and item
00000 of release/val_set (clean against the noisy reference mic and
against the JAX package's golden ``esti`` / ``esti0``). Last, the port's
harness reproduces the ``noisy`` row of release/REPORT.md's
release/val_set table at its printed precision.
"""

import importlib
import os
import re

import numpy as np
import pytest
from scipy.signal import lfilter, resample_poly

from eabnet_tpu_torch.utils.audio_io import read_wav

# the modules themselves: each package's eval/__init__ exports functions
# named like two of them (stoi, pesq)
(j_harness, j_metrics, j_p862, j_pesq, j_stoi), \
    (t_harness, t_metrics, t_p862, t_pesq, t_stoi) = (
        [importlib.import_module(f"{pkg}.eval.{m}") for m in
         ("harness", "metrics", "p862", "pesq", "stoi")]
        for pkg in ("eabnet_tpu", "eabnet_tpu_torch"))

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VAL = os.path.join(ROOT, "release", "val_set")
GOLDEN = os.path.join(ROOT, "tests", "golden",
                      "torch_port_composed_9mic_00000.npz")
REPORT = os.path.join(ROOT, "release", "REPORT.md")
METRICS = t_harness.METRICS


def assert_equal(ours, ref):
    """Equal to 1e-9 relative (absolute below 1), element for element;
    NaN only where the reference has NaN."""
    ours = np.asarray(ours, np.float64)
    ref = np.asarray(ref, np.float64)
    assert ours.shape == ref.shape
    assert np.array_equal(np.isnan(ours), np.isnan(ref))
    ok = ~np.isnan(ref)
    tol = 1e-9 * np.maximum(1.0, np.abs(ref[ok]))
    assert np.all(np.abs(ours[ok] - ref[ok]) <= tol), (ours, ref)


def speechlike(rng, n: int, fs: int) -> np.ndarray:
    """Coloured noise in syllable-rate bursts, so the VADs find speech."""
    x = lfilter([1.0], [1.0, -0.9], rng.standard_normal(n))
    t = np.arange(n) / fs
    env = np.maximum(0.0, np.sin(2 * np.pi * 3.0 * t)) ** 2
    return 0.1 * x * env / np.std(x)


@pytest.fixture(scope="module")
def sig():
    rng = np.random.default_rng(13)
    clean = speechlike(rng, 3 * 16000, 16000)
    noise = 0.05 * rng.standard_normal(clean.size)
    esti = 0.9 * clean + 0.3 * noise + 0.01 * rng.standard_normal(clean.size)
    return dict(clean=clean, noise=noise, noisy=clean + noise, esti=esti)


# ------------------------------------------------------------- metrics.py

@pytest.mark.parametrize("fn", ["si_sdr_components", "energy_ratios"])
def test_si_sdr_decomposition(sig, fn):
    args = (sig["esti"], sig["clean"], sig["noise"])
    ours = getattr(t_metrics, fn)(*args)
    ref = getattr(j_metrics, fn)(*args)
    for o, r in zip(ours, ref):
        assert_equal(o, r)


@pytest.mark.parametrize("fn", ["si_sdr", "snr_db", "seg_snr",
                                "log_spectral_distance"])
def test_pair_metrics(sig, fn):
    a, b = sig["clean"], sig["esti"]
    if fn == "snr_db":
        a, b = sig["clean"], sig["noise"]
    assert_equal(getattr(t_metrics, fn)(a, b), getattr(j_metrics, fn)(a, b))


def test_hp_filter(sig):
    assert_equal(t_metrics.hp_filter(sig["noisy"], cut_off=100.0),
                 j_metrics.hp_filter(sig["noisy"], cut_off=100.0))


@pytest.mark.parametrize("shape,axis", [((3, 161, 100), -1),
                                        ((2, 64, 5), 1)])
def test_pad_spec_to_multiple(shape, axis):
    x = np.random.default_rng(3).standard_normal(shape)
    ours = t_metrics.pad_spec_to_multiple(x, 64, axis)
    assert_equal(ours, j_metrics.pad_spec_to_multiple(x, 64, axis))


def test_mean_std_and_conf_int():
    x = np.random.default_rng(4).standard_normal(48) * 3 + 1
    x_nan = np.concatenate([x, [np.nan]])
    assert_equal(t_metrics.mean_std(x_nan), j_metrics.mean_std(x_nan))
    for conf in (0.95, 0.99):
        assert_equal(t_metrics.mean_conf_int(x, conf),
                     j_metrics.mean_conf_int(x, conf))


def test_metric_accumulator():
    rng = np.random.default_rng(5)
    accs = [m.MetricAccumulator(("a", "b")) for m in (t_metrics, j_metrics)]
    for _ in range(9):
        row = {"a": float(rng.standard_normal()), "b": None,
               "c": float(rng.uniform())}
        for acc in accs:
            acc.update(row)
            acc.append("b", row["a"] * 2)
    ours, ref = accs
    assert ours.metrics.keys() == ref.metrics.keys()
    assert ours.report().keys() == ref.report().keys()
    for k in ref.report():
        assert_equal(ours.report()[k], ref.report()[k])
        assert_equal(ours.mean_ci(k), ref.mean_ci(k))
        assert_equal(ours.mean_std(k), ref.mean_std(k))


# ----------------------------------------------------------------- stoi.py

@pytest.mark.parametrize("extended", [False, True], ids=["stoi", "estoi"])
@pytest.mark.parametrize("fs", [16000, 10000])
def test_stoi(sig, fs, extended):
    clean, esti = sig["clean"], sig["esti"]
    if fs == 10000:  # the input already at STOI's rate: no resampling
        clean, esti = (resample_poly(x, 5, 8) for x in (clean, esti))
    ours = t_stoi.stoi(clean, esti, fs, extended=extended)
    assert_equal(ours, j_stoi.stoi(clean, esti, fs, extended=extended))
    assert 0.0 < ours < 1.0


# ----------------------------------------------------------------- p862.py

@pytest.mark.parametrize("fs,mode", [(16000, "wb"), (16000, "nb"),
                                     (8000, "nb")])
def test_pesq_p862(sig, fs, mode):
    clean, esti = sig["clean"], sig["esti"]
    if fs == 8000:
        clean, esti = (resample_poly(x, 1, 2) for x in (clean, esti))
    ours = t_p862.pesq_p862(fs, clean, esti, mode)
    assert_equal(ours, j_p862.pesq_p862(fs, clean, esti, mode))
    assert 1.0 < ours < 4.7


@pytest.mark.parametrize("fn", ["mos_lqo_nb", "mos_lqo_wb"])
def test_mos_lqo_maps(fn):
    raw = np.linspace(-0.5, 4.5, 101)
    assert_equal([getattr(t_p862, fn)(r) for r in raw],
                 [getattr(j_p862, fn)(r) for r in raw])


def test_p862_refuses_what_jax_refuses(sig):
    short = sig["clean"][:1000]
    for args in ((8000, sig["clean"], sig["esti"], "wb"),
                 (16000, sig["clean"], sig["esti"], "xx"),
                 (16000, short, short, "wb")):
        for mod in (t_p862, j_p862):
            with pytest.raises(ValueError):
                mod.pesq_p862(*args)
    silent = np.zeros(16000)
    assert_equal(t_p862.pesq_p862(16000, silent, silent, "wb"),
                 j_p862.pesq_p862(16000, silent, silent, "wb"))


# ----------------------------------------------------------------- pesq.py

@pytest.mark.parametrize("forced", ["", "first_party", "itu"])
def test_pesq_backend_gateway(monkeypatch, forced):
    """The same backend, or the same refusal, under EABNET_PESQ_BACKEND."""
    monkeypatch.setenv("EABNET_PESQ_BACKEND", forced)
    assert t_pesq.itu_pesq_available() == j_pesq.itu_pesq_available()
    assert t_pesq.pesq_available() and j_pesq.pesq_available()
    if forced == "itu" and not j_pesq.itu_pesq_available():
        for mod in (t_pesq, j_pesq):
            with pytest.raises(RuntimeError):
                mod.pesq_backend()
    else:
        assert t_pesq.pesq_backend() == j_pesq.pesq_backend()


# -------------------------------------------------------------- harness.py

@pytest.fixture(scope="module")
def item0():
    _, noisy = read_wav(os.path.join(VAL, "noisy", "00000.wav"))
    _, clean = read_wav(os.path.join(VAL, "clean", "00000.wav"))
    golden = np.load(GOLDEN)
    ests = {"noisy": noisy[0], "esti": golden["esti"],
            "esti0": golden["esti0"]}
    scores = {}
    for name, est in ests.items():
        scores[name] = (t_harness.cal_single_metrics(clean, noisy[0], est),
                        j_harness.cal_single_metrics(clean, noisy[0], est))
    return scores


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("estimate", ["noisy", "esti", "esti0"])
def test_item_00000_scores(item0, estimate, metric):
    ours, ref = item0[estimate]
    assert list(ours) == list(ref) == list(METRICS)
    assert_equal(ours[metric], ref[metric])


def test_cal_single_metrics_without_mixture(sig):
    """No mixture (dir-of-wavs scoring): plain SI-SDR, no SIR/SAR, and the
    shorter signal zero-padded to the longer."""
    clean, esti = sig["clean"], sig["esti"][:-100]
    ours = t_harness.cal_single_metrics(clean, None, esti)
    ref = j_harness.cal_single_metrics(clean, None, esti)
    assert list(ours) == list(ref)
    assert "si_sir" not in ours
    assert_equal(list(ours.values()), list(ref.values()))


def test_evaluate_dataset_and_write_report(sig, tmp_path):
    """Two items through both harnesses: the same rows, the same CSV and
    txt bytes (the txt names the PESQ backend and the extra keys)."""
    items = [(np.stack([sig["noisy"], sig["clean"]]), sig["clean"]),
             (np.stack([sig["esti"], sig["noisy"]]), sig["clean"])]

    def enhance(noisy):
        return 0.5 * (noisy[0] + noisy[1])

    files = {}
    for tag, mod in (("port", t_harness), ("jax", j_harness)):
        acc, rows = mod.evaluate_dataset(enhance, iter(items),
                                         names=["a.wav", "b.wav"])
        prefix = str(tmp_path / tag / "scores")
        txt = mod.write_report(acc, rows, prefix, extra={"stage": "esti"})
        files[tag] = (open(prefix + ".csv").read(), open(txt).read(), rows)
    assert files["port"][0] == files["jax"][0]
    assert files["port"][1] == files["jax"][1]
    assert "# stage: esti" in files["port"][1]
    assert [r["filename"] for r in files["port"][2]] == ["a.wav", "b.wav"]


def report_row(section: str, stage: str) -> dict:
    """{metric: (mean, ci) as printed} of one row of release/REPORT.md."""
    text = open(REPORT).read()
    block = text[text.index(f"## {section}"):]
    head = re.search(r"^\| stage \|(.*)\|$", block, re.M).group(1)
    names = [h.strip() for h in head.split("|")]
    row = re.search(rf"^\| {stage} \|(.*)\|$", block, re.M).group(1)
    return {n: tuple(c.strip().split(" ± "))
            for n, c in zip(names, row.split("|"))}


@pytest.fixture(scope="module")
def noisy_report():
    """The port's harness over release/val_set with the noisy reference
    mic as the estimate (as the release report scores ``noisy``)."""
    names = sorted(os.listdir(os.path.join(VAL, "clean")))

    def items():
        for n in names:
            _, noisy = read_wav(os.path.join(VAL, "noisy", n))
            _, clean = read_wav(os.path.join(VAL, "clean", n))
            yield np.atleast_2d(noisy), clean

    acc, _ = t_harness.evaluate_dataset(lambda noisy: noisy[0], items(),
                                        names=names)
    return acc


@pytest.mark.parametrize("metric", ["si_sdr", "pesq", "nb_pesq", "stoi",
                                    "estoi", "seg_snr", "lsd"])
def test_port_reproduces_release_report_noisy_row(noisy_report, metric):
    want = report_row("release/val_set", "noisy")[metric]
    m, h = noisy_report.mean_ci(metric)
    assert (f"{m:.3f}", f"{h:.3f}") == want
