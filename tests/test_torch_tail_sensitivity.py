"""The port's ``tools/tail_sensitivity.py`` against the JAX tool on the CPU.

On one staged workdir (``long_train``'s staging at the tiny recipe's
corpus): each tail model's render through the port's ``cli.datagen``
against the JAX tool's render, wavs within 1 int16 LSB (as
tests/test_torch_long_train.py holds ``stage_data``; both datagens run
serially here); ``score`` against the JAX tool's on the same set and
estimates, within the eval CLI's per-item limits (PESQ and SI-SDR 1e-3,
STOI and ESTOI 1e-4); the report's lines against the JAX tool's (the
golden of ``chip_smoke.py``'s cut: the text and the rows as printed, the
deltas within one unit of their last digit, which the port computes from
the printed means here); ``main`` end to end with a stand-in enhancer;
and ``--check``'s comparison with release/val_set_large on both tools'
renders. The card run at the cut is ``chip_smoke.py``'s tails phase.
"""

import json
import os
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from eabnet_tpu_torch.tools import tail_sensitivity as PTS  # noqa: E402
from tools import tail_sensitivity as JTS  # noqa: E402

SCORE_TOL = {"si_sdr": 1e-3, "pesq": 1e-3, "stoi": 1e-4, "estoi": 1e-4}
CUT = dict(items=1, clip=1.0, workers=1)


class SerialPool:
    """A stand-in for the datagens' process pools: the same jobs in this
    process, in order."""

    def __init__(self, *args, **kw):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def map(self, fn, jobs):
        return map(fn, jobs)


def stand_in(noisy):
    """A fixed linear 'enhancer' of the reference mic and its neighbour."""
    return (0.7 * noisy[0] + 0.2 * noisy[1]).astype(np.float32)


@pytest.fixture(scope="module")
def renders(tmp_path_factory):
    """The tiny recipe's staging, and every tail model rendered by both
    tools into <root>/<pkg>/<method>."""
    from eabnet_tpu.cli import datagen as jgen
    from eabnet_tpu_torch.cli import datagen as pgen
    from eabnet_tpu_torch.tools.e2e_demo import SETTINGS
    from eabnet_tpu_torch.tools.long_train import stage_data

    mp = pytest.MonkeyPatch()
    mp.setattr(jgen, "ProcessPoolExecutor", SerialPool)
    mp.setattr(pgen, "ProcessPoolExecutor", SerialPool)
    root = str(tmp_path_factory.mktemp("tails"))
    work = os.path.join(root, "work")
    try:
        stage_data(work, 42, 2, 1.0, 4, 2, 1, SETTINGS, render_train=False)
        for pkg, tool in (("port", PTS), ("jax", JTS)):
            for method in PTS.METHODS:
                tool.render(work, method, os.path.join(root, pkg, method),
                            **CUT)
    finally:
        mp.undo()
    return root, work


def wav_dirs(root, method):
    return [(os.path.join(root, "port", method, sub),
             os.path.join(root, "jax", method, sub))
            for sub in ("noisy", "clean")]


def test_the_tools_share_their_constants():
    assert PTS.METHODS == JTS.METHODS and PTS.KEYS == JTS.KEYS


@pytest.mark.parametrize("method", PTS.METHODS)
def test_render_equals_jax(renders, method):
    from scipy.io import wavfile

    root, _ = renders
    for a_dir, b_dir in wav_dirs(root, method):
        names = sorted(os.listdir(a_dir))
        assert names and names == sorted(os.listdir(b_dir))
        for n in names:
            ra, a = wavfile.read(os.path.join(a_dir, n))
            rb, b = wavfile.read(os.path.join(b_dir, n))
            assert ra == rb and a.dtype == b.dtype and a.shape == b.shape
            assert np.abs(a.astype(np.int32) - b.astype(np.int32)).max() \
                <= 1, n
    with open(os.path.join(root, "port", method, "settings.json")) as f:
        ours = json.load(f)
    with open(os.path.join(root, "jax", method, "settings.json")) as f:
        assert ours == json.load(f)
    assert ours["audio"]["rir_method"] == method


@pytest.mark.parametrize("enhancer", ["noisy", "stand-in"])
def test_score_equals_jax(renders, enhancer):
    root, _ = renders
    val = os.path.join(root, "jax", "ism")
    fn = None if enhancer == "noisy" else stand_in
    ours, want = PTS.score(fn, val), JTS.score(fn, val)
    assert list(ours) == list(want) == list(PTS.KEYS)
    for k, tol in SCORE_TOL.items():
        for a, b in zip(ours[k], want[k]):
            assert abs(a - b) <= tol, (k, a, b)


def test_markdown_is_the_jax_tools():
    """The report of the golden's means: the JAX tool's text lines and rows
    as printed; each delta within one unit of its last digit."""
    with open(os.path.join(ROOT, chip_smoke.TAILS_GOLDEN)) as f:
        golden = json.load(f)
    table = golden["table"]
    rows = {m: {s: {k: (float(v), 0.0) for k, v in r.items()}
                for s, r in stages.items()}
            for m, stages in table["rows"].items()}
    items = int(golden["cut"][golden["cut"].index("--items") + 1])
    lines = PTS.markdown(rows, chip_smoke.EXP_CLN, items)
    ours = chip_smoke.parse_tails("\n".join(lines))
    assert ours["text"] == table["text"]
    assert ours["rows"] == table["rows"]
    assert len(lines) == len(golden["markdown"])
    for m, stages in table["deltas"].items():
        for s, row in stages.items():
            for k, v in row.items():
                assert abs(float(ours["deltas"][m][s][k]) - float(v)) \
                    <= 1e-3 + 1e-9, (m, s, k)
    assert not chip_smoke.check_tails(ours, golden)


def test_main_writes_the_report(renders, tmp_path, monkeypatch):
    """main on the rendered sets (nothing rendered again), with a stand-in
    for load_enhancer: the report's 9 + 4 rows, the rows it returns."""
    from eabnet_tpu_torch import inference

    root, work = renders
    monkeypatch.setattr(inference, "load_enhancer",
                        lambda exp, output, device: stand_in)
    out = str(tmp_path / "TAILS.md")
    rows = PTS.main(["--workdir", work, "--out", out, "--render-root",
                     os.path.join(root, "port"), "--items", "1",
                     "--platform", "cpu"])
    with open(out) as f:
        table = chip_smoke.parse_tails(f.read())
    assert sorted(table["rows"]) == sorted(PTS.METHODS)
    assert sum(len(v) for v in table["rows"].values()) == 9
    assert sum(len(v) for v in table["deltas"].values()) == 4
    for m in PTS.METHODS:
        assert rows[m]["esti"] == rows[m]["esti0"]
        for s in PTS.STAGES:
            assert table["rows"][m][s]["pesq"] == \
                f"{rows[m][s]['pesq'][0]:.3f}"


def test_check_reads_the_committed_set(tmp_path, monkeypatch):
    """--check's comparison with release/val_set_large: the port's hybrid
    render of the first 8 items (6 s, long_train's default staging)
    against the committed wavs gives the deviation the JAX tool's render
    gives, to one int16 LSB of the committed peak."""
    from eabnet_tpu.cli import datagen as jgen
    from eabnet_tpu_torch.cli import datagen as pgen
    from eabnet_tpu_torch.tools.e2e_demo import SETTINGS
    from eabnet_tpu_torch.tools.long_train import stage_data

    monkeypatch.setattr(jgen, "ProcessPoolExecutor", SerialPool)
    monkeypatch.setattr(pgen, "ProcessPoolExecutor", SerialPool)
    work = str(tmp_path / "work")
    stage_data(work, 160, 24, 6.0, 16, 2, 2, SETTINGS, render_train=False)
    worst = {}
    for pkg, tool in (("port", PTS), ("jax", JTS)):
        tool.render(work, "hybrid", str(tmp_path / pkg / "hybrid"), 8, 6.0,
                    1)
        worst[pkg] = PTS.check(str(tmp_path / pkg))
    assert np.isfinite(worst["port"])
    assert abs(worst["port"] - worst["jax"]) <= 1 / 32767 * 1.001
