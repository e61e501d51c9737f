"""The port's long-run tool and end-to-end tools against the repo's JAX
tools, on the CPU:

- ``tools/e2e_demo.py``'s corpus (the same wav bytes) and settings;
- ``tools/long_train.py``'s staging (the same lists, settings and
  rendered wavs), its checkpoint pruning, and a two-phase run of the tiny
  model (``--platform cpu --tiny``) in two ``main(argv)`` calls: the first
  recycles with ``SystemExit(75)`` after step 2, the second resumes and
  trains the frozen chunk to step 4; the curves rows are the JAX tool's,
  key for key, and ``tools/curves_report.py`` reads them; the frozen
  chunk leaves every ``eabnet`` parameter's bits as they were;
- the JAX ``tools/release_report.py`` and ``tools/export_params.py`` read
  the port's run and agree with the port's tools (the scoring phase's
  per-metric tolerances; equal parameter trees);
- ``examples/demo.py``'s pinned scene, and the port's demo on the run.
"""

import ast
import json
import math
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from eabnet_tpu_torch.checkpoint import msgpack_restore  # noqa: E402
from eabnet_tpu_torch.tools import demo as PDEMO  # noqa: E402
from eabnet_tpu_torch.tools import e2e_demo as PE2E  # noqa: E402
from eabnet_tpu_torch.tools import export_params as PEXP  # noqa: E402
from eabnet_tpu_torch.tools import long_train as PLT  # noqa: E402
from eabnet_tpu_torch.tools import release_report as PREP  # noqa: E402
from eabnet_tpu_torch.weights import flatten_tree  # noqa: E402

from test_torch_online_host import SerialPool  # noqa: E402

# the two-phase recipe's chunking, cut to 4 steps, on the tiny model and a
# small corpus (42 speech files: the 20:1 split leaves 2 for validation)
RUN_ARGS = ["--platform", "cpu", "--tiny", "--max-steps", "4", "--chunk",
            "2", "--freeze-after", "2", "--steps-per-process", "2",
            "--train-items", "4", "--val-items", "2", "--corpus-speech",
            "42", "--corpus-noise", "2", "--seconds", "1", "--batch", "2",
            "--workers", "1"]
METRICS = ("si_sdr", "pesq", "nb_pesq", "stoi", "estoi", "seg_snr", "lsd")
# the per-metric tolerances of a score against the JAX package's
# (chip_smoke.SCORE_TOL)
SCORE_TOL = {"pesq": 1e-3, "nb_pesq": 1e-3, "stoi": 1e-4, "estoi": 1e-4,
             "si_sdr": 1e-3, "seg_snr": 1e-3, "lsd": 1e-3}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for the port: on a host that other test workers
    load, more threads mostly wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def run(tmp_path_factory, one_thread):
    """The port's two-phase run: two ``main(argv)`` calls on one workdir;
    each call's exit code (None for a normal end) and ``RUN`` record."""
    root = str(tmp_path_factory.mktemp("longrun"))
    argv = ["--workdir", root] + RUN_ARGS
    calls = []
    for _ in range(2):
        code = None
        try:
            PLT.main(argv)
        except SystemExit as e:
            code = e.code
        calls.append((code, json.loads(json.dumps(PLT.RUN))))
    return {"root": root, "calls": calls}


def read_curves(root):
    with open(os.path.join(root, "curves.jsonl")) as f:
        return [json.loads(line) for line in f if line.strip()]


def params_of(path):
    with open(path, "rb") as f:
        tree = msgpack_restore(f.read())
    return tree["state"]["params"] if "state" in tree else tree["params"]


def assert_same_wavs(a_dir, b_dir):
    """The same wav names; int16 samples within 1 LSB (the native RIR
    engines may differ from each other by float rounding)."""
    from scipy.io import wavfile

    names = sorted(os.listdir(a_dir))
    assert names and names == sorted(os.listdir(b_dir)), (a_dir, b_dir)
    for n in names:
        ra, a = wavfile.read(os.path.join(a_dir, n))
        rb, b = wavfile.read(os.path.join(b_dir, n))
        assert ra == rb and a.dtype == b.dtype and a.shape == b.shape, n
        assert np.abs(a.astype(np.int32) - b.astype(np.int32)).max() <= 1, n


# --------------------------------------------------------------- e2e_demo
def test_corpus_and_settings_equal_jax(tmp_path):
    from tools import e2e_demo as JE2E

    for pkg, fn in (("jax", JE2E.make_corpus), ("port", PE2E.make_corpus)):
        fn(str(tmp_path / pkg), n_speech=3, n_noise=2, seconds=1.0)
    for sub in ("speech", "noise"):
        names = sorted(os.listdir(tmp_path / "port" / sub))
        assert names == sorted(os.listdir(tmp_path / "jax" / sub))
        assert len(names) == {"speech": 3, "noise": 2}[sub]
        for n in names:
            assert (tmp_path / "port" / sub / n).read_bytes() == \
                (tmp_path / "jax" / sub / n).read_bytes(), (sub, n)
    assert PE2E.SETTINGS == JE2E.SETTINGS


# ------------------------------------------------------------- long_train
def test_stage_data_equals_jax(run, tmp_path, monkeypatch):
    """The JAX ``stage_data`` with the run's arguments (its datagen run
    serially) writes what the port's wrote: the corpus and settings byte
    for byte, the lists, and both rendered sets."""
    from eabnet_tpu.cli import datagen as jgen
    from tools import e2e_demo as JE2E
    from tools import long_train as JLT

    monkeypatch.setattr(jgen, "ProcessPoolExecutor", SerialPool)
    jroot = str(tmp_path / "jax")
    os.makedirs(jroot)
    JLT.stage_data(jroot, 42, 2, 1.0, 4, 2, 1, JE2E.SETTINGS)
    proot = run["root"]
    for sub in ("speech", "noise", "lists"):
        names = sorted(os.listdir(os.path.join(proot, sub)))
        assert names == sorted(os.listdir(os.path.join(jroot, sub)))
        for n in names:
            with open(os.path.join(proot, sub, n), "rb") as a, \
                    open(os.path.join(jroot, sub, n), "rb") as b:
                assert a.read() == b.read(), (sub, n)
    for name in ("settings.json", ".staged"):
        with open(os.path.join(proot, name)) as a, \
                open(os.path.join(jroot, name)) as b:
            assert a.read() == b.read(), name
    for part in ("train_set", "val"):
        for sub in ("noisy", "clean"):
            assert_same_wavs(os.path.join(proot, part, sub),
                             os.path.join(jroot, part, sub))
    assert len(os.listdir(os.path.join(proot, "train_set", "noisy"))) == 4
    assert len(os.listdir(os.path.join(proot, "val", "noisy"))) == 2


@pytest.mark.parametrize("keep_last,keep_every", [(2, 10000), (2, 0),
                                                  (3, 4000), (1, 20000)])
def test_prune_checkpoints_equals_jax(tmp_path, keep_last, keep_every):
    from tools import long_train as JLT

    names = [f"{s}.ckpt" for s in (0, 1000, 3000, 4000, 10000, 12000,
                                   20000, 21000, 22000)]
    names += ["x.ckpt", "500.params", "7.ckpt.tmp", "ckpt"]
    kept = {}
    for pkg, fn in (("jax", JLT.prune_checkpoints),
                    ("port", PLT.prune_checkpoints)):
        d = tmp_path / pkg
        d.mkdir()
        for n in names:
            (d / n).write_text(n)
        fn(str(d), keep_last=keep_last, keep_every=keep_every)
        kept[pkg] = sorted(os.listdir(d))
    assert kept["port"] == kept["jax"]
    assert len(kept["port"]) < len(names)
    PLT.prune_checkpoints(str(tmp_path / "absent"))  # no dir: nothing


def test_first_call_recycles_with_75_and_the_second_resumes(run):
    (code1, run1), (code2, run2) = run["calls"]
    assert code1 == PLT.EXIT_RECYCLE == 75
    assert code2 is None
    assert [(c["step"], c["frozen"]) for c in run1["chunks"]] == \
        [(2, False)]
    assert [(c["step"], c["frozen"]) for c in run2["chunks"]] == [(4, True)]
    assert run1["staged_s"] > run2["staged_s"]  # the second skips staging
    ckpts = sorted(os.listdir(os.path.join(run["root"], "ckpt")))
    assert [n for n in ckpts if n.endswith(".ckpt")] == ["2.ckpt", "4.ckpt"]


def test_curves_rows_are_the_jax_tools(run):
    rows = read_curves(run["root"])
    assert [(r["step"], r["stage"]) for r in rows] == [
        (-1, "noisy"), (2, "esti0"), (2, "esti"), (4, "esti0"), (4, "esti")]
    assert list(rows[0]) == ["step", "stage", *METRICS]
    for r in rows[1:]:
        assert list(r) == ["step", "stage", "frozen", "it_per_sec",
                           *METRICS]
        assert r["frozen"] == (r["step"] == 4)
        assert r["it_per_sec"] > 0
    for r in rows:
        for k in METRICS:
            assert math.isfinite(r[k]) and r[k] == round(r[k], 4), (r, k)


def test_frozen_chunk_keeps_every_eabnet_bit(run):
    ckpt = os.path.join(run["root"], "ckpt")
    p2, p4 = (flatten_tree(params_of(os.path.join(ckpt, f"{s}.ckpt")))
              for s in (2, 4))
    assert set(p2) == set(p4)
    eab = [k for k in p2 if k.startswith("eabnet.")]
    post = [k for k in p2 if k.startswith("postnet.")]
    assert eab and post and len(eab) + len(post) == len(p2)
    for k in eab:
        np.testing.assert_array_equal(p4[k], p2[k], err_msg=k)
    assert any(not np.array_equal(p4[k], p2[k]) for k in post)
    rows = {(r["step"], r["stage"]): r for r in read_curves(run["root"])}
    assert {k: rows[(4, "esti0")][k] for k in METRICS} == \
        {k: rows[(2, "esti0")][k] for k in METRICS}


def test_curves_report_reads_the_port_run(run, capsys):
    from tools import curves_report

    curves_report.main([os.path.join(run["root"], "curves.jsonl")])
    out = capsys.readouterr().out
    assert "| noisy | — |" in out
    assert "| 2 | False |" in out and "| 4 | True |" in out
    assert "final step 4: esti - esti0 margins:" in out


# ---------------------------------------------- release_report, export
def recorded(monkeypatch, module):
    """Wrap ``module.score`` to record each stage's raw numbers."""
    got, score = [], module.score

    def wrapper(*args, **kw):
        out = score(*args, **kw)
        got.append(out)
        return out

    monkeypatch.setattr(module, "score", wrapper)
    return got


def test_jax_release_report_agrees_on_the_port_run(run, tmp_path,
                                                   monkeypatch):
    """The JAX tool reads the port's checkpoint and config; both reports
    have the same lines, and every cell's mean and CI agree within the
    per-metric tolerances of SCORE_TOL."""
    from tools import release_report as JREP

    root, val = run["root"], os.path.join(run["root"], "val")
    raw, text = {}, {}
    for pkg, mod in (("jax", JREP), ("port", PREP)):
        raw[pkg] = recorded(monkeypatch, mod)
        out = str(tmp_path / f"{pkg}.md")
        mod.main(["--exp-root", root, "--val", val, "--out", out,
                  "--platform", "cpu"])
        with open(out) as f:
            text[pkg] = f.read().splitlines()
    assert len(raw["port"]) == len(raw["jax"]) == 3  # noisy, esti0, esti
    for (p, pn), (j, jn) in zip(raw["port"], raw["jax"]):
        assert pn == jn == 2
        for k in METRICS:
            (pm, ps), (pm2, pci) = p[k]
            (jm, js), (jm2, jci) = j[k]
            for a, b in ((pm, jm), (ps, js), (pci, jci)):
                assert abs(a - b) <= SCORE_TOL[k], (k, a, b)
    assert len(text["port"]) == len(text["jax"])
    assert text["port"][2] == text["jax"][2] == (
        "Checkpoint: `4.ckpt` (step 4); PESQ backend: first_party.")
    for a, b in zip(text["port"], text["jax"]):
        if not a.startswith(("| noisy", "| esti", "esti − esti0")):
            assert a == b


def test_jax_export_params_agrees_on_the_port_run(run, tmp_path):
    from tools import export_params as JEXP

    out = {}
    for pkg, fn in (("jax", JEXP.main), ("port", PEXP.main)):
        out[pkg] = tmp_path / pkg
        args = ["--exp-root", run["root"], "--out", str(out[pkg])]
        fn(args + (["--platform", "cpu"] if pkg == "port" else []))
    assert sorted(os.listdir(out["port"])) == sorted(
        os.listdir(out["jax"])) == ["4.params", "config.json"]
    a, b = (flatten_tree(params_of(str(out[p] / "4.params")))
            for p in ("port", "jax"))
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    cfgs = [json.loads((out[p] / "config.json").read_text())
            for p in ("port", "jax")]
    assert cfgs[0] == cfgs[1]
    assert cfgs[0]["train"]["checkpoint_dir"] == "."


# ------------------------------------------------------------------- demo
def jax_demo_specific():
    """The ``specific`` dict of ``examples/demo.py``'s main, as written."""
    with open(os.path.join(ROOT, "examples", "demo.py")) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "specific" for t in node.targets):
            return ast.literal_eval(node.value)
    raise AssertionError("no specific dict in examples/demo.py")


def test_demo_scene_equals_jax(run):
    from eabnet_tpu.data.datasets import synthesize_item
    from eabnet_tpu.data.scenes import load_settings

    assert PDEMO.SPECIFIC == jax_demo_specific()
    root = run["root"]
    settings = os.path.join(root, "settings.json")
    speech = os.path.join(root, "speech", "sp000.wav")
    noise_dir = os.path.join(root, "noise")
    noisy, clean, meta = PDEMO.pinned_scene(settings, speech, noise_dir)
    noises = sorted(os.path.join(noise_dir, n) for n in os.listdir(noise_dir))
    jn, jc, jmeta = synthesize_item(load_settings(settings), 6.0, speech,
                                    noises[:2], seed=0,
                                    specific=jax_demo_specific(),
                                    return_meta=True)
    assert noisy.shape == jn.shape == (9, 96000) and clean.shape == jc.shape
    # the native RIR engines of the two packages: the native engine's
    # 1e-5 rule (tests/test_torch_online_host.py)
    np.testing.assert_allclose(noisy, jn, rtol=0, atol=1e-5)
    np.testing.assert_allclose(clean, jc, rtol=0, atol=1e-5)
    assert meta["room_dim"] == jmeta["room_dim"] == [6.0, 5.0, 3.0]
    assert meta["rt60"] == jmeta["rt60"]
    np.testing.assert_allclose(meta["snrs_db"], jmeta["snrs_db"])


def test_demo_runs_on_the_port_run(run, tmp_path, capsys):
    root = run["root"]
    out = tmp_path / "demo"
    scores = PDEMO.main([
        "--settings", os.path.join(root, "settings.json"),
        "--speech", os.path.join(root, "speech", "sp000.wav"),
        "--noise-dir", os.path.join(root, "noise"), "--exp-root", root,
        "--out-dir", str(out), "--platform", "cpu"])
    assert sorted(os.listdir(out)) == ["clean.wav", "enhanced.wav",
                                       "noisy.wav"]
    assert all(math.isfinite(v) for v in scores.values() if v is not None)
    printed = capsys.readouterr().out
    assert "si_sdr: " in printed and "scene: " in printed
