"""The port's scoring CLIs against the JAX package's: ``cli.score`` on
directories of wavs, and ``cli.test`` on a checkpoint of a small model
(the config of tests/test_pth_ingestion.py: M=3, c=16, p=2, q=2) over a
validation set of the first two items of release/val_set (first 3 mics,
cropped to 2 s). Both packages run the same metric code, and the models
agree to float32 rounding, so the scores agree per item within 1e-3
(PESQ, the dB metrics, LSD) and 1e-4 (STOI, ESTOI).

``cli.test`` scores its default stage, ``esti0``. The untrained post-filter
(stage ``esti``) puts out almost nothing of the speech (SI-SDR -57 dB on
item 00000), and there SI-SIR, the ratio of two near-zero projections,
moves by 0.007 dB between the two packages' float32 outputs; ``esti0``,
a filter-and-sum of the mixture, is well conditioned (every score within
3e-5 of JAX's)."""

import csv
import dataclasses
import os

import numpy as np
import pytest
import torch
from scipy.io import wavfile

import jax

from eabnet_tpu.cli import score as j_score
from eabnet_tpu.cli import test as j_test
from eabnet_tpu.config import (ComposedConfig, EaBNetConfig,
                               ExperimentConfig, GaGNetConfig)
from eabnet_tpu.train.checkpoint import save_params as j_save_params
from eabnet_tpu.train.step import create_train_state as j_create_train_state
from eabnet_tpu_torch.checkpoint import load_params
from eabnet_tpu_torch.cli import score as t_score
from eabnet_tpu_torch.cli import test as t_test
from eabnet_tpu_torch.config import ExperimentConfig as PExperimentConfig
from eabnet_tpu_torch.models import build_model
from eabnet_tpu_torch.train.checkpoint import save_params
from eabnet_tpu_torch.utils.audio_io import write_wav
from eabnet_tpu_torch.weights import load_jax_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VAL = os.path.join(ROOT, "release", "val_set")
ITEMS = ("00000.wav", "00001.wav")
MICS, SECONDS, SR = 3, 2.0, 16000
METRICS = ("pesq", "nb_pesq", "stoi", "estoi", "si_sdr", "si_sir", "si_sar",
           "seg_snr", "lsd")
TOL = {m: (1e-4 if m in ("stoi", "estoi") else 1e-3) for m in METRICS}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for the port: on a host that other test workers
    load, more threads mostly wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def val_dir(tmp_path_factory):
    """clean/ and noisy/ of the first two val items, 3 mics, 2 s, int16."""
    root = tmp_path_factory.mktemp("val")
    n = int(SECONDS * SR)
    for sub in ("clean", "noisy"):
        os.makedirs(root / sub)
        for name in ITEMS:
            sr, data = wavfile.read(os.path.join(VAL, sub, name))
            data = data[:n, :MICS] if data.ndim == 2 else data[:n]
            wavfile.write(str(root / sub / name), sr, data)
    return str(root)


def read_csv(path: str) -> list:
    with open(path) as f:
        return list(csv.DictReader(f))


@pytest.fixture(scope="module")
def exp(val_dir, tmp_path_factory):
    """config.json of the small model with ``val_dir`` as its validation
    set, and ``7.params`` from a seeded JAX init. ``train.wav_len`` sets
    only the JAX init's dummy input (0.1 s: the init runs op by op)."""
    d = tmp_path_factory.mktemp("exp")
    cfg = ExperimentConfig(
        model=ComposedConfig(
            eabnet=EaBNetConfig(c=16, M=3, embed_dim=16, cd1=16, p=2, q=2),
            gagnet=GaGNetConfig(c=16, cd1=16, p=1, q=2)))
    cfg = dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, val_set=val_dir),
        train=dataclasses.replace(cfg.train, wav_len=0.1,
                                  checkpoint_dir=str(d)))
    cfg.save(str(d / "config.json"))
    _, state = j_create_train_state(cfg, jax.random.key(0))
    ckpt = j_save_params(jax.tree.map(np.asarray, state.params), str(d), 7)
    return dict(config=str(d / "config.json"), ckpt=ckpt)


@pytest.fixture(scope="module")
def cli_test_runs(exp, tmp_path_factory):
    """Each package's cli.test (stage esti0) on the same checkpoint: the
    JAX package's with --out-prefix, the port's with its default prefix
    (next to the checkpoint) and --device cpu; and the port's --limit 1."""
    out = tmp_path_factory.mktemp("out")
    jprefix = str(out / "jax_esti0")
    j_test.main(["--config", exp["config"], "--ckpt", exp["ckpt"],
                 "--out-prefix", jprefix])
    # the newest checkpoint of train.checkpoint_dir (7.params), the
    # default stage and prefix
    t_test.main(["--config", exp["config"], "--device", "cpu"])
    tprefix = os.path.splitext(exp["ckpt"])[0] + "_esti0"
    t_test.main(["--config", exp["config"], "--ckpt", exp["ckpt"],
                 "--device", "cpu", "--limit", "1",
                 "--out-prefix", str(out / "port_limit1")])
    return dict(jax=read_csv(jprefix + ".csv"),
                port=read_csv(tprefix + ".csv"),
                port_txt=open(tprefix + ".txt").read(),
                jax_txt=open(jprefix + ".txt").read(),
                limit1=read_csv(str(out / "port_limit1.csv")))


@pytest.mark.parametrize("metric", METRICS)
def test_cli_test_matches_jax(cli_test_runs, metric):
    ours, ref = cli_test_runs["port"], cli_test_runs["jax"]
    assert [r["filename"] for r in ours] == [r["filename"] for r in ref] \
        == ["00000", "00001"]
    for o, r in zip(ours, ref):
        assert abs(float(o[metric]) - float(r[metric])) <= TOL[metric], (
            o["filename"], o[metric], r[metric])


def test_cli_test_report_like_jax(cli_test_runs):
    """The same report lines (metric names, backend, stage); --limit 1
    scores the first item alone, as the full run scored it."""
    def names(txt):
        return [line.split(":")[0] for line in txt.splitlines()]

    assert names(cli_test_runs["port_txt"]) == names(cli_test_runs["jax_txt"])
    assert "# stage: esti0" in cli_test_runs["port_txt"]
    assert cli_test_runs["limit1"] == cli_test_runs["port"][:1]


def test_cli_test_reads_a_reference_pth(exp, tmp_path):
    """cli.test on a .pth scores what it scores on a .params of the same
    weights (converted by the port, written by the port), item for item."""
    from tests.test_torch_pth import small_cfg, write_pth

    pth = write_pth(tmp_path / "ref")
    pcfg = PExperimentConfig.load(exp["config"])
    assert pcfg.model == PExperimentConfig.from_dict(
        dataclasses.asdict(small_cfg())).model
    model = load_jax_params(build_model(pcfg.model),
                            load_params(pth, pcfg.model))
    params = save_params(model, str(tmp_path / "conv"), 4217)
    rows = {}
    for name, ckpt in (("pth", pth), ("params", params)):
        t_test.main(["--config", exp["config"], "--ckpt", ckpt,
                     "--output", "esti0", "--device", "cpu",
                     "--out-prefix", str(tmp_path / name)])
        rows[name] = read_csv(str(tmp_path / f"{name}.csv"))
    assert rows["pth"] == rows["params"] and len(rows["pth"]) == 2


@pytest.fixture(scope="module")
def score_dirs(val_dir, tmp_path_factory):
    """clean/ and noisy/ of the val set, and enhanced/: the reference mic
    scaled and lightly smoothed, as float wavs (a third-party system)."""
    enh = tmp_path_factory.mktemp("enhanced")
    for name in ITEMS:
        _, noisy = wavfile.read(os.path.join(val_dir, "noisy", name))
        x = noisy[:, 0].astype(np.float32) / 32768.0
        write_wav(str(enh / name), SR, 0.6 * (x + np.roll(x, 1)),
                  dtype="float")
    return dict(clean=os.path.join(val_dir, "clean"), enhanced=str(enh),
                noisy=os.path.join(val_dir, "noisy"))


@pytest.mark.parametrize("with_noisy", [False, True],
                         ids=["clean_only", "with_noisy"])
def test_cli_score_matches_jax(score_dirs, tmp_path, with_noisy):
    """Both packages' cli.score on the same three directories write the
    same CSV and report, byte for byte."""
    args = ["--clean", score_dirs["clean"], "--enhanced",
            score_dirs["enhanced"]]
    if with_noisy:
        args += ["--noisy", score_dirs["noisy"]]
    out = {}
    for tag, mod in (("port", t_score), ("jax", j_score)):
        prefix = str(tmp_path / tag)
        mod.main(args + ["--out-prefix", prefix])
        out[tag] = (open(prefix + ".csv").read(),
                    open(prefix + ".txt").read())
    assert out["port"] == out["jax"]
    assert ("si_sir" in out["port"][0]) == with_noisy
    assert out["port"][0].count("\n") == 1 + len(ITEMS)
