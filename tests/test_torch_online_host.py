"""The host half of the port's online synthesis against the JAX package's,
on the CPU: the numpy copies (scenes, mixer, RIRs, speech synthesis,
settings, item synthesis in every data mode, collation) must give the same
bits for the same seeds with the numpy RIR backend; the native engine is
held to the numpy RIRs at the JAX test's tolerance; the loader's batches
equal the JAX loader's; the trainer runs every data mode and resumes; the
data CLIs write what the JAX CLIs write.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from eabnet_tpu.config import DataConfig as JDataConfig
from eabnet_tpu.data import datasets as JD
from eabnet_tpu.data import device_mix as JDM
from eabnet_tpu.data import mixer as JM
from eabnet_tpu.data import rir as JR
from eabnet_tpu.data import scene_mix as JS
from eabnet_tpu.data import scenes as JSC
from eabnet_tpu.data import synth_speech as JSP
from eabnet_tpu_torch.config import (ComposedConfig, DataConfig,
                                     EaBNetConfig, ExperimentConfig,
                                     GaGNetConfig, TrainConfig)
from eabnet_tpu_torch.data import datasets as PD
from eabnet_tpu_torch.data import device_mix as PDM
from eabnet_tpu_torch.data import mixer as PM
from eabnet_tpu_torch.data import rir as PR
from eabnet_tpu_torch.data import rir_native as PN
from eabnet_tpu_torch.data import scene_mix as PS
from eabnet_tpu_torch.data import scenes as PSC
from eabnet_tpu_torch.data import synth_speech as PSP

from test_data import SETTINGS_V2, _write_fake_corpus

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODES = (False, "parts", "scene")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for the port: on a host that other test workers
    load, more threads mostly wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def corpus(tmp_path):
    """The JAX data tests' corpus (3 speech, 4 noise files of 3 s) and
    settings (9 mics, 3-5 noises, hybrid rooms)."""
    sp_dir, no_dir = _write_fake_corpus(tmp_path)
    settings = tmp_path / "settings.json"
    settings.write_text(json.dumps(SETTINGS_V2))
    kw = dict(dataset="mcse", train_set="online", speech_root=str(sp_dir),
              noise_root=str(no_dir),
              speech_list=str(tmp_path / "speech_list.txt"),
              noise_list=str(tmp_path / "noise_list.txt"),
              mcse_settings=str(settings), clip_seconds=1.0,
              rir_backend="numpy")
    return tmp_path, kw


def item_args(kw, seed):
    opt = PSC.load_settings(kw["mcse_settings"])
    noise_paths = sorted(os.path.join(kw["noise_root"], n)
                         for n in os.listdir(kw["noise_root"]))
    return opt, 1.0, os.path.join(kw["speech_root"], "sp0.wav"), \
        noise_paths, seed


def assert_same(a, b, path="."):
    """Equal bits, through dicts, lists, tuples and dataclasses."""
    if dataclasses.is_dataclass(a):
        a, b = dataclasses.asdict(a), dataclasses.asdict(b)
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            assert_same(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    else:
        x, y = np.asarray(a), np.asarray(b)
        assert x.dtype == y.dtype and x.shape == y.shape, path
        np.testing.assert_array_equal(x, y, err_msg=path)


# ---------------------------------------------------------------- scenes
@pytest.mark.parametrize("specific", [None, {
    "room_dim": [5, 4, 3], "target_xyz": [2.5, 3.0, 1.2],
    "mics_xyz": [2.5, 1.0, 1.3], "noise_xyz_list": [[1.0, 1.0, 1.0]],
    "noise_snr_list": [3.0], "rt60": 0.3, "noisy_dBFS": -25.0}],
    ids=["drawn", "specific"])
@pytest.mark.parametrize("name", ["v1", "v2", "v3"])
def test_settings_and_scenes_equal_jax(name, specific):
    opt = PSC.load_settings(name)
    assert opt == JSC.load_settings(name)
    for seed in range(4):
        assert_same(PSC.sample_scene(opt, np.random.default_rng(seed),
                                     specific=specific),
                    JSC.sample_scene(opt, np.random.default_rng(seed),
                                     specific=specific))


def test_inverse_sabine_and_mixer_equal_jax():
    for rt60, room in ((0.3, [5, 4, 3]), (0.7, [10, 9, 3]),
                       (0.12, [3, 3, 2.5])):
        assert PR.inverse_sabine(rt60, room) == JR.inverse_sabine(rt60, room)
    with pytest.raises(ValueError):  # too large a room for the rt60
        PR.inverse_sabine(0.05, [10, 9, 3])
    rng = np.random.default_rng(7)
    clean = rng.standard_normal(16000).astype(np.float32) * 0.3
    noises = [rng.standard_normal(16000).astype(np.float32) * s
              for s in (0.5, 0.05)]
    noises[1][4000:9000] = 0.0  # silent windows for the active-RMS gate
    args = (clean, noises, [3.0, -2.0], -20.0, 16000)
    assert_same(PM.mix_at_snr(*args), JM.mix_at_snr(*args))
    assert_same(PM.snr_gains(*args), JM.snr_gains(*args))
    assert PM.active_noise_rms(noises[1], 16000) == \
        JM.active_noise_rms(noises[1], 16000)


# ------------------------------------------------------------------ RIRs
ROOM, SRC = [6.0, 4.5, 2.8], [4.0, 3.0, 1.4]
MICS = np.stack([[2.0, 1.5 + 0.04 * i, 1.2] for i in range(4)])


@pytest.mark.parametrize("method", ["ism", "hybrid", "hybrid-sabine"])
def test_shoebox_rir_equals_jax(method):
    e_abs, order = PR.inverse_sabine(0.45, ROOM)
    if method == "ism":
        order = 8  # not the rt60's 54: the same code, a fraction the time
    args = (ROOM, SRC, MICS, e_abs, order, 16000)
    kw = dict(method=method, rt60=0.45)
    assert_same(PR.shoebox_rir(*args, rng=np.random.default_rng(3), **kw),
                JR.shoebox_rir(*args, rng=np.random.default_rng(3), **kw))
    assert_same(PR.direct_path_rir(SRC, MICS[0], 16000),
                JR.direct_path_rir(SRC, MICS[0], 16000))
    hist = (ROOM, SRC, MICS, e_abs, 3, 0.5)
    assert_same(PR.ism_energy_histogram(*hist),
                JR.ism_energy_histogram(*hist))


@pytest.mark.parametrize("fs", [16000, 44100], ids=["integral", "fractional"])
def test_histogram_tail_equals_jax(fs):
    hist = np.random.default_rng(1).random((3, 40)) * 1e-4
    hist[1, 5:9] = 0.0
    assert_same(PR.histogram_tail(hist, fs, np.random.default_rng(2)),
                JR.histogram_tail(hist, fs, np.random.default_rng(2)))


def test_native_engine_matches_numpy():
    """The port's C++ engine against its numpy ISM (the JAX test's
    tolerance: 1e-5 absolute, lengths within the 81-tap filter, nothing
    beyond the common length), at the order an RT60 asks for and in the
    hybrid mode with the same RNG for the tail."""
    assert PN.native_available()
    room, mics = [6.0, 5.0, 3.0], np.array([[4.0, 3.0, 1.5], [4.1, 3.0, 1.5]])
    e_abs, order = PR.inverse_sabine(0.3, room)
    for kw in ({}, dict(method="hybrid", rt60=0.3)):
        h_np = PR.shoebox_rir(room, [2, 2, 1.5], mics, e_abs, order, 16000,
                              rng=np.random.default_rng(0), **kw)
        h_cc = PN.shoebox_rir_native(room, [2, 2, 1.5], mics, e_abs, order,
                                     16000, rng=np.random.default_rng(0),
                                     **kw)
        n = min(h_np.shape[1], h_cc.shape[1])
        assert abs(h_np.shape[1] - h_cc.shape[1]) <= 81
        np.testing.assert_allclose(h_np[:, :n], h_cc[:, :n], atol=1e-5)
        for h in (h_np, h_cc):
            assert h.shape[1] == n or np.abs(h[:, n:]).max() < 1e-5
    assert PN.resolve_rir_fn("numpy") is PR.shoebox_rir
    assert PN.resolve_rir_fn("native") is PN.shoebox_rir_native


def test_native_engine_abi_gate(tmp_path):
    """A library of another rir_abi_version at the engine's path is
    rebuilt, never loaded as it is."""
    path = tmp_path / "librir-test.so"
    src = tmp_path / "old.cpp"
    src.write_text('extern "C" long long rir_abi_version() { return 1; }\n'
                   'extern "C" long long shoebox_rir() { return -7; }\n')
    subprocess.run(["g++", "-shared", "-fPIC", "-o", str(path), str(src)],
                   check=True)
    old = PN._open(path)
    assert old is None  # refused (and closed)
    lib = PN.load_library(path)
    assert lib.rir_abi_version() == PN.ABI_VERSION
    assert PN.load_library() is not lib  # the engine's own stays loaded


# ---------------------------------------------------------------- speech
def test_synth_speech_equals_jax():
    for seed in (7000, 7001):
        assert_same(PSP.synth_utterance(1.5, 16000, seed=seed),
                    JSP.synth_utterance(1.5, 16000, seed=seed))
    for kind in range(3):
        assert_same(PSP.synth_noise(1.0, 16000, kind=kind, seed=9000 + kind),
                    JSP.synth_noise(1.0, 16000, kind=kind, seed=9000 + kind))


# ----------------------------------------------------------------- items
def test_items_equal_jax(corpus):
    """One item through each host path, the port's against the JAX
    package's, numpy RIRs: the same arrays, bit for bit."""
    _, kw = corpus
    opt, clip, sp, noise_paths, _ = item_args(kw, 0)
    for seed in (123, 124):
        args = (opt, clip, sp, noise_paths, seed)
        assert_same(PD.synthesize_item(*args, rir_backend="numpy",
                                       return_meta=True),
                    JD.synthesize_item(*args, rir_backend="numpy",
                                       return_meta=True))
        assert_same(PDM.synthesize_item_parts(*args, rir_backend="numpy"),
                    JDM.synthesize_item_parts(*args, rir_backend="numpy"))
        assert_same(PS.synthesize_item_scene(*args, speech_index=2),
                    JS.synthesize_item_scene(*args, speech_index=2))
    for clip in (1.0, 6.0):
        assert PS.scene_static_dims(opt, clip) == \
            JS.scene_static_dims(opt, clip)
    assert PS.scene_static_dims(opt, 6.0)["l_rir"] == 14016


def test_collation_equals_jax(corpus):
    _, kw = corpus
    opt, clip, sp, noise_paths, _ = item_args(kw, 0)
    parts = [JDM.synthesize_item_parts(opt, clip, sp, noise_paths, s,
                                       rir_backend="numpy")
             for s in (11, 12)]
    for q in (False, True):
        for pad in (0, 14016):
            assert_same(PDM.collate_parts(parts, s_max=6, rir_pad=pad,
                                          quantize=q),
                        JDM.collate_parts(parts, s_max=6, rir_pad=pad,
                                          quantize=q))
    dims = JS.scene_static_dims(opt, clip)
    scenes = [JS.synthesize_item_scene(opt, clip, sp, noise_paths, s)
              for s in (11, 12)]
    assert_same(PS.collate_scenes(scenes, dims),
                JS.collate_scenes(scenes, dims))
    with pytest.raises(ValueError):  # a scene outside the envelope
        PS.collate_scenes(scenes, dict(dims, early_pad=64))
    names = sorted(os.listdir(kw["speech_root"]))
    assert_same(PS.load_corpus_int16(kw["speech_root"], names, 16000),
                JS.load_corpus_int16(kw["speech_root"], names, 16000))


# ---------------------------------------------------------------- loader
def jax_batches(kw, mode, epoch):
    """The JAX loader's batches of ``epoch`` (batch 2, shuffled, seed 3).
    For mode False its in-process path reads ``ds[i]``, which draws every
    epoch with epoch 0's seeds, while its worker path, like the port's
    loader, seeds by (epoch, index): the port is held to the worker
    path."""
    ds = JD.OnlineMcseDataset(JDataConfig(**kw), seed=5)
    loader = JD.BatchLoader(ds, 2, shuffle=True, seed=3, device_mix=mode,
                            rir_pad=14016 if mode else 0)
    if mode:
        return list(loader.epoch(epoch))
    order = loader._epoch_indices(epoch)
    return [JD._collate([JD._worker_synthesize(ds.item_args(int(i), epoch))
                         for i in order[:2]])]


@pytest.mark.parametrize("mode", MODES, ids=["host", "parts", "scene"])
def test_loader_batches_equal_jax(corpus, mode):
    _, kw = corpus
    ds = PD.OnlineMcseDataset(DataConfig(**kw), seed=5)
    loader = PD.BatchLoader(ds, 2, shuffle=True, seed=3, device_mix=mode,
                            rir_pad=14016 if mode else 0)
    for epoch in (0, 1):
        assert_same(list(loader.epoch(epoch)), jax_batches(kw, mode, epoch))


def test_loader_workers_give_the_same_batches(corpus):
    """Two spawned workers, prefetch 1: the batches of 0 workers (the host
    path's worker and the scene worker)."""
    _, kw = corpus
    ds = PD.OnlineMcseDataset(DataConfig(**kw), seed=5)
    for mode in (False, "scene"):
        serial = PD.BatchLoader(ds, 1, shuffle=True, seed=3,
                                device_mix=mode)
        pooled = PD.BatchLoader(ds, 1, num_workers=2, prefetch=1,
                                shuffle=True, seed=3, device_mix=mode)
        try:
            assert_same(list(pooled.epoch(1)), list(serial.epoch(1)))
        finally:
            pooled.close()
        assert pooled._pool is None


def test_loader_mode_matches_host_path(corpus):
    """device_mix='loader' on the CPU against the host path (same seeds):
    the JAX test's tolerance, 2e-5 of the batch's peak, rtol 1e-4."""
    _, kw = corpus
    ds = PD.OnlineMcseDataset(DataConfig(**kw), seed=5)
    (hn, hc, hl), = PD.BatchLoader(ds, 2, shuffle=False).epoch(0)
    (dn, dc, dl), = PD.BatchLoader(ds, 2, shuffle=False, device_mix=True,
                                   device="cpu").epoch(0)
    np.testing.assert_array_equal(hl, dl)
    np.testing.assert_allclose(dn, hn, atol=2e-5 * np.abs(hn).max(),
                               rtol=1e-4)
    np.testing.assert_allclose(dc, hc, atol=2e-5 * np.abs(hc).max(),
                               rtol=1e-4)
    with pytest.raises(ValueError):
        PD.BatchLoader(ds, 2, device_mix="everything")


# --------------------------------------------------------------- trainer
def online_cfg(tmp_path, kw, mode, **train):
    return ExperimentConfig(
        model=ComposedConfig(
            eabnet=EaBNetConfig(M=9, c=16, embed_dim=16, cd1=16, p=2, q=1,
                                norm_type="cLN"),
            gagnet=GaGNetConfig(c=12, cd1=12, p=1, q=1, dilas=(1, 2),
                                norm_type="cLN")),
        data=DataConfig(**dict(kw, device_mix=mode, transfer_int16=True,
                               num_workers=0)),
        train=TrainConfig(**{"batch_size": 1, "wav_len": 1.0,
                             "total_epoch": 10 ** 9, "log_every": 1,
                             "valid_interval": 1e18,
                             "saving_interval": 1e18,
                             "checkpoint_dir": str(tmp_path / f"ckpt_{mode}"),
                             "exp_root": str(tmp_path / f"exp_{mode}"),
                             "fixed_seed": True, **train}))


@pytest.mark.parametrize("mode", [False, "loader", "parts", "scene"],
                         ids=["host", "loader", "parts", "scene"])
def test_trainer_trains_online_and_resumes(corpus, mode):
    """train() in each data mode writes a checkpoint, and a run resumed
    from it continues as a run that did not stop: two speech files of
    batch 1 make an epoch of 2 steps; steps 1-2 (an epoch's end), a
    restart, step 3 against steps 1-3 straight (the trainer resumes at the
    next epoch, whose order and item seeds follow the epoch)."""
    from eabnet_tpu_torch.train.trainer import train

    tmp_path, kw = corpus
    two = tmp_path / "two_speech.txt"
    two.write_text("sp0.wav\nsp2.wav")
    kw = dict(kw, speech_list=str(two))
    cfg = online_cfg(tmp_path / "a", kw, mode)
    hist = train(cfg, max_steps=2, device="cpu", tensorboard=False)
    assert [(h["step"], h["epoch"]) for h in hist] == [(1, 0), (2, 0)]
    assert os.listdir(cfg.train.checkpoint_dir) == ["2.ckpt"]
    assert all(np.isfinite(h[k]) and h["bytes"] > 0 and h["wait"] >= 0
               for h in hist for k in ("eabnet", "postnet", "final"))
    resumed = train(cfg, max_steps=3, device="cpu", tensorboard=False)
    straight = train(online_cfg(tmp_path / "b", kw, mode), max_steps=3,
                     device="cpu", tensorboard=False)
    assert [(h["step"], h["epoch"]) for h in resumed] == [(3, 1)]
    for k in ("eabnet", "postnet", "final"):
        assert resumed[0][k] == pytest.approx(straight[-1][k], rel=1e-6)


def test_logger_without_optional_packages(tmp_path, monkeypatch, capsys):
    """Validation's audio and spectrogram examples need soundfile (through
    tensorboardX) and matplotlib; without them the logger still writes
    scalars and says it logs no audio, and without tensorboardX it logs
    nothing, rather than stopping a training run."""
    from eabnet_tpu_torch.train.loggers import TrainLogger

    pytest.importorskip("tensorboardX")
    monkeypatch.setitem(sys.modules, "soundfile", None)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    logger = TrainLogger(str(tmp_path / "a"))
    logger.audio("x", np.zeros(160), 1, 16000)
    logger.spectrogram("s", np.ones((4, 3)), 1)
    logger.scalars("loss", {"final": 0.5}, 1)
    logger.close()
    assert not logger.audio_enabled and "no audio" in capsys.readouterr().out
    assert os.listdir(tmp_path / "a")
    monkeypatch.setitem(sys.modules, "tensorboardX", None)
    logger = TrainLogger(str(tmp_path / "b"))
    logger.scalars("loss", {"final": 0.5}, 1)
    assert not logger.enabled and not os.path.exists(tmp_path / "b")


# ------------------------------------------------------------------ CLIs
class SerialPool:
    """A stand-in for the JAX datagen's process pool: the same jobs in
    this process, in order."""

    def __init__(self, max_workers=None):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def map(self, fn, jobs):
        return map(fn, jobs)


def test_split_and_datagen_equal_jax(corpus, monkeypatch):
    """cli.split's lists and cli.datagen's wavs (2 spawned workers, --items
    and --reuse-speech) equal the JAX CLIs' files (the JAX datagen run
    serially here), both with the default RIR backend."""
    from eabnet_tpu.cli import datagen as jgen
    from eabnet_tpu.cli import split as jsplit
    from eabnet_tpu_torch.cli import datagen as pgen
    from eabnet_tpu_torch.cli import split as psplit

    tmp_path, kw = corpus
    common = ["--speech-root", kw["speech_root"], "--noise-root",
              kw["noise_root"]]
    for pkg, fn in (("jax", jsplit.main), ("port", psplit.main)):
        fn(common + ["--out-dir", str(tmp_path / pkg / "lists"),
                     "--ratio", "2"])
    lists = sorted(os.listdir(tmp_path / "port" / "lists"))
    assert lists == ["noises_train", "noises_val", "speechs_train",
                     "speechs_val"]
    for name in lists:
        assert (tmp_path / "port" / "lists" / name).read_text() == \
            (tmp_path / "jax" / "lists" / name).read_text()
    monkeypatch.setattr(jgen, "ProcessPoolExecutor", SerialPool)
    for extra in (["--items", "3"], ["--reuse-speech", "--limit", "1"]):
        out = {}
        for pkg, fn, workers in (("jax", jgen.main, "1"),
                                 ("port", pgen.main, "2")):
            out[pkg] = tmp_path / pkg / "set"
            fn(common + ["--output-dir", str(out[pkg]),
                         "--speech-list", kw["speech_list"],
                         "--noise-list", kw["noise_list"],
                         "--mcse-settings", kw["mcse_settings"],
                         "--clip-seconds", "1", "--workers", workers]
               + extra)
        for sub in ("noisy", "clean"):
            names = sorted(os.listdir(out["port"] / sub))
            assert names == sorted(os.listdir(out["jax"] / sub)) and names
            for n in names:
                assert (out["port"] / sub / n).read_bytes() == \
                    (out["jax"] / sub / n).read_bytes(), (sub, n)


def test_resample_cli(tmp_path):
    from eabnet_tpu_torch.cli.resample import main
    from eabnet_tpu_torch.utils.audio_io import read_wav, write_wav

    (tmp_path / "src").mkdir()
    x = np.sin(2 * np.pi * 440 * np.arange(48000) / 48000) * 0.5
    write_wav(str(tmp_path / "src" / "a.wav"), 48000, x)
    main([str(tmp_path / "src"), str(tmp_path / "dst")])
    sr, y = read_wav(str(tmp_path / "dst" / "a.wav"))
    assert sr == 16000 and y.shape == (16000,)
