"""The port's Enhancer and CLI on the CPU: padding and trimming, stage and
option handling, and the command line on a short synthetic 9-mic wav with
the release model."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from eabnet_tpu_torch.config import ExperimentConfig
from eabnet_tpu_torch.inference import Enhancer, load_enhancer
from eabnet_tpu_torch.nn.blocks import SqueezedTCNGroup
from eabnet_tpu_torch.utils.audio_io import read_wav, write_wav

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXP = os.path.join(ROOT, "release", "composed_9mic")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for the port: on a host that other test workers
    load, more threads mostly wait on each other."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def enhancer():
    return load_enhancer(EXP, output="esti0", device="cpu")


def noisy(n, seed=0, m=9):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, n)) * 0.05).astype(np.float32)


def test_batch_padding_and_trimming(enhancer):
    a, b = noisy(5000, 1), noisy(9000, 2)
    outs = enhancer.enhance_batch([a, b])
    assert [o.shape for o in outs] == [(5000,), (9000,)]
    assert all(np.isfinite(o).all() for o in outs)
    assert enhancer.enhance_batch([]) == []
    with pytest.raises(ValueError):
        enhancer.enhance_batch([a, noisy(100, m=8)])


def test_mic_permutation(enhancer):
    x = noisy(4000, 3)
    perm = [8, 0, 1, 2, 3, 4, 5, 6, 7]
    np.testing.assert_array_equal(enhancer(x, mic_permutation=perm),
                                  enhancer(x[perm]))
    with pytest.raises(ValueError):
        enhancer(x, mic_permutation=[9])


def test_pad_modes_differ_only_at_the_end():
    cfg = ExperimentConfig.load(os.path.join(EXP, "config.json"))
    from eabnet_tpu_torch.checkpoint import latest_checkpoint, load_params

    params = load_params(latest_checkpoint(EXP))
    x = noisy(16000, 4)
    tail = Enhancer(cfg, params, output="esti0", device="cpu")(x)
    ref = Enhancer(cfg, params, output="esti0", device="cpu",
                   pad_mode="reference")(x)
    assert tail.shape == ref.shape == (16000,)
    assert not np.array_equal(tail, ref)


def test_options_outside_the_slice_are_refused():
    """Meshes and frequency sharding are refused; bfloat16 and int8w, once
    refused, now serve on the CPU (finite, the output's shape, close to
    float32 by tests/test_quantize.py's criteria); an unknown compute
    dtype is a ValueError, as in the JAX package."""
    cfg = ExperimentConfig.load(os.path.join(EXP, "config.json"))
    for kw in ({"mesh": object()}, {"shard_freq": True}):
        with pytest.raises(NotImplementedError):
            Enhancer(cfg, {}, device="cpu", **kw)
    with pytest.raises(ValueError):
        Enhancer(cfg, {}, output="esti2", device="cpu")
    with pytest.raises(ValueError):
        Enhancer(cfg, {}, pad_mode="none", device="cpu")
    with pytest.raises(ValueError):
        Enhancer(cfg, {}, compute_dtype="float16", device="cpu")
    x = noisy(16000, 9)
    ref = load_enhancer(EXP, output="esti0", device="cpu")(x)
    for dtype in ("bfloat16", "int8w"):
        out = load_enhancer(EXP, output="esti0", compute_dtype=dtype,
                            device="cpu")(x)
        assert out.shape == (16000,) and np.isfinite(out).all(), dtype
        err = np.linalg.norm(out - ref) / np.linalg.norm(ref)
        assert err < 0.15 and np.corrcoef(out, ref)[0, 1] > 0.99, dtype


def test_cln_release_is_refused_not_rerouted():
    """release/eabnet_9mic_cln loads and enhances on the CPU, its cLN TCN
    groups on the per-TCM route (the TCM-chain kernel takes causal IN
    only), while its config with batch norms is refused by the Enhancer
    (it applies params only, as the JAX package's does), not rerouted."""
    cln = os.path.join(ROOT, "release", "eabnet_9mic_cln")
    enh = load_enhancer(cln, output="esti0", device="cpu")
    groups = [m for m in enh.model.modules()
              if isinstance(m, SqueezedTCNGroup)]
    assert len(groups) == 3 + 3 * 2 * 3 and not any(g.chain for g in groups)
    x = noisy(6000, 8)
    out = enh(x)
    assert out.shape == (6000,) and np.isfinite(out).all()
    assert np.std(out) > 0
    d = json.loads(ExperimentConfig.load(
        os.path.join(cln, "config.json")).to_json())
    d["model"]["gagnet"]["norm_type"] = "BN"
    with pytest.raises(NotImplementedError, match="BN"):
        Enhancer(ExperimentConfig.from_dict(d), {}, device="cpu")


def test_cli_enhances_a_short_wav(tmp_path, enhancer):
    x = noisy(8000, 5)
    src, dst = tmp_path / "in.wav", tmp_path / "out.wav"
    write_wav(str(src), 16000, x, dtype="float")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run(
        [sys.executable, "-m", "eabnet_tpu_torch.cli.enhance", str(src),
         str(dst), "--exp-root", EXP, "--output-stage", "esti0",
         "--device", "cpu"], cwd=str(tmp_path), env=env,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    sr, y = read_wav(str(dst))
    assert sr == 16000 and y.shape == (8000,)
    np.testing.assert_allclose(y, enhancer(x), atol=1e-6)


def test_cli_compute_dtype(tmp_path):
    """--compute-dtype reaches the Enhancer: the CLI's bf16 and int8w
    outputs are the library's on the CPU."""
    x = noisy(6000, 10)
    src = tmp_path / "in.wav"
    write_wav(str(src), 16000, x, dtype="float")
    from eabnet_tpu_torch.cli.enhance import main

    for dtype in ("bfloat16", "int8w"):
        dst = tmp_path / f"{dtype}.wav"
        main([str(src), str(dst), "--exp-root", EXP, "--output-stage",
              "esti0", "--compute-dtype", dtype, "--device", "cpu"])
        ref = load_enhancer(EXP, output="esti0", compute_dtype=dtype,
                            device="cpu")(x)
        np.testing.assert_allclose(read_wav(str(dst))[1], ref, atol=1e-6)


def test_cli_directory_mode(tmp_path, enhancer):
    src, dst = tmp_path / "in", tmp_path / "out"
    src.mkdir()
    for i, n in enumerate((3000, 4000)):
        write_wav(str(src / f"{i}.wav"), 16000, noisy(n, 6 + i),
                  dtype="float")
    from eabnet_tpu_torch.cli.enhance import main

    main([str(src), str(dst), "--exp-root", EXP, "--output-stage", "esti0",
          "--device", "cpu", "--batch-size", "2"])
    assert sorted(os.listdir(dst)) == ["0.wav", "1.wav"]
    assert read_wav(str(dst / "1.wav"))[1].shape == (4000,)


def test_entry_points_default_to_the_card():
    """The device is the caller's choice, the card unless asked."""
    import inspect

    from eabnet_tpu_torch.cli import enhance, stream, test, train

    for fn in (Enhancer, load_enhancer):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    for cli in (enhance, stream, test, train):
        assert "default: cuda" in inspect.getsource(cli.main)
