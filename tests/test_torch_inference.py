"""The port's Enhancer and CLI on the CPU: padding and trimming, stage and
option handling, and the command line on a short synthetic 9-mic wav with
the release model."""

import os
import subprocess
import sys

import numpy as np
import pytest

from eabnet_tpu_torch.config import ExperimentConfig
from eabnet_tpu_torch.inference import Enhancer, load_enhancer
from eabnet_tpu_torch.utils.audio_io import read_wav, write_wav

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXP = os.path.join(ROOT, "release", "composed_9mic")


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
    cfg = ExperimentConfig.load(os.path.join(EXP, "config.json"))
    for kw in ({"compute_dtype": "bfloat16"}, {"compute_dtype": "int8w"},
               {"mesh": object()}, {"shard_freq": True}):
        with pytest.raises(NotImplementedError):
            Enhancer(cfg, {}, device="cpu", **kw)
    with pytest.raises(ValueError):
        Enhancer(cfg, {}, output="esti2", device="cpu")
    with pytest.raises(ValueError):
        Enhancer(cfg, {}, pad_mode="none", device="cpu")


def test_cln_release_is_refused_not_rerouted():
    """release/eabnet_9mic_cln loads its config, then refuses to build:
    cLN is a later slice of the port."""
    with pytest.raises(NotImplementedError, match="cLN"):
        load_enhancer(os.path.join(ROOT, "release", "eabnet_9mic_cln"),
                      device="cpu")


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

    from eabnet_tpu_torch.cli.enhance import main

    for fn in (Enhancer, load_enhancer):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    assert "default: cuda" in inspect.getsource(main)
