"""The PyTorch port at full width with the second shipped model,
release/eabnet_9mic_cln (cLN in both nets, the non-squeezed GaGNet), on a
validation item, against the committed golden.

The golden (tests/golden/torch_port_eabnet_9mic_cln_00000.npz) holds the
JAX package's float32 ``esti`` and ``esti0`` waveforms for
release/val_set/noisy/00000.wav; ``chip_smoke.py`` holds the port's CUDA
path against it on the card. Rewrite it with

    python tests/test_torch_release_cln.py --regen
"""

import os
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXP = os.path.join(ROOT, "release", "eabnet_9mic_cln")
ITEM = os.path.join(ROOT, "release", "val_set", "noisy", "00000.wav")
GOLDEN = os.path.join(ROOT, "tests", "golden",
                      "torch_port_eabnet_9mic_cln_00000.npz")
STAGES = ("esti", "esti0")
# As tests/test_torch_release.py: float32 rounding differences between the
# packages sit far above 80 dB, a wrong layout or norm far below 20 dB.
MIN_SNR_DB = 80.0


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for the port: on a host that other test workers
    load, more threads mostly wait on each other."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def snr_db(ref, est):
    with np.errstate(divide="ignore"):  # identical signals: +inf dB
        return 10 * np.log10(np.sum(ref ** 2) / np.sum((ref - est) ** 2))


def jax_outputs():
    from eabnet_tpu.inference import load_enhancer
    from eabnet_tpu.utils.audio_io import read_wav

    _, noisy = read_wav(ITEM)
    return {s: np.asarray(load_enhancer(EXP, output=s)(noisy), np.float32)
            for s in STAGES}


@pytest.fixture(scope="module")
def port_out():
    from eabnet_tpu_torch.inference import load_enhancer
    from eabnet_tpu_torch.utils.audio_io import read_wav

    _, noisy = read_wav(ITEM)
    enh = load_enhancer(EXP, device="cpu")
    out = {}
    for s in STAGES:
        enh.output = s
        out[s] = enh(noisy)
    return out


@pytest.mark.parametrize("stage", STAGES)
def test_jax_package_reproduces_golden(stage):
    import jax

    del jax  # the JAX package on the CPU, as tests/conftest.py pins it
    golden = np.load(GOLDEN)[stage]
    assert golden.dtype == np.float32 and golden.shape == (96000,)
    from eabnet_tpu.inference import load_enhancer
    from eabnet_tpu.utils.audio_io import read_wav

    _, noisy = read_wav(ITEM)
    out = np.asarray(load_enhancer(EXP, output=stage)(noisy), np.float32)
    assert snr_db(golden, out) >= MIN_SNR_DB


@pytest.mark.parametrize("stage", STAGES)
def test_port_matches_golden(port_out, stage):
    golden = np.load(GOLDEN)[stage]
    ours = port_out[stage]
    assert ours.shape == golden.shape and np.isfinite(ours).all()
    assert snr_db(golden, ours) >= MIN_SNR_DB


def test_stages_differ(port_out):
    """esti (post-filtered) is not esti0 (beamformer alone)."""
    assert snr_db(port_out["esti0"], port_out["esti"]) < 40.0


if __name__ == "__main__":
    if "--regen" not in sys.argv:
        sys.exit("usage: python tests/test_torch_release_cln.py --regen")
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, ROOT)
    import jax

    jax.config.update("jax_platforms", "cpu")
    np.savez(GOLDEN, **jax_outputs())
    print(f"wrote {GOLDEN}")
