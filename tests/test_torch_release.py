"""The PyTorch port at full width: release/composed_9mic on a validation
item, against the JAX package's Enhancer and the committed golden.

The golden (tests/golden/torch_port_composed_9mic_00000.npz) holds the JAX
package's float32 ``esti`` and ``esti0`` waveforms for
release/val_set/noisy/00000.wav; ``chip_smoke.py`` holds the port's CUDA
path against it on the card. Rewrite it with

    python tests/test_torch_release.py --regen
"""

import os
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXP = os.path.join(ROOT, "release", "composed_9mic")
ITEM = os.path.join(ROOT, "release", "val_set", "noisy", "00000.wav")
GOLDEN = os.path.join(ROOT, "tests", "golden",
                      "torch_port_composed_9mic_00000.npz")
STAGES = ("esti", "esti0")
# The port on the CPU reproduces the JAX package to ~116 dB SNR at full
# width (float32 rounding differences only); 80 dB leaves room for other
# BLAS builds while any real divergence (a wrong layout, a missed norm)
# falls below 20 dB.
MIN_SNR_DB = 80.0


def snr_db(ref, est):
    with np.errstate(divide="ignore"):  # identical signals: +inf dB
        return 10 * np.log10(np.sum(ref ** 2) / np.sum((ref - est) ** 2))


def jax_outputs():
    import jax

    from eabnet_tpu.inference import load_enhancer
    from eabnet_tpu.utils.audio_io import read_wav

    del jax
    _, noisy = read_wav(ITEM)
    return {s: np.asarray(load_enhancer(EXP, output=s)(noisy), np.float32)
            for s in STAGES}


@pytest.fixture(scope="module")
def jax_out():
    return jax_outputs()


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
def test_jax_package_reproduces_golden(jax_out, stage):
    golden = np.load(GOLDEN)[stage]
    assert golden.dtype == np.float32 and golden.shape == (96000,)
    assert snr_db(golden, jax_out[stage]) >= MIN_SNR_DB


@pytest.mark.parametrize("stage", STAGES)
def test_port_matches_jax_enhancer_full_width(jax_out, port_out, stage):
    ours, ref = port_out[stage], jax_out[stage]
    assert ours.shape == ref.shape and np.isfinite(ours).all()
    assert snr_db(ref, ours) >= MIN_SNR_DB
    np.testing.assert_allclose(ours, ref, atol=1e-6)


def test_port_matches_golden(port_out):
    golden = np.load(GOLDEN)
    for s in STAGES:
        assert snr_db(golden[s], port_out[s]) >= MIN_SNR_DB


def test_stages_differ(port_out):
    """esti (post-filtered) is not esti0 (beamformer alone)."""
    assert snr_db(port_out["esti0"], port_out["esti"]) < 40.0


if __name__ == "__main__":
    if "--regen" not in sys.argv:
        sys.exit("usage: python tests/test_torch_release.py --regen")
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, ROOT)
    import jax

    jax.config.update("jax_platforms", "cpu")
    np.savez(GOLDEN, **jax_outputs())
    print(f"wrote {GOLDEN}")
