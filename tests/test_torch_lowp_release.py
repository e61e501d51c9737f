"""bfloat16 and int8w serving of both released models at full width on the
CPU, against the JAX package's Enhancer in the same compute dtype.

The goldens (tests/golden/torch_port_<model>_00000_lowp.npz) hold the JAX
package's ``esti`` and ``esti0`` of release/val_set/noisy/00000.wav in
bfloat16 and int8w (keys ``<stage>_<dtype>``), made with the shipped
configs; the float32 ones are the existing goldens. ``chip_smoke.py`` and
the card tests hold the port's CUDA path against them. Rewrite them with

    python tests/test_torch_lowp_release.py --regen

The rule (the model-level rule of PERF.md §2): let R be the SNR of the JAX
package's bf16 output against its float32 output on the same input (bf16
alone moves the JAX output that far). The port's bf16 must reach R - 6 dB
against the JAX bf16 (two independent bf16 roundings of one float32
function sit about 3 dB closer to it than to each other, and the port
rounds at other places: its TCN chain keeps the Pallas kernel's float32
trunk, its LSTM head float32 state) and R - 3 dB against the JAX float32.
int8w is held to the JAX int8w by the first rule with R of bf16 (the
dequantized weights are the same bits), and to the port's own float32
output by the JAX int8w test's criteria (tests/test_quantize.py: relative
error < 0.15, correlation > 0.99).
"""

import os
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ITEM = os.path.join(ROOT, "release", "val_set", "noisy", "00000.wav")
MODELS = ("composed_9mic", "eabnet_9mic_cln")
LOWP = ("bfloat16", "int8w")
STAGES = ("esti", "esti0")


def exp_dir(model):
    return os.path.join(ROOT, "release", model)


def golden_path(model, lowp=True):
    return os.path.join(ROOT, "tests", "golden", f"torch_port_{model}_00000"
                        + ("_lowp" if lowp else "") + ".npz")


def snr_db(ref, est):
    with np.errstate(divide="ignore"):  # identical signals: +inf dB
        return 10 * np.log10(np.sum(ref ** 2) / np.sum((ref - est) ** 2))


def model_rule(model, dtype, stage, ours, golden):
    """The failures of ``ours`` under the model-level rule (module doc),
    as messages; empty when it passes."""
    f32 = np.load(golden_path(model, lowp=False))[stage]
    r = snr_db(f32, golden[f"{stage}_bfloat16"])
    bad = []
    to_ref = snr_db(golden[f"{stage}_{dtype}"], ours)
    if to_ref < r - 6:
        bad.append(f"{dtype} vs JAX {dtype}: {to_ref:.2f} dB < R - 6 = "
                   f"{r - 6:.2f}")
    if dtype == "bfloat16" and snr_db(f32, ours) < r - 3:
        bad.append(f"bf16 vs JAX f32: {snr_db(f32, ours):.2f} dB < R - 3 = "
                   f"{r - 3:.2f}")
    return bad


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
def noisy():
    from eabnet_tpu_torch.utils.audio_io import read_wav

    return read_wav(ITEM)[1]


@pytest.mark.parametrize("model", MODELS)
def test_goldens_hold_both_stages_of_both_modes(model):
    golden = np.load(golden_path(model))
    f32 = np.load(golden_path(model, lowp=False))
    assert sorted(golden.files) == sorted(f"{s}_{d}" for s in STAGES
                                          for d in LOWP)
    for key in golden.files:
        out = golden[key]
        assert out.dtype == np.float32 and out.shape == (96000,), key
        assert np.isfinite(out).all() and np.std(out) > 0, key
        stage = key.split("_")[0]
        # bf16 moves the output, but not past recognition
        assert 5.0 < snr_db(f32[stage], out) < 80.0, key


@pytest.mark.parametrize("dtype", LOWP)
@pytest.mark.parametrize("model", MODELS)
def test_port_meets_the_model_rule_at_full_width(model, dtype, noisy):
    """The port on the CPU (the kernels' plain versions), stage esti,
    against the JAX goldens by the model-level rule."""
    from eabnet_tpu_torch.inference import load_enhancer

    ours = load_enhancer(exp_dir(model), compute_dtype=dtype,
                         device="cpu")(noisy)
    assert ours.shape == (96000,) and np.isfinite(ours).all()
    assert not model_rule(model, dtype, "esti", ours,
                          np.load(golden_path(model)))


def jax_outputs(model):
    import jax

    from eabnet_tpu.inference import load_enhancer
    from eabnet_tpu.utils.audio_io import read_wav

    del jax
    _, noisy = read_wav(ITEM)
    return {f"{s}_{d}": np.asarray(load_enhancer(
        exp_dir(model), output=s, compute_dtype=d)(noisy), np.float32)
        for d in LOWP for s in STAGES}


if __name__ == "__main__":
    if "--regen" not in sys.argv:
        sys.exit("usage: python tests/test_torch_lowp_release.py --regen")
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, ROOT)
    import jax

    jax.config.update("jax_platforms", "cpu")
    for name in MODELS:
        np.savez(golden_path(name), **jax_outputs(name))
        print(f"wrote {golden_path(name)}")
