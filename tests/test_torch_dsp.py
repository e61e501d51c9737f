"""The port's STFT front end against the JAX package's, at the tolerances
of tests/test_stft.py (the same seeded numpy inputs into both)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eabnet_tpu import dsp as jdsp
from eabnet_tpu.config import StftConfig as JStftConfig
from eabnet_tpu_torch import dsp
from eabnet_tpu_torch.config import StftConfig

FFT, HOP, WIN = 320, 160, 320


def test_hann_window_matches_jax():
    np.testing.assert_allclose(dsp.hann_window(WIN).numpy(),
                               np.asarray(jdsp.hann_window(WIN)), atol=1e-6)


@pytest.mark.parametrize("n", [96000, 16000, 12345])
def test_stft_matches_jax(rng, n):
    x = rng.standard_normal((3, n)).astype(np.float32)
    ref = np.asarray(jdsp.stft(jnp.asarray(x), FFT, HOP, WIN))
    ours = dsp.stft(torch.from_numpy(x), FFT, HOP, WIN).numpy()
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, atol=2e-3, rtol=1e-4)
    assert np.abs(ours - ref).max() / np.abs(ref).max() < 1e-5


@pytest.mark.parametrize("hop", [160, 96], ids=["divides", "gather"])
def test_istft_matches_jax(rng, hop):
    spec = rng.standard_normal((2, 50, FFT // 2 + 1, 2)).astype(np.float32)
    ref = np.asarray(jdsp.istft(jnp.asarray(spec), FFT, hop, WIN))
    ours = dsp.istft(torch.from_numpy(spec), FFT, hop, WIN).numpy()
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, atol=1e-4)


def test_stft_istft_roundtrip(rng):
    x = rng.standard_normal((2, 16000)).astype(np.float32)
    spec = dsp.stft(torch.from_numpy(x), FFT, HOP, WIN)
    y = dsp.istft(spec, FFT, HOP, WIN, length=x.shape[-1]).numpy()
    np.testing.assert_allclose(y, x, atol=1e-4)


@pytest.mark.parametrize("power", [0.5, 0.3])
def test_power_compress_matches_jax(rng, power):
    ri = rng.standard_normal((4, 7, 2)).astype(np.float32)
    ri[0, 0] = 0.0  # exact zeros stay zero
    ref = np.asarray(jdsp.power_compress(jnp.asarray(ri), power))
    ours = dsp.power_compress(torch.from_numpy(ri), power).numpy()
    np.testing.assert_allclose(ours, ref, atol=1e-5)
    assert (ours[0, 0] == 0).all()
    back = dsp.power_uncompress(torch.from_numpy(ours), power).numpy()
    np.testing.assert_allclose(back, ri, atol=1e-5)


def test_prepare_data_matches_jax(rng):
    noisy = rng.standard_normal((2, 9, 16000)).astype(np.float32) * 0.1
    target = rng.standard_normal((2, 16000)).astype(np.float32) * 0.1
    ref_n, ref_t = jdsp.prepare_data(jnp.asarray(noisy), jnp.asarray(target),
                                     JStftConfig())
    ours_n, ours_t = dsp.prepare_data(torch.from_numpy(noisy),
                                      torch.from_numpy(target), StftConfig())
    assert ours_n.shape == ref_n.shape == (2, 101, 161, 9, 2)
    assert ours_t.shape == ref_t.shape == (2, 2, 101, 161)
    np.testing.assert_allclose(ours_n.numpy(), np.asarray(ref_n), atol=5e-4)
    np.testing.assert_allclose(ours_t.numpy(), np.asarray(ref_t), atol=5e-4)


@pytest.mark.parametrize("decompress", [True, False])
def test_stft_to_wav_matches_jax(rng, decompress):
    esti = rng.standard_normal((2, 2, 60, 161)).astype(np.float32) * 0.1
    ref = np.asarray(jdsp.stft_to_wav(
        jnp.asarray(esti), JStftConfig(decompress_output=decompress)))
    ours = dsp.stft_to_wav(torch.from_numpy(esti),
                           StftConfig(decompress_output=decompress)).numpy()
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, atol=1e-4)
