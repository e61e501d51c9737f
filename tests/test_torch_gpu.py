"""Card-only tests of the port's CUDA kernels and of the slice on the card.

Each test carries the ``gpu`` marker and asks for the ``cuda`` fixture,
which skips when no CUDA device is present (decided inside the fixture, so
every xdist worker collects the same tests). This file imports no JAX, so
it also runs on a GPU host where JAX is not installed:

    python -m pytest -m gpu --noconftest -p no:cacheprovider tests/test_torch_gpu.py

Tolerance 2e-5, the JAX kernel tests' forward tolerance.
"""

import os

import numpy as np
import pytest
import torch

from eabnet_tpu_torch.kernels.lstm_bf import (double_lstm,
                                              double_lstm_reference)
from eabnet_tpu_torch.kernels.tcm_chain import tcm_chain, tcm_chain_reference
from eabnet_tpu_torch.nn.blocks import SqueezedTCNGroup

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 2e-5
CASES = [(True, 5, (1, 2, 4, 8, 16, 32)), (False, 3, (1, 2, 5, 9))]
IDS = ["twin", "single"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def random_group(twin, kd1, dils, device, seed=0):
    """A port TCN group with seeded weights, slopes, scales and biases."""
    torch.manual_seed(seed)
    group = SqueezedTCNGroup(kd1, 64, 256, dils, twin_gate=twin)
    with torch.no_grad():
        for name, p in group.named_parameters():
            if name.endswith("alpha"):
                p.uniform_(0.0, 0.5)
            elif name.endswith("scale"):
                p.uniform_(0.5, 1.5)
            elif name.endswith("norm.bias"):
                p.uniform_(-0.5, 0.5)
    return group.to(device)


@pytest.mark.gpu
@pytest.mark.parametrize("t,l", [(701, 161), (37, 5), (1, 300), (9, 1127)])
def test_lstm_kernel_matches_plain_on_card(cuda, t, l):
    g = torch.Generator(device=cuda).manual_seed(t)
    args = [torch.randn(t, l, 256, generator=g, device=cuda)] + [
        torch.randn(s, generator=g, device=cuda) * 0.2
        for s in ((64, 256), (64, 256), (64, 256), (256,))]
    before = double_lstm.launches
    with torch.no_grad():
        out = double_lstm(*args)
        ref = double_lstm_reference(*args)
    assert double_lstm.launches == before + 1
    assert out.shape == (t, l, 64)
    assert (out - ref).abs().max().item() <= ATOL


@pytest.mark.gpu
@pytest.mark.parametrize("twin,kd1,dils", CASES, ids=IDS)
@pytest.mark.parametrize("b,t", [(1, 701), (3, 33), (2, 1), (9, 130)])
def test_tcm_kernel_matches_plain_on_card(cuda, twin, kd1, dils, b, t):
    group = random_group(twin, kd1, dils, cuda, seed=b * t)
    x = torch.randn(b, t, 256, generator=torch.Generator(
        device=cuda).manual_seed(b + t), device=cuda)
    before = tcm_chain.launches
    with torch.no_grad():
        w = group.stacked_weights()
        out = tcm_chain(x, w, group.dilations, twin)
        ref = tcm_chain_reference(x, w, group.dilations, twin)
    assert tcm_chain.launches == before + 1
    assert (out - ref).abs().max().item() <= ATOL


@pytest.mark.gpu
def test_kernels_refuse_what_they_do_not_take(cuda):
    x = torch.randn(4, 3, 128, device=cuda)  # H = 32
    w = torch.randn(32, 128, device=cuda)
    with torch.no_grad(), pytest.raises(ValueError):
        double_lstm(x, w, w, w, torch.randn(128, device=cuda))
    group = SqueezedTCNGroup(3, 32, 256, (1, 2), twin_gate=False).to(cuda)
    with torch.no_grad(), pytest.raises(ValueError):  # C = 32
        tcm_chain(torch.randn(1, 5, 256, device=cuda),
                  group.stacked_weights(), (1, 2), False)


@pytest.mark.gpu
def test_slice_on_card_matches_golden_through_the_kernels(cuda):
    from eabnet_tpu_torch.inference import load_enhancer
    from eabnet_tpu_torch.utils.audio_io import read_wav

    golden = np.load(os.path.join(
        ROOT, "tests", "golden", "torch_port_composed_9mic_00000.npz"))
    _, noisy = read_wav(os.path.join(ROOT, "release", "val_set", "noisy",
                                     "00000.wav"))
    enh = load_enhancer(os.path.join(ROOT, "release", "composed_9mic"),
                        device="cuda")
    l0, t0 = double_lstm.launches, tcm_chain.launches
    out = enh(noisy)
    assert (double_lstm.launches - l0, tcm_chain.launches - t0) == (1, 21)
    ref = golden["esti"]
    snr = 10 * np.log10(np.sum(ref ** 2) / np.sum((ref - out) ** 2))
    assert snr >= 40.0
