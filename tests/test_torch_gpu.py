"""Card-only tests of the port's CUDA kernels and of the slice on the card.

Each test carries the ``gpu`` marker and asks for the ``cuda`` fixture,
which skips when no CUDA device is present (decided inside the fixture, so
every xdist worker collects the same tests). This file imports no JAX, so
it also runs on a GPU host where JAX is not installed:

    python -m pytest -m gpu --noconftest -p no:cacheprovider tests/test_torch_gpu.py

Tolerances: the JAX kernel tests' (forward 2e-5; gradients as stated below).
"""

import os
import re

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


# The backward kernels at the shapes of the JAX kernel tests' gradient
# checks and a little beyond, with their tolerances (tests/test_kernels.py:
# d xw1 3e-5, weights 5e-5, rtol 1e-4; tests/test_tcm_chain.py: 6e-5, rtol
# 1e-3) against the plain backward on the same card: d x per entry, the
# weight gradients against their largest entry.
@pytest.mark.gpu
@pytest.mark.parametrize("t,l", [(13, 19), (9, 23), (1, 300), (37, 133)])
def test_lstm_bwd_kernel_matches_plain_on_card(cuda, t, l):
    from eabnet_tpu_torch.kernels import lstm_bf as K

    g = torch.Generator(device=cuda).manual_seed(t + l)
    xw1 = torch.randn(t, l, 256, generator=g, device=cuda)
    dy = torch.randn(t, l, 64, generator=g, device=cuda)
    w = [torch.randn(s, generator=g, device=cuda) * 0.2
         for s in ((64, 256), (64, 256), (64, 256), (256,))]
    with torch.no_grad():
        states = K._launch_fwd(xw1, *w, states=True)
        for a, b in zip(states, K.double_lstm_states_reference(xw1, *w)):
            assert (a - b).abs().max().item() <= ATOL
        before = K.double_lstm.bwd_launches
        got = K._launch_bwd(xw1, dy, *states, *w)
        ref = K.double_lstm_bwd_reference(xw1, dy, *states, *w)
    assert K.double_lstm.bwd_launches == before + 1
    torch.testing.assert_close(got[0], ref[0], atol=3e-5, rtol=1e-4)
    # the weight gradients are sums over T x L rows: float32 rounding is
    # relative to their largest entries, so they are held against those
    for a, b in zip(got[1:], ref[1:]):
        assert (a - b).abs().max().item() <= \
            5e-5 + 1e-4 * b.abs().max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("twin,kd1,dils", CASES, ids=IDS)
@pytest.mark.parametrize("b,t", [(2, 33), (1, 1), (3, 70)])
def test_tcm_bwd_kernel_matches_plain_on_card(cuda, twin, kd1, dils, b, t):
    from eabnet_tpu_torch.kernels import tcm_chain as K

    group = random_group(twin, kd1, dils, cuda, seed=b * t + 1)
    g = torch.Generator(device=cuda).manual_seed(b + t)
    x = torch.randn(b, t, 256, generator=g, device=cuda)
    dy = torch.randn(b, t, 256, generator=g, device=cuda)
    with torch.no_grad():
        w = group.stacked_weights()
        before = K.tcm_chain.bwd_launches
        dx, dw, acts = K._launch_bwd(x, dy, w, group.dilations, twin,
                                     activations=True)
        fwd = K.tcm_chain_activations_reference(x, w, group.dilations, twin)
        # the reverse walk against the plain one on the kernel's recomputed
        # forward, so a PReLU input within float32 noise of 0 takes the
        # same branch in both
        rdx, rdw = K.tcm_chain_bwd_reference(x, dy, w, group.dilations, twin,
                                             acts=acts)
        pdx, pdw = K.tcm_chain_bwd_reference(x, dy, w, group.dilations, twin)
    assert K.tcm_chain.bwd_launches == before + 1
    for k in ("x", "h"):
        torch.testing.assert_close(acts[k], fwd[k], atol=ATOL, rtol=1e-5)
    for i in range(2 if twin else 1):
        torch.testing.assert_close(acts["c"][i], fwd["c"][i], atol=ATOL,
                                   rtol=1e-5)

    def check(gdx, gdw):
        torch.testing.assert_close(dx, gdx, atol=6e-5, rtol=1e-3)
        for a, r in zip(dw, gdw):  # sums over B x T rows, as for the LSTM
            assert (a - r).abs().max().item() <= \
                6e-5 + 1e-3 * r.abs().max().item()

    check(rdx, rdw)
    # PReLU inputs (h and g) that take the other branch in the two
    # forwards lie within the forward tolerance of 0; with none, the kernel
    # also matches the plain backward on its own forward
    flips = 0
    for a, r in zip(K.prelu_inputs(acts, twin), K.prelu_inputs(fwd, twin)):
        f = (a > 0) != (r > 0)
        flips += int(f.sum())
        near = torch.maximum(a[f].abs(), r[f].abs())
        assert (near <= ATOL + 1e-5 * r[f].abs()).all()
    if not flips:
        check(pdx, pdw)
    if not twin:
        assert not dw[2].any() and not dw[4][:, 1].any()


@pytest.mark.gpu
def test_train_step_on_card_matches_cpu(cuda):
    """One port train step of a small composed model (C = H = 64, as the
    kernels take) on the card and on the CPU from one init and batch: the
    card runs each kernel forward and backward, the CPU the plain
    versions."""
    from eabnet_tpu_torch.config import (ComposedConfig, EaBNetConfig,
                                         ExperimentConfig, GaGNetConfig,
                                         TrainConfig)
    from eabnet_tpu_torch.kernels.lstm_bf import double_lstm
    from eabnet_tpu_torch.kernels.tcm_chain import tcm_chain
    from eabnet_tpu_torch.train import step as P

    cfg = ExperimentConfig(
        model=ComposedConfig(
            eabnet=EaBNetConfig(c=8, M=3, embed_dim=8, p=2, q=1),
            gagnet=GaGNetConfig(c=8, p=1, q=1, dilas=(1, 2))),
        train=TrainConfig(lr=5e-4))
    rng = np.random.default_rng(0)
    noisy = torch.from_numpy(
        (rng.standard_normal((2, 3, 4000)) * 0.1).astype(np.float32))
    clean = torch.from_numpy(
        (rng.standard_normal((2, 4000)) * 0.1).astype(np.float32))
    n = torch.tensor([4000, 3300], dtype=torch.int32)
    states = {d: P.create_train_state(cfg, d, seed=0) for d in ("cpu", cuda)}
    step = P.make_train_step(cfg)
    counts = (double_lstm.launches, double_lstm.bwd_launches,
              tcm_chain.launches, tcm_chain.bwd_launches)
    losses = {}
    for d, s in states.items():
        _, losses[d] = step(s, noisy.to(d), clean.to(d), n.to(d))
    after = (double_lstm.launches, double_lstm.bwd_launches,
             tcm_chain.launches, tcm_chain.bwd_launches)
    # 1 EaBNet group + 1 glance + 2 gaze groups
    assert tuple(a - b for a, b in zip(after, counts)) == (1, 1, 4, 4)
    for k in ("eabnet", "postnet", "final"):
        assert float(losses[cuda][k]) == pytest.approx(
            float(losses["cpu"][k]), rel=1e-5)
    lr = cfg.train.lr
    cpu, card = states["cpu"], states[cuda]
    for (name, a), b in zip(cpu.model.named_parameters(),
                            card.model.parameters()):
        # Adam's bound: an element whose gradient is at float32 noise
        # level may move by +-lr in either run
        assert (a - b.cpu()).abs().max().item() <= 2.5 * lr, name
        if re.search(r"\.(enco|deco)_\d+\.conv\.bias$", name):
            continue  # a bias an instance norm cancels: noise gradients
        mu_a, mu_b = cpu.opt_state.mu[name], card.opt_state.mu[name].cpu()
        assert (mu_a - mu_b).abs().max().item() <= \
            0.05 * mu_a.abs().max().item(), name
