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
from eabnet_tpu_torch.kernels.tcm_chain import (bf16_trunks, tcm_chain,
                                                tcm_chain_reference)
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


# The forward's edges: lanes per block from the SM count (L = 161: two;
# 1,127: nine, an odd count, so the block's last pair of lanes has one
# idle; 2,576: twenty, more than 16 in one wave; 133: one lane past a full
# wave of one-lane blocks; 5 and 1: one lane per block), and one step.
LSTM_FWD_SHAPES = [(701, 161), (37, 5), (1, 300), (9, 1127), (3, 2576),
                   (5, 133), (1, 1), (6, 1)]


def lstm_args(cuda, t, l):
    g = torch.Generator(device=cuda).manual_seed(t)
    return [torch.randn(t, l, 256, generator=g, device=cuda)] + [
        torch.randn(s, generator=g, device=cuda) * 0.2
        for s in ((64, 256), (64, 256), (64, 256), (256,))]


@pytest.mark.gpu
@pytest.mark.parametrize("t,l", LSTM_FWD_SHAPES)
def test_lstm_kernel_matches_plain_on_card(cuda, t, l):
    args = lstm_args(cuda, t, l)
    before = double_lstm.launches
    with torch.no_grad():
        out = double_lstm(*args)
        again = double_lstm(*args)
        ref = double_lstm_reference(*args)
    assert double_lstm.launches == before + 2
    assert out.shape == (t, l, 64)
    assert (out - ref).abs().max().item() <= ATOL
    assert torch.equal(out, again)  # no atomics: the same bits again


@pytest.mark.gpu
@pytest.mark.parametrize("t,l", LSTM_FWD_SHAPES)
def test_lstm_train_forward_matches_plain_on_card(cuda, t, l):
    """The training variant's four outputs (h1, c1, h2, c2), which the
    backward reads, against the plain version's."""
    from eabnet_tpu_torch.kernels import lstm_bf as K

    args = lstm_args(cuda, t, l)
    with torch.no_grad():
        got = K._launch_fwd(*args, states=True)
        again = K._launch_fwd(*args, states=True)
        ref = K.double_lstm_states_reference(*args)
    for a, b, c in zip(got, ref, again):
        assert a.shape == (t, l, 64)
        assert (a - b).abs().max().item() <= ATOL
        assert torch.equal(a, c)


# The TCM chain's shapes: one item at T = 701, the batches of the released
# configs (8) and recipes (16) at T = 601 (16 takes two tile rounds),
# ragged tiles (T = 17, 33, 70, 130), T = 100 (below the largest conv halo,
# (K-1) dil = 128) and one frame.
TCM_FWD_SHAPES = [(1, 701), (3, 33), (2, 1), (9, 130), (8, 601), (16, 601),
                  (2, 17), (3, 100)]
TCM_BWD_SHAPES = [(2, 33), (1, 1), (3, 70), (8, 601), (16, 601), (2, 17),
                  (3, 100)]


@pytest.mark.gpu
@pytest.mark.parametrize("twin,kd1,dils", CASES, ids=IDS)
@pytest.mark.parametrize("b,t", TCM_FWD_SHAPES)
def test_tcm_kernel_matches_plain_on_card(cuda, twin, kd1, dils, b, t):
    group = random_group(twin, kd1, dils, cuda, seed=b * t)
    x = torch.randn(b, t, 256, generator=torch.Generator(
        device=cuda).manual_seed(b + t), device=cuda)
    before = tcm_chain.launches
    with torch.no_grad():
        w = group.stacked_weights()
        out = tcm_chain(x, w, group.dilations, twin)
        again = tcm_chain(x, w, group.dilations, twin)
        ref = tcm_chain_reference(x, w, group.dilations, twin)
    assert tcm_chain.launches == before + 2
    assert torch.equal(out, again)  # no atomics: the same bits again
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


@pytest.mark.gpu
def test_cln_release_on_card_matches_golden(cuda):
    """release/eabnet_9mic_cln on the card: the LSTM head through its
    kernel, the cLN TCN groups module by module (no TCM-chain launch)."""
    from eabnet_tpu_torch.inference import load_enhancer
    from eabnet_tpu_torch.utils.audio_io import read_wav

    golden = np.load(os.path.join(
        ROOT, "tests", "golden", "torch_port_eabnet_9mic_cln_00000.npz"))
    _, noisy = read_wav(os.path.join(ROOT, "release", "val_set", "noisy",
                                     "00000.wav"))
    enh = load_enhancer(os.path.join(ROOT, "release", "eabnet_9mic_cln"),
                        device="cuda")
    l0, t0 = double_lstm.launches, tcm_chain.launches
    out = enh(noisy)
    assert (double_lstm.launches - l0, tcm_chain.launches - t0) == (1, 0)
    ref = golden["esti"]
    assert 10 * np.log10(np.sum(ref ** 2) / np.sum((ref - out) ** 2)) >= 40


@pytest.mark.gpu
def test_streaming_on_card_matches_offline(cuda):
    """A small cLN composed model streamed frame by frame on the card
    against its offline output (atol 1e-4, tests/test_streaming.py's)."""
    from eabnet_tpu_torch.config import (ComposedConfig, EaBNetConfig,
                                         GaGNetConfig)
    from eabnet_tpu_torch.models import EaBNetWithPostNet
    from eabnet_tpu_torch.streaming import StreamingComposed

    torch.manual_seed(0)
    model = EaBNetWithPostNet(ComposedConfig(
        eabnet=EaBNetConfig(c=8, M=3, embed_dim=8, cd1=8, p=2, q=1,
                            norm_type="cLN"),
        gagnet=GaGNetConfig(c=8, cd1=8, p=1, q=1, dilas=(1, 2),
                            norm_type="cLN"))).to(cuda).eval()
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn((2, 12, 161, 3, 2), generator=g, device=cuda) * 0.3
    with torch.no_grad():
        offline = model(x)
    streamed = StreamingComposed(model).run(x)
    for k in ("esti0", "esti"):
        assert streamed[k].device.type == "cuda"
        assert (streamed[k] - offline[k]).abs().max().item() <= 1e-4


def _tf32_flags():
    return (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32, torch.backends.cudnn.benchmark,
            torch.backends.cudnn.deterministic)


@pytest.mark.gpu
def test_enhancer_under_default_flags_runs_float32(cuda):
    """With torch's default flags (cuDNN's TF32 on) the Enhancer still runs
    float32 convolutions: it meets the golden at >= 40 dB, stays within
    float32 noise of a run with TF32 off process-wide, and leaves the
    caller's flags as it found them. cuDNN's float32 algorithms are not
    bitwise reproducible from run to run, and TF32 convolutions move the
    output far more than float32 rounding does, so the two runs are held
    to 100 dB of each other."""
    from eabnet_tpu_torch.inference import load_enhancer
    from eabnet_tpu_torch.utils.audio_io import read_wav

    golden = np.load(os.path.join(
        ROOT, "tests", "golden", "torch_port_composed_9mic_00000.npz"))
    _, noisy = read_wav(os.path.join(ROOT, "release", "val_set", "noisy",
                                     "00000.wav"))
    enh = load_enhancer(os.path.join(ROOT, "release", "composed_9mic"),
                        device="cuda")
    saved = _tf32_flags()
    try:
        torch.backends.cuda.matmul.allow_tf32 = False  # torch's defaults
        torch.backends.cudnn.allow_tf32 = True
        default = _tf32_flags()
        out = enh(noisy)
        assert _tf32_flags() == default
        torch.backends.cudnn.allow_tf32 = False
        off = enh(noisy)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved[:2]
    ref = golden["esti"]
    snr = 10 * np.log10(np.sum(ref ** 2) / np.sum((ref - out) ** 2))
    assert snr >= 40.0
    assert 10 * np.log10(np.sum(off ** 2) / np.sum((off - out) ** 2)) >= 100.0


# The backward kernels at the shapes of the JAX kernel tests' gradient
# checks and a little beyond, with their tolerances (tests/test_kernels.py:
# d xw1 3e-5, weights 5e-5, rtol 1e-4; tests/test_tcm_chain.py: 6e-5, rtol
# 1e-3) against the plain backward on the same card: d x per entry, the
# weight gradients against their largest entry. The shapes reach the
# backward's edges: lanes per block from the SM count, up to 8 in the
# narrow walk (L = 19 to 300; 137 leaves a short last block) and 9 in the
# other (L = 1,127 leaves a short last block; 3,000 takes more than one
# wave), one lane, one step, and T x L rows that end inside the
# weight-gradient GEMM's 32-row stages and leave some of its chunks empty.
@pytest.mark.gpu
@pytest.mark.parametrize("t,l", [(13, 19), (9, 23), (1, 300), (37, 133),
                                 (11, 137), (7, 1127), (5, 1), (1, 1),
                                 (3, 3000), (601, 7)])
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
        again = K._launch_bwd(xw1, dy, *states, *w)
    assert K.double_lstm.bwd_launches == before + 2
    # the weight-gradient sum runs in a fixed order: the same bits again
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    torch.testing.assert_close(got[0], ref[0], atol=3e-5, rtol=1e-4)
    # the weight gradients are sums over T x L rows: float32 rounding is
    # relative to their largest entries, so they are held against those
    for a, b in zip(got[1:], ref[1:]):
        assert (a - b).abs().max().item() <= \
            5e-5 + 1e-4 * b.abs().max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("twin,kd1,dils", CASES, ids=IDS)
@pytest.mark.parametrize("b,t", TCM_BWD_SHAPES)
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
        again = K._launch_bwd(x, dy, w, group.dilations, twin)
        fwd = K.tcm_chain_activations_reference(x, w, group.dilations, twin)
        # the reverse walk against the plain one on the kernel's recomputed
        # forward, so a PReLU input within float32 noise of 0 takes the
        # same branch in both
        rdx, rdw = K.tcm_chain_bwd_reference(x, dy, w, group.dilations, twin,
                                             acts=acts)
        pdx, pdw = K.tcm_chain_bwd_reference(x, dy, w, group.dilations, twin)
    assert K.tcm_chain.bwd_launches == before + 2
    # the weight gradients are summed in a fixed order: the same bits again
    assert torch.equal(dx, again[0])
    assert all(torch.equal(a, c) for a, c in zip(dw, again[1]))
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
    # cuDNN's default algorithms may sum in a run-dependent order; the
    # moments of gradients near float32 noise then move from run to run
    # (one full run of this file put one 6.0% off the CPU's). With
    # deterministic algorithms the card's step repeats, as chip_smoke's
    # compared train runs do.
    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=True, allow_tf32=False):
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


# ------------------------------------------------------------------ bf16
# The bf16 serving kernels against their plain versions, and both released
# models in bf16 and int8w against the JAX package's goldens. Rules
# (PERF.md §2, tests/test_torch_lowp.py): R is the SNR between the plain
# bf16 and plain float32 versions (TF32 off). A kernel must reach R + 20 dB
# against its plain version: the LSTM-BF forward over its sequence, the
# TCM chain one TCM at a time (float32 trunk in and out). The whole TCM
# chain is checked beside it at min(R + 20, D - 3) dB, D between the plain
# bf16 version computed in float32 and in float64 around the same bf16
# operands. A model must reach R - 6 dB against the JAX bf16 (int8w: JAX
# int8w) golden and, in bf16, R - 3 against the JAX float32 one, with R
# between the two JAX goldens.
BF16 = torch.bfloat16
RELEASE_LOWP = [("composed_9mic", (1, 21)), ("eabnet_9mic_cln", (1, 0))]


def snr_db(ref, est):
    ref, est = (np.asarray(a, np.float64) for a in (ref, est))
    return 10 * np.log10(np.sum(ref ** 2) / np.sum((ref - est) ** 2))


def kernel_rule(out, ref16, ref32, wide=None, spread=3.0):
    """SNR of the kernel against the plain bf16 version, and its bound: R +
    20, or with ``wide`` (a whole TCM chain, a backward) min(R + 20, D -
    ``spread``), D the smallest SNR between the plain version and each of ``wide``
    (float32-rounding probes of it that take nothing from the kernel: in
    float64, on the CPU, on inputs that differ by float32 rounding
    only)."""
    f = [a.float().cpu().numpy() for a in (out, ref16, ref32)]
    need = snr_db(f[2], f[1]) + 20.0
    if wide is not None:
        need = min(need, min(snr_db(w.float().cpu().numpy(), f[1]) - spread
                             for w in (wide if isinstance(wide, tuple)
                                       else (wide,))))
    return snr_db(f[1], f[0]), need


@pytest.fixture(scope="module")
def release_model():
    from eabnet_tpu_torch.checkpoint import latest_checkpoint, load_params
    from eabnet_tpu_torch.config import ExperimentConfig
    from eabnet_tpu_torch.models import build_model
    from eabnet_tpu_torch.weights import load_jax_params

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    exp = os.path.join(ROOT, "release", "composed_9mic")
    cfg = ExperimentConfig.load(os.path.join(exp, "config.json"))
    return load_jax_params(build_model(cfg.model),
                           load_params(latest_checkpoint(exp))).cuda()


@pytest.mark.gpu
@pytest.mark.parametrize("l", [161, 1127])
def test_lstm_bf16_kernel_matches_plain_on_card(cuda, release_model, l):
    r1, r2 = release_model.eabnet.bf_map.rnn1, release_model.eabnet.bf_map.rnn2
    g = torch.Generator(device=cuda).manual_seed(l)
    x = torch.randn((701, l, 64), generator=g, device=cuda)
    with torch.no_grad():
        xw1 = (x @ r1.w_ih + (r1.b_ih + r1.b_hh)).contiguous()
        a32 = (xw1, r1.w_hh, r2.w_ih, r2.w_hh, r2.b_ih + r2.b_hh)
        a16 = tuple(a.to(BF16).contiguous() for a in a32)
        before = double_lstm.launches
        out, again = double_lstm(*a16), double_lstm(*a16)
        assert double_lstm.launches == before + 2
        got, need = kernel_rule(out, double_lstm_reference(*a16),
                                double_lstm_reference(*a32))
    assert out.dtype == BF16 and out.shape == (701, l, 64)
    assert torch.equal(out, again)
    assert got >= need, (got, need)


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 7])
@pytest.mark.parametrize("which", ["twin", "single"])
def test_tcm_bf16_kernel_matches_plain_on_card(cuda, release_model, which,
                                               b):
    group = (release_model.eabnet.stcn_0 if which == "twin"
             else release_model.postnet.gag_0.glance.tcn_0)
    dils, twin = group.dilations, group.twin_gate
    g = torch.Generator(device=cuda).manual_seed(b)
    x = torch.randn((b, 701, 256), generator=g, device=cuda)
    with torch.no_grad():
        w32 = group.stacked_weights()
        w16 = tuple(w.to(BF16).contiguous() for w in w32)
        x16 = x.to(BF16)
        before = tcm_chain.launches
        out, again = (tcm_chain(x16, w16, dils, twin),
                      tcm_chain(x16, w16, dils, twin))
        assert tcm_chain.launches == before + 2
        got, need = kernel_rule(out, tcm_chain_reference(x16, w16, dils, twin),
                                tcm_chain_reference(x, w32, dils, twin),
                                tcm_chain_reference(x16, w16, dils, twin,
                                                    compute=torch.float64))
    assert out.dtype == BF16 and torch.equal(out, again)
    assert got >= need, (got, need)


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 7])
@pytest.mark.parametrize("which", ["twin", "single"])
def test_tcm_bf16_kernel_each_tcm_matches_plain_on_card(cuda, release_model,
                                                        which, b):
    """TCM j of the bf16 kernel alone, on the kernel's own float32 trunk
    input (its trunk after TCM j - 1), its float32 output against the plain
    version's on the same input: R + 20 dB. A trunk rounded to bf16
    between the TCMs, or an activation operand left unrounded, fails it."""
    group = (release_model.eabnet.stcn_0 if which == "twin"
             else release_model.postnet.gag_0.glance.tcn_0)
    dils, twin = group.dilations, group.twin_gate
    g = torch.Generator(device=cuda).manual_seed(10 + b)
    x16 = torch.randn((b, 701, 256), generator=g, device=cuda).to(BF16)
    with torch.no_grad():
        w32 = group.stacked_weights()
        w16 = tuple(w.to(BF16).contiguous() for w in w32)
        trunks = bf16_trunks(x16, w16, dils, twin)
        trunk = x16.float()
        for j, dil in enumerate(dils):
            ref32, ref16 = (tcm_chain_reference(
                trunk, tuple(w[j:j + 1] for w in ws), (dil,), twin)
                for ws in (w32, w16))
            r = snr_db(ref32.cpu(), ref16.cpu())
            got = snr_db(ref16.cpu(), trunks[j].cpu())
            assert got >= r + 20.0, (j, got, r)
            trunk = trunks[j]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "int8w"])
@pytest.mark.parametrize("model,launches", RELEASE_LOWP,
                         ids=[m for m, _ in RELEASE_LOWP])
def test_release_lowp_on_card_matches_goldens(cuda, model, launches, dtype):
    """Both stages through the bf16 kernels (launches per forward as in
    float32) against the JAX package's goldens by the model rule."""
    from eabnet_tpu_torch.inference import load_enhancer
    from eabnet_tpu_torch.utils.audio_io import read_wav

    gold = os.path.join(ROOT, "tests", "golden", f"torch_port_{model}_00000")
    g32, glow = np.load(gold + ".npz"), np.load(gold + "_lowp.npz")
    _, noisy = read_wav(os.path.join(ROOT, "release", "val_set", "noisy",
                                     "00000.wav"))
    enh = load_enhancer(os.path.join(ROOT, "release", model),
                        compute_dtype=dtype, device="cuda")
    for stage in ("esti", "esti0"):
        enh.output = stage
        l0, t0 = double_lstm.launches, tcm_chain.launches
        out = enh(noisy)
        assert (double_lstm.launches - l0,
                tcm_chain.launches - t0) == launches
        assert out.shape == (96000,) and np.isfinite(out).all()
        r = snr_db(g32[stage], glow[f"{stage}_bfloat16"])
        assert snr_db(glow[f"{stage}_{dtype}"], out) >= r - 6.0, stage
        if dtype == "bfloat16":
            assert snr_db(g32[stage], out) >= r - 3.0, stage


# bf16 training's kernels (PERF.md §2): the training forward's sequences,
# the TCM-chain backward's recomputed trunk and each TCM's float32
# cotangent out at R + 20 dB; every other backward output (the LSTM-BF's,
# each TCM's weight gradients; the whole chain's at D - 6) at min(R + 20,
# D - 3), D from plain probes that take nothing from the kernel (the plain
# backward in float64, on the CPU, or on inputs moved by float32
# rounding).
@pytest.mark.gpu
@pytest.mark.parametrize("l", [161, 1127])
def test_lstm_bf16_train_kernels_match_plain_on_card(cuda, release_model, l):
    from eabnet_tpu_torch.kernels import lstm_bf as K

    r1, r2 = release_model.eabnet.bf_map.rnn1, release_model.eabnet.bf_map.rnn2
    g = torch.Generator(device=cuda).manual_seed(100 + l)
    x = torch.randn((601, l, 64), generator=g, device=cuda)
    dy16 = torch.randn((601, l, 64), generator=g, device=cuda).to(BF16)
    with torch.no_grad():
        xw1 = (x @ r1.w_ih + (r1.b_ih + r1.b_hh)).contiguous()
        a32 = (xw1, r1.w_hh, r2.w_ih, r2.w_hh, r2.b_ih + r2.b_hh)
        a16 = tuple(a.to(BF16).contiguous() for a in a32)
        states = K._launch_fwd(*a16, states=True)
        assert all(s.dtype == BF16 for s in states)
        ref32 = K.double_lstm_states_reference(*a32)
        for s, r16, r32 in zip(states, K.double_lstm_states_reference(*a16),
                               ref32):
            got, need = kernel_rule(s, r16, r32)
            assert got >= need, (got, need)
        grads = K._launch_bwd(a16[0], dy16, *states, *a16[1:])
        again = K._launch_bwd(a16[0], dy16, *states, *a16[1:])
        p16 = K.double_lstm_bwd_reference(a16[0], dy16, *states, *a16[1:])
        p32 = K.double_lstm_bwd_reference(xw1, dy16.float(), *ref32,
                                          *a32[1:])
        p64 = K.double_lstm_bwd_reference(a16[0], dy16, *states, *a16[1:],
                                          compute=torch.float64)
        pown = K.double_lstm_bwd_reference(
            a16[0], dy16, *K.double_lstm_states_reference(*a16), *a16[1:])
    for i, (a, b) in enumerate(zip(grads, again)):
        assert a.dtype == BF16 and torch.equal(a, b), i
        got, need = kernel_rule(a, p16[i], p32[i], (p64[i], pown[i]))
        assert got >= need, (i, got, need)
    # under autograd the bf16 path goes through both kernels
    xg = a16[0].clone().requires_grad_()
    before = (double_lstm.launches, double_lstm.bwd_launches)
    with torch.enable_grad():
        double_lstm(xg, *a16[1:]).backward(dy16)
    assert (double_lstm.launches - before[0],
            double_lstm.bwd_launches - before[1]) == (1, 1)
    assert torch.equal(xg.grad, grads[0])


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 7])
@pytest.mark.parametrize("which", ["twin", "single"])
def test_tcm_bf16_bwd_kernel_matches_plain_on_card(cuda, release_model, which,
                                                   b):
    from eabnet_tpu_torch.kernels import tcm_chain as K

    group = (release_model.eabnet.stcn_0 if which == "twin"
             else release_model.postnet.gag_0.glance.tcn_0)
    dils, twin = group.dilations, group.twin_gate
    g = torch.Generator(device=cuda).manual_seed(200 + b)
    x16 = torch.randn((b, 601, 256), generator=g, device=cuda).to(BF16)
    dy16 = torch.randn((b, 601, 256), generator=g, device=cuda).to(BF16)
    with torch.no_grad():
        w32 = tuple(w.detach() for w in group.stacked_weights())
        w16 = tuple(w.to(BF16).contiguous() for w in w32)
        dx, dw, acts = K._launch_bwd(x16, dy16, w16, dils, twin,
                                     activations=True)
        again = K._launch_bwd(x16, dy16, w16, dils, twin)
        assert torch.equal(dx, again[0]) and all(
            torch.equal(a, c) for a, c in zip(dw, again[1]))
        trunks = [x16.float()] + list(acts["x"])
        cots = list(acts["dy"]) + [dy16.float()]
        outs = [dx] + list(acts["dy"])
        for j in range(len(dils)):
            wj = [tuple(w[j:j + 1] for w in ws) for ws in (w16, w32)]
            # the recomputed trunk after TCM j, on the kernel's trunk in
            if j + 1 < len(dils):
                t16, t32 = (K.tcm_chain_reference(trunks[j], w, dils[j:j + 1],
                                                  twin) for w in wj)
                got, need = kernel_rule(trunks[j + 1], t16, t32)
                assert got >= need, ("trunk", j, got, need)
            # TCM j's float32 cotangent out and its weight gradients, on
            # the kernel's trunk and cotangent in
            p16, p32 = (K.tcm_chain_bwd_reference(
                trunks[j], cots[j], w, dils[j:j + 1], twin) for w in wj)
            probes = K.tcm_chain_bwd_probes(trunks[j], cots[j], wj[0],
                                            dils[j:j + 1], twin, seed=j)
            got, need = kernel_rule(outs[j], p16[0].to(outs[j].dtype),
                                    p32[0])
            assert got >= need, (j, got, need)
            for i, (a, r16, r32) in enumerate(zip(dw, p16[1], p32[1])):
                if not r16.float().abs().max().item():
                    assert not a[j].float().abs().max().item(), (j, i)
                    continue
                got, need = kernel_rule(a[j:j + 1], r16, r32,
                                        tuple(q[1][i] for q in probes))
                assert got >= need, (j, i, got, need)
        c16 = K.tcm_chain_bwd_reference(x16, dy16, w16, dils, twin)
        c32 = K.tcm_chain_bwd_reference(x16.float(), dy16.float(), w32, dils,
                                        twin)
        probes = K.tcm_chain_bwd_probes(x16, dy16, w16, dils, twin)
    for i, (a, r16, r32, *wide) in enumerate(zip(
            (dx,) + dw, (c16[0],) + c16[1], (c32[0],) + c32[1],
            *(((q[0],) + q[1]) for q in probes))):
        assert a.dtype == BF16
        if not r16.float().abs().max().item():  # single: wr, table row 1
            assert not a.float().abs().max().item(), i
            continue
        # the whole backward chain at D - 6 (chip_smoke's
        # LOWP_CHAIN_BWD_SPREAD_DB)
        got, need = kernel_rule(a, r16, r32, tuple(wide), spread=6.0)
        assert got >= need, (i, got, need)
