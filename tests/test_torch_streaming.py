"""The port's frame-by-frame streaming: against the port's offline model
(atol 1e-4, as tests/test_streaming.py holds the JAX package's) with cLN,
cLN-ref and BN; against the JAX package's stepper frame by frame; streams
of a batch independent; IN and non-causal TCNs refused; the state O(1);
the streaming STFT / iSTFT against the JAX package's; and cli.stream on a
tiny saved experiment against the port's offline Enhancer."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eabnet_tpu import dsp as jdsp
from eabnet_tpu.config import EaBNetConfig as JEaB
from eabnet_tpu.config import StftConfig as JStft
from eabnet_tpu.models import EaBNet as JEaBNet
from eabnet_tpu.streaming import StreamingEaBNet as JStreamingEaBNet
from eabnet_tpu_torch import dsp
from eabnet_tpu_torch.config import (ComposedConfig, DataConfig,
                                     EaBNetConfig, ExperimentConfig,
                                     GaGNetConfig, StftConfig, TrainConfig)
from eabnet_tpu_torch.models import EaBNet, EaBNetWithPostNet
from eabnet_tpu_torch.streaming import (StreamingComposed, StreamingEaBNet,
                                        state_bytes)
from eabnet_tpu_torch.weights import load_jax_params

ATOL = 1e-4
B, T, F, M = 2, 12, 161, 3
EAB = dict(c=8, M=M, embed_dim=8, cd1=8, p=2, q=1)
GAG = dict(c=8, cd1=8, p=1, q=1, dilas=(1, 2))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: a frame step is thousands of tiny ops, which
    more threads only slow down (and on a loaded host, much more so)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def frames(seed=11, b=B, t=T):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, t, F, M, 2)) * 0.3).astype(np.float32)


def composed(norm="cLN", seed=0, **kw):
    """A small composed model, PyTorch's seeded init; batch norms get
    seeded running statistics; in evaluation mode."""
    torch.manual_seed(seed)
    model = EaBNetWithPostNet(ComposedConfig(
        eabnet=EaBNetConfig(norm_type=norm, **EAB, **kw),
        gagnet=GaGNetConfig(norm_type=norm, **GAG, **kw)))
    with torch.no_grad():
        for name, b in model.named_buffers():
            b.uniform_(0.5, 1.5) if name.endswith("var") else \
                b.uniform_(-0.2, 0.2)
    return model.eval()


@pytest.mark.parametrize("norm,kw", [("cLN", {}), ("cLN-ref", {}),
                                     ("BN", {}), ("cLN", {"is_u2": False}),
                                     ("BN", {"is_u2": False})],
                         ids=["cln", "clnref", "bn", "cln-unet", "bn-unet"])
def test_streaming_matches_offline(norm, kw):
    model = composed(norm, **kw)
    x = torch.from_numpy(frames())
    with torch.no_grad():
        offline = model(x)
    streamed = StreamingComposed(model).run(x)
    for k in ("esti0", "esti"):
        assert streamed[k].shape == offline[k].shape == (B, T, F, 2)
        np.testing.assert_allclose(streamed[k].numpy(), offline[k].numpy(),
                                   atol=ATOL, err_msg=k)
    # the beamformer alone streams the same estimate
    alone = StreamingEaBNet(model.eabnet).run(x)
    np.testing.assert_allclose(alone.numpy(), streamed["esti0"].numpy(),
                               atol=1e-6)


def test_step_matches_jax_stepper():
    """The JAX package's StreamingEaBNet and the port's, on the same flax
    parameters, frame by frame."""
    cfg = dict(EAB, norm_type="cLN")
    x = frames(12, b=1, t=6)
    jm = JEaBNet(JEaB(**cfg))
    params = jax.jit(jm.init)(jax.random.key(0), x)["params"]
    js = JStreamingEaBNet(JEaB(**cfg), params)
    jstep = jax.jit(js.step)
    jstate = js.init_state(1)
    ours = StreamingEaBNet(load_jax_params(EaBNet(EaBNetConfig(**cfg)),
                                           jax.tree.map(np.asarray, params)))
    state = ours.init_state(1)
    for t in range(x.shape[1]):
        jstate, ref = jstep(jstate, jnp.asarray(x[:, t]))
        state, out = ours.step(state, torch.from_numpy(x[:, t]))
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5,
                                   err_msg=f"frame {t}")


def test_streams_in_a_batch_are_independent():
    """Stream i of a ragged batch (stream 1 fed zeros after frame 6) is its
    own batch-1 run: no op mixes the batch."""
    model = composed("cLN", seed=3)
    x = torch.from_numpy(frames(33, b=3, t=10))
    x[1, 6:] = 0.0
    s = StreamingComposed(model)
    batched = s.run(x)
    for i in range(3):
        solo = s.run(x[i:i + 1])
        for k in ("esti0", "esti"):
            np.testing.assert_allclose(batched[k][i].numpy(),
                                       solo[k][0].numpy(), atol=1e-5)


def test_instance_norm_and_non_causal_tcn_are_refused():
    with pytest.raises(ValueError, match="cannot stream"):
        StreamingEaBNet(EaBNet(EaBNetConfig(**EAB)))
    with pytest.raises(ValueError, match="cannot stream"):
        StreamingComposed(composed("cLN", is_causal=False))
    with pytest.raises(NotImplementedError):
        StreamingEaBNet(EaBNet(EaBNetConfig(norm_type="cLN",
                                            topo_type="miso", **EAB)))


def test_state_is_constant_in_size():
    """O(1) state: the same tensors, keys and bytes after 2 and after 20
    frames, on the model's device."""
    model = composed("cLN")
    s = StreamingComposed(model)
    state = s.init_state(2)
    x = torch.from_numpy(frames(5, b=2, t=20))
    sizes = {}
    for t in range(20):
        state, _ = s.step(state, x[:, t])
        if t + 1 in (2, 20):
            sizes[t + 1] = (state_bytes(state), sorted(state),
                            [tuple(v.shape) for _, v in sorted(
                                state.items())])
    assert sizes[2] == sizes[20]
    assert all(v.device == x.device for v in state.values())
    assert state_bytes(state) == state_bytes(s.init_state(2)) > 0


def test_streaming_stft_istft_match_jax():
    """Sample blocks in, frames out, and back: the port's streaming
    transforms against the JAX package's, push by push."""
    rng = np.random.default_rng(4)
    hop = StftConfig().hop_samples
    x = rng.standard_normal((2, 3, hop * 12)).astype(np.float32) * 0.2
    js, jis = jdsp.StreamingStft(JStft()), jdsp.StreamingIstft(JStft())
    ps, pis = dsp.StreamingStft(StftConfig()), dsp.StreamingIstft(
        StftConfig())
    np.testing.assert_allclose(pis.envelope.numpy(), np.asarray(jis.envelope),
                               rtol=1e-7)
    jst, jist = js.init_state(2, 3), jis.init_state(2, 3)
    pst, pist = ps.init_state(2, 3), pis.init_state(2, 3)
    for t in range(12):
        block = x[..., t * hop:(t + 1) * hop]
        jst, jframe = js.push(jst, jnp.asarray(block))
        pst, pframe = ps.push(pst, torch.from_numpy(block))
        np.testing.assert_allclose(pframe.numpy(), np.asarray(jframe),
                                   atol=1e-5)
        jist, jout = jis.push(jist, jframe)
        pist, pout = pis.push(pist, pframe)
        np.testing.assert_allclose(pout.numpy(), np.asarray(jout), atol=1e-5)
    assert pst.shape == pist.shape == (2, 3, 160)


@pytest.fixture(scope="module")
def tiny_exp(tmp_path_factory):
    """A saved experiment: a small composed cLN model, its config and a
    .params file."""
    from eabnet_tpu_torch.train.checkpoint import save_config, save_params

    root = tmp_path_factory.mktemp("exp")
    cfg = ExperimentConfig(
        model=composed("cLN", seed=5).cfg, data=DataConfig(dataset="fake"),
        train=TrainConfig(checkpoint_dir=str(root / "ckpt"),
                          exp_root=str(root)))
    save_config(cfg, str(root))
    save_params(composed("cLN", seed=5), str(root / "ckpt"), 10)
    return str(root)


def test_cli_stream_matches_offline_enhancer(tmp_path, tiny_exp, capsys):
    """tests/test_stream_cli.py's criteria: stream sample k is offline
    sample k - n_fft / 2; on the back half the correlation is > 0.99 and
    the RMS ratio in (0.8, 1.25) (the streamed STFT starts from silence
    where the offline one reflect-pads). Then directory mode: ragged
    streams in lockstep, each its own single-stream run."""
    from eabnet_tpu_torch.cli import stream as cli
    from eabnet_tpu_torch.inference import load_enhancer
    from eabnet_tpu_torch.utils.audio_io import read_wav, write_wav

    rng = np.random.default_rng(0)
    hop = StftConfig().hop_samples
    n = hop * 60
    noisy = (rng.standard_normal((3, n)) * 0.1).astype(np.float32)
    write_wav(str(tmp_path / "in.wav"), 16000, noisy, dtype="float")
    cli.main([str(tmp_path / "in.wav"), str(tmp_path / "out.wav"),
              "--exp-root", tiny_exp, "--device", "cpu"])
    assert "1 stream(s), 60 frames" in capsys.readouterr().out
    sr, streamed = read_wav(str(tmp_path / "out.wav"))
    assert sr == 16000 and streamed.shape == (n,)
    offline = load_enhancer(tiny_exp, device="cpu")(noisy)
    lead, warm = 160, n // 2
    m = min(len(offline), len(streamed) - lead) - warm
    a = streamed[lead + warm:lead + warm + m]
    b = offline[warm:warm + m]
    assert np.corrcoef(a, b)[0, 1] > 0.99
    assert 0.8 < np.sqrt(np.mean(a ** 2) / np.mean(b ** 2)) < 1.25

    (tmp_path / "in").mkdir()
    write_wav(str(tmp_path / "in" / "a.wav"), 16000, noisy, dtype="float")
    write_wav(str(tmp_path / "in" / "b.wav"), 16000, noisy[:, :hop * 25],
              dtype="float")
    cli.main([str(tmp_path / "in"), str(tmp_path / "out"), "--exp-root",
              tiny_exp, "--device", "cpu", "--output-stage", "esti0"])
    assert "2 stream(s)" in capsys.readouterr().out
    cli.main([str(tmp_path / "in" / "b.wav"), str(tmp_path / "b.wav"),
              "--exp-root", tiny_exp, "--device", "cpu", "--output-stage",
              "esti0"])
    multi = read_wav(str(tmp_path / "out" / "b.wav"))[1]
    solo = read_wav(str(tmp_path / "b.wav"))[1]
    assert multi.shape == solo.shape == (hop * 25,)
    np.testing.assert_allclose(multi, solo, atol=2e-5)
