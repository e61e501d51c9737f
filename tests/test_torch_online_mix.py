"""The device half of the port's online synthesis, run on the CPU, against
the JAX package's: ``mix_parts`` (float32 and int16 transport), the scene
early RIRs, the late-field tails, ``mix_scene``, and the fused ``parts``
and ``scene`` train steps on the same batch and weights.

Tolerances:

- FFT_TOL: the port's and the JAX package's mixes are float32 FFT
  convolutions at the same power-of-two length, summed in different
  orders. Each is held within FFT_TOL / 2 of the port's mix run in
  float64 on the same inputs (measured here: 2.3e-7 to 6.1e-7 of the
  peak), which shows the gap between them is float32 rounding and not a
  difference of formula; they are held to FFT_TOL of each other.
- The early RIRs: the JAX scene test's 3e-5 of the RIR's peak (rtol 1e-3)
  against the host's float64 construction and against JAX.
- The tails: the carrier sample is each package's own draw (the port's a
  torch generator per (item, source)), so energies are compared, not
  samples: per bin within rtol 1e-4 of hist_amp², zero where hist_amp is,
  and per (source, mic) the whole RIR's energy within the JAX scene
  test's rtol 0.08 (random early-by-tail cross terms).
- The fused steps' step-1 losses: LOSS_RTOL, the rule the port's wav step
  is held to against JAX's (tests/test_torch_train_step.py); the scene
  step with carriers within 0.15 of the host step, as JAX's own test.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eabnet_tpu.config import (ComposedConfig, DataConfig, EaBNetConfig,
                               ExperimentConfig, GaGNetConfig, TrainConfig)
from eabnet_tpu.data import device_mix as JDM
from eabnet_tpu.data import rir as JR
from eabnet_tpu.data import scene_mix as JS
from eabnet_tpu.train.step import TrainState as JTrainState
from eabnet_tpu.train.step import make_optimizer
from eabnet_tpu.train.step import make_train_step as jax_train_step
from eabnet_tpu_torch.config import ExperimentConfig as PExperimentConfig
from eabnet_tpu_torch.data import datasets as PD
from eabnet_tpu_torch.data import device_mix as PDM
from eabnet_tpu_torch.data import scene_mix as PS
from eabnet_tpu_torch.data import scenes as PSC
from eabnet_tpu_torch.models import build_model
from eabnet_tpu_torch.train import step as P
from eabnet_tpu_torch.weights import load_jax_params, to_jax_params

from test_data import SETTINGS_V2, _write_fake_corpus

FFT_TOL = 1e-5
LOSS_RTOL = 1e-5
SPEECH = ["sp0.wav", "sp1.wav", "sp2.wav"]
NOISE = [f"no{i}.wav" for i in range(4)]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for the port: on a host that other test workers
    load, more threads mostly wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """The JAX data tests' corpus and settings, two items' parts and
    scenes (seeds 11, 12), and the int16 corpora."""
    tmp = tmp_path_factory.mktemp("online_mix")
    sp_dir, no_dir = _write_fake_corpus(tmp)
    settings = tmp / "settings.json"
    settings.write_text(json.dumps(SETTINGS_V2))
    opt = PSC.load_settings(str(settings))
    paths = [str(no_dir / n) for n in NOISE]
    args = [(opt, 1.0, str(sp_dir / "sp0.wav"), paths, s) for s in (11, 12)]
    dims = JS.scene_static_dims(opt, 1.0)
    return dict(
        tmp=tmp, sp_dir=sp_dir, no_dir=no_dir, settings=str(settings),
        opt=opt, dims=dims,
        parts=[JDM.synthesize_item_parts(*a, rir_backend="numpy")
               for a in args],
        scenes=JS.collate_scenes(
            [JS.synthesize_item_scene(*a) for a in args], dims),
        corpus=(JS.load_corpus_int16(str(sp_dir), SPEECH, 16000),
                JS.load_corpus_int16(str(no_dir), NOISE, 16000)))


def to_torch(batch, dtype=None):
    out = PDM.batch_to_device(batch, "cpu")
    if dtype is not None:
        out = {k: v.to(dtype) if torch.is_tensor(v) and v.is_floating_point()
               else v for k, v in out.items()}
    return out


def peak_err(a, b, ref):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max()
                 / np.abs(ref).max())


@pytest.mark.parametrize("quantize", [False, True], ids=["float32", "int16"])
def test_mix_parts_equals_jax(data, quantize):
    batch = JDM.collate_parts(data["parts"], s_max=6, quantize=quantize)
    n = batch["sources"].shape[-1]
    jn, jc = (np.asarray(x) for x in JDM.mix_parts(batch, n))
    t = to_torch(batch)
    pn, pc = (x.numpy() for x in PDM.mix_parts(t, n))
    t64 = dict(t, h_direct=t["h_direct"].double())
    if quantize:  # dequantized in float64, then the float64 mix
        t64["sources"] = t["sources"].double() * (
            t["src_scale"].double()[:, :, None] / 32767.0)
        t64["rirs"] = t["rirs"].double() * (
            t["rir_scale"].double()[:, :, :, None] / 32767.0)
    else:
        t64["sources"], t64["rirs"] = t["sources"].double(), t["rirs"].double()
    rn, rc = (x.numpy() for x in PDM.mix_parts(t64, n))
    assert pn.shape == (2, 9, 16000) and pc.shape == (2, 16000)
    for got in ((pn, pc), (jn, jc)):
        assert peak_err(got[0], rn, rn) <= FFT_TOL / 2
        assert peak_err(got[1], rc, rc) <= FFT_TOL / 2
    assert peak_err(pn, jn, jn) <= FFT_TOL
    assert peak_err(pc, jc, jc) <= FFT_TOL


def test_scene_early_rirs_equal_jax_and_host():
    room, src = [6.0, 4.5, 2.8], [4.0, 3.0, 1.4]
    mics = np.stack([[2.0, 1.5 + 0.04 * i, 1.2] for i in range(4)])
    host, _ = JR.ism_early_rir(room, src, mics, 0.35, 3, 16000,
                               air_absorption=1.5e-3)
    delays, amps = JR.ism_image_params(room, src, mics, 0.35, 3, 16000,
                                       air_absorption=1.5e-3)
    d, a = delays.astype(np.float32)[None], amps.astype(np.float32)[None]
    pad = 64 * ((host.shape[1] + 63) // 64 + 2)
    port = PS.scene_early_rirs(torch.from_numpy(d), torch.from_numpy(a),
                               pad).numpy()[0]
    jax_ = np.asarray(JS.scene_early_rirs(d, a, pad))[0]
    scale = np.abs(host).max()
    for ref in (host, jax_[:, :host.shape[1]]):
        np.testing.assert_allclose(port[:, :host.shape[1]], ref,
                                   atol=3e-5 * scale, rtol=1e-3)
    assert np.abs(port[:, host.shape[1]:]).max() <= 1e-7 * scale
    again = PS.scene_early_rirs(torch.from_numpy(d), torch.from_numpy(a),
                                pad).numpy()[0]
    np.testing.assert_array_equal(again, port)


def test_scene_tails_energy_and_seeds():
    rng = np.random.default_rng(3)
    b, s, m, nb, spb = 2, 3, 4, 11, 64
    hist = rng.random((b, s, m, nb)).astype(np.float32) * 1e-4
    hist[0, 1] = 0.0  # a padded source: a silent tail
    amp = torch.from_numpy(np.sqrt(hist))
    seeds = rng.integers(0, 2 ** 31, size=(b, s)).astype(np.uint32)
    tail = PS.scene_tails(amp, seeds, spb).numpy()
    assert tail.shape == (b, s, m, nb * spb)
    energy = (tail.reshape(b, s, m, nb, spb).astype(np.float64) ** 2).sum(-1)
    np.testing.assert_allclose(energy, hist, rtol=1e-4, atol=1e-12)
    assert np.abs(tail[0, 1]).max() == 0.0
    np.testing.assert_array_equal(PS.scene_tails(amp, seeds, spb).numpy(),
                                  tail)
    assert np.abs(PS.scene_tails(amp, seeds + 1, spb).numpy()
                  - tail).max() > 0
    # (item, source) draws do not depend on the batch around them
    np.testing.assert_array_equal(
        PS.scene_tails(amp[1:], seeds[1:], spb).numpy(), tail[1:])


def test_mix_scene_equals_jax(data):
    """Without carriers (hist_amp zeroed) the mix is deterministic: the
    port's against JAX's at FFT_TOL. With them, each (source, mic) RIR's
    energy against JAX's reconstruction at the JAX scene test's 0.08."""
    dims, corpus = data["dims"], data["corpus"]
    zeroed = dict(data["scenes"],
                  hist_amp=np.zeros_like(data["scenes"]["hist_amp"]))
    jn, jc = (np.asarray(x) for x in JS.mix_scene(zeroed, *corpus, dims))
    pc_ = [torch.from_numpy(c) for c in corpus]
    pn, pc = (x.numpy() for x in PS.mix_scene(to_torch(zeroed), *pc_, dims))
    assert pn.shape == (2, 9, 16000) and pc.shape == (2, 16000)
    assert peak_err(pn, jn, jn) <= FFT_TOL
    assert peak_err(pc, jc, jc) <= FFT_TOL

    b = data["scenes"]
    t = to_torch(b)
    early = PS.scene_early_rirs(t["delays"], t["amps"], dims["early_pad"])
    tail = PS.scene_tails(t["hist_amp"], b["tail_seeds"], dims["spb"])
    j_early = np.asarray(JS.scene_early_rirs(b["delays"], b["amps"],
                                             dims["early_pad"]))
    j_tail = np.asarray(JS.scene_tails(b["hist_amp"], b["tail_seeds"],
                                       dims["spb"]))

    def energy(e, tl):
        full = np.zeros(e.shape[:3] + (dims["l_rir"],))
        full[..., :e.shape[-1]] += e
        full[..., :tl.shape[-1]] += tl
        return (full ** 2).sum(-1)

    live = b["gains"] > 0
    np.testing.assert_allclose(energy(early.numpy(), tail.numpy())[live],
                               energy(j_early, j_tail)[live], rtol=0.08)
    noisy, _ = PS.mix_scene(t, *pc_, dims)
    again, _ = PS.mix_scene(t, *pc_, dims)
    assert torch.equal(noisy, again)


def tiny_cfg(data, mode):
    """test_scene_mix.py's _tiny_cfg in float32."""
    return ExperimentConfig(
        model=ComposedConfig(
            eabnet=EaBNetConfig(M=9, c=16, embed_dim=16, cd1=16, p=2, q=1),
            gagnet=GaGNetConfig(c=12, cd1=12, p=1, q=1, dilas=(1, 2))),
        data=DataConfig(
            dataset="mcse", train_set="online",
            speech_root=str(data["sp_dir"]), noise_root=str(data["no_dir"]),
            speech_list=str(data["tmp"] / "speech_list.txt"),
            noise_list=str(data["tmp"] / "noise_list.txt"),
            mcse_settings=data["settings"], clip_seconds=1.0,
            device_mix=mode, num_workers=0, rir_backend="numpy"),
        train=TrainConfig(batch_size=2, wav_len=1.0, fixed_seed=True))


def port_state(cfg, params):
    pcfg = PExperimentConfig.from_json(cfg.to_json())
    model = load_jax_params(build_model(pcfg.model),
                            jax.tree.map(np.asarray, params))
    return pcfg, P.TrainState(0, model, P.adam_init(model))


@pytest.fixture(scope="module")
def jax_step(data):
    """The JAX package's init and its jitted wav step for the tiny config
    (one compile serves both kinds below)."""
    cfg = tiny_cfg(data, "parts")
    pcfg = PExperimentConfig.from_json(cfg.to_json())
    # the port's seeded init carried to JAX (flax's own init of this
    # model takes longer than the step's compile)
    params = jax.tree.map(jnp.asarray, to_jax_params(
        P.create_train_state(pcfg, "cpu", seed=0).model))
    state = JTrainState(step=jnp.zeros((), jnp.int32), params=params,
                        opt_state=make_optimizer(cfg).init(params))
    return cfg, state, jax_train_step(cfg, donate=False)


@pytest.mark.parametrize("kind", ["parts", "scene"])
def test_fused_step_equals_jax(data, jax_step, kind):
    """Step 1 of the port's fused step against the JAX package's on the
    same batch (the scene's carriers zeroed) and the same weights. JAX's
    fused step is its mix followed by its wav step's body in one jit; here
    JAX's mix runs first and its audio goes through JAX's jitted wav step,
    which computes the same losses with one compile for both kinds."""
    cfg, jstate, jstep = jax_step
    pcfg, pstate = port_state(cfg, jstate.params)
    dims = data["dims"]
    if kind == "parts":
        batch = JDM.collate_parts(data["parts"], s_max=6,
                                  rir_pad=dims["l_rir"])
        audio = JDM.mix_parts(batch, batch["sources"].shape[-1])
        pargs = (to_torch(batch),)
    else:
        batch = dict(data["scenes"],
                     hist_amp=np.zeros_like(data["scenes"]["hist_amp"]))
        audio = JS.mix_scene(batch, *data["corpus"], dims)
        pargs = (to_torch(batch),
                 *(torch.from_numpy(c) for c in data["corpus"]))
    _, jl = jstep(jstate, *audio, batch["lengths"])
    pstep = P.make_train_step(pcfg, kind, dims)
    _, pl = pstep(pstate, *pargs)
    for k in ("eabnet", "postnet", "final"):
        assert float(pl[k]) == pytest.approx(float(jl[k]), rel=LOSS_RTOL), k


def test_scene_step_tracks_host_step(data):
    """The port's scene step with its own carriers against its wav step on
    the host path's audio for the same seeds (the loader's batch of mode
    False): the JAX package's own test holds its scene step within 0.15."""
    cfg = tiny_cfg(data, "scene")
    pcfg = PExperimentConfig.from_json(cfg.to_json())
    losses = {}
    for mode in (False, "scene"):
        ds = PD.OnlineMcseDataset(pcfg.data, seed=5)
        (batch,) = PD.BatchLoader(ds, 2, shuffle=False,
                                  device_mix=mode).epoch(0)
        state = P.create_train_state(pcfg, "cpu", seed=0)
        if mode:
            corpus = (torch.from_numpy(c) for c in data["corpus"])
            step = P.make_train_step(pcfg, "scene", data["dims"])
            _, out = step(state, to_torch(batch), *corpus)
        else:
            _, out = P.make_train_step(pcfg)(
                state, *(torch.from_numpy(a) for a in batch))
        losses[mode] = float(out["final"])
        assert np.isfinite(losses[mode])
    assert losses["scene"] == pytest.approx(losses[False], rel=0.15)
