"""The cnn and miso beamforming heads in the port against the JAX package,
at small widths, on the same flax parameters and seeded numpy inputs:

- the offline forward of EaBNet and of the composed model (atol 2e-4,
  ``tests/test_torch_models.py``'s ATOL);
- the frame stepper against the JAX package's StreamingEaBNet (atol
  1e-4, as ``tests/test_streaming.py`` holds JAX), with no LSTM state;
- the ``.pth`` import of both heads (the reference's 1x1-conv ``bf_map``)
  and ``export_torch_state_dict`` for the composed, EaBNet and GaGNet
  configs, bit for bit the JAX package's, with a round trip through the
  port's own ``.pth`` reader.

bf16 / int8w serving and the train step with both heads:
``tests/test_torch_heads_lowp.py``, ``tests/test_torch_heads_train.py``.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from eabnet_tpu.config import ComposedConfig as JComposed
from eabnet_tpu.config import EaBNetConfig as JEaB
from eabnet_tpu.config import GaGNetConfig as JGaG
from eabnet_tpu.models import EaBNet as JEaBNet
from eabnet_tpu.models import EaBNetWithPostNet as JComposedNet
from eabnet_tpu.streaming import StreamingEaBNet as JStreamingEaBNet
from eabnet_tpu.utils import convert_torch as j_conv
from eabnet_tpu_torch.config import (ComposedConfig, EaBNetConfig,
                                     ExperimentConfig, GaGNetConfig)
from eabnet_tpu_torch.models import EaBNet, EaBNetWithPostNet, build_model
from eabnet_tpu_torch.nn.blocks import Dense
from eabnet_tpu_torch.streaming import StreamingEaBNet
from eabnet_tpu_torch.utils import convert_torch as t_conv
from eabnet_tpu_torch.weights import (flatten_tree, load_jax_params,
                                      to_jax_params)

from tests.test_golden import _load

ATOL = 2e-4          # offline forward (tests/test_torch_models.py)
STREAM_ATOL = 1e-4   # streamed vs the JAX stepper (tests/test_streaming.py)
B, T, F, M = 2, 13, 161, 3
EAB = dict(c=16, M=M, embed_dim=16, cd1=32, p=2, q=2)
GAG = dict(c=16, cd1=32, p=1, q=2, dilas=(1, 2))
HEADS = {"cnn": dict(bf_type="cnn"), "miso": dict(topo_type="miso")}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for the port: on a host that other test workers
    load, more threads mostly wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def inputs(seed=0, b=B, t=T):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, t, F, M, 2)) * 0.5).astype(np.float32)


def params_of(model, *args):
    return jax.tree.map(np.asarray,
                        model.init(jax.random.key(0), *args)["params"])


# ------------------------------------------------------------- forward
@pytest.mark.parametrize("head", HEADS)
def test_eabnet_head_matches_flax(head):
    kw = dict(EAB, **HEADS[head])
    x = inputs()
    jm = JEaBNet(JEaB(**kw))
    params = params_of(jm, x)
    ref = np.asarray(jm.apply({"params": params}, x))
    tm = load_jax_params(EaBNet(EaBNetConfig(**kw)), params)
    assert isinstance(tm.bf_map, Dense)
    assert tuple(tm.bf_map.kernel.shape) == (2 if head == "miso" else 2 * M,
                                             EAB["embed_dim"])
    with torch.no_grad():
        ours = tm(torch.from_numpy(x)).numpy()
    assert ours.shape == ref.shape == (B, T, F, 2)
    np.testing.assert_allclose(ours, ref, atol=ATOL)
    # the parameter names and layouts go back to the flax tree exactly
    back = flatten_tree(to_jax_params(tm))
    for k, v in flatten_tree(params).items():
        assert back[k].tobytes() == v.tobytes(), k


@pytest.mark.parametrize("head", HEADS)
def test_composed_head_matches_flax(head):
    x = inputs(3)
    eab = dict(EAB, **HEADS[head])
    jm = JComposedNet(JComposed(eabnet=JEaB(**eab), gagnet=JGaG(**GAG)))
    params = params_of(jm, x)
    ref = jm.apply({"params": params}, x)
    tm = load_jax_params(EaBNetWithPostNet(ComposedConfig(
        eabnet=EaBNetConfig(**eab), gagnet=GaGNetConfig(**GAG))), params)
    with torch.no_grad():
        ours = tm(torch.from_numpy(x))
    for k in ("esti0", "esti"):
        np.testing.assert_allclose(ours[k].numpy(), np.asarray(ref[k]),
                                   atol=ATOL, err_msg=k)


# ----------------------------------------------------------- streaming
@pytest.mark.parametrize("head", HEADS)
def test_head_streams_like_the_jax_stepper(head):
    """Frame by frame against the JAX package's stepper on the same flax
    parameters (cLN); the state carries no LSTM leaves, as JAX's (rnn1 /
    rnn2 only for mimo-lstm), and the stream equals the port's offline
    model."""
    kw = dict(EAB, norm_type="cLN", **HEADS[head])
    x = inputs(12, b=1, t=8)
    params = params_of(JEaBNet(JEaB(**kw)), x)
    js = JStreamingEaBNet(JEaB(**kw), params)
    jstep = jax.jit(js.step)
    jstate = js.init_state(1)
    assert "rnn1" not in jstate and "rnn2" not in jstate
    model = load_jax_params(EaBNet(EaBNetConfig(**kw)), params)
    ours = StreamingEaBNet(model)
    state = ours.init_state(1)
    assert not any("bf_map" in k for k in state), sorted(state)
    outs = []
    for t in range(x.shape[1]):
        jstate, ref = jstep(jstate, x[:, t])
        state, out = ours.step(state, torch.from_numpy(x[:, t]))
        np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                                   atol=STREAM_ATOL, err_msg=f"frame {t}")
        outs.append(out)
    with torch.no_grad():
        offline = model(torch.from_numpy(x))
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(),
                               offline.numpy(), atol=STREAM_ATOL)


# ------------------------------------------------------- .pth, export
def pth_cfg(head=None):
    eab = dict(c=16, M=3, embed_dim=16, cd1=16, p=2, q=2,
               **(HEADS[head] if head else {}))
    return JComposed(eabnet=JEaB(**eab),
                     gagnet=JGaG(c=16, cd1=16, p=1, q=2))


def port_model_cfg(cfg):
    return ExperimentConfig.from_dict({"model": dataclasses.asdict(cfg)}
                                      ).model


def head_sd(head):
    """The golden small EaBNet's state dict with the LSTM head's keys
    swapped for the reference's 1x1-conv ``bf_map`` (2M or 2 output
    channels), seeded."""
    sd, _ = _load("eabnet_small")
    sd = {k: v for k, v in sd.items() if not k.startswith("bf_map.")}
    out = 2 if head == "miso" else 2 * 3
    rng = np.random.default_rng(16)
    sd["bf_map.weight"] = (rng.standard_normal((out, 16, 1, 1)) * 0.25
                           ).astype(np.float32)
    sd["bf_map.bias"] = (rng.standard_normal(out) * 0.1).astype(np.float32)
    return sd


def assert_same_tree(ours, ref):
    ours, ref = flatten_tree(ours), flatten_tree(ref)
    assert sorted(ours) == sorted(ref)
    for k, v in ref.items():
        v = np.asarray(v)
        assert ours[k].dtype == v.dtype and ours[k].shape == v.shape, k
        assert ours[k].tobytes() == v.tobytes(), k


@pytest.mark.parametrize("head", HEADS)
def test_pth_import_of_the_head_equals_jax(head, tmp_path):
    """A reference ``.pth`` of a composed model with the cnn or miso head
    converts to the JAX package's tree and loads into the port's model."""
    cfg = pth_cfg(head)
    gag, _ = _load("gagnet_small")
    sd = {f"module.eabnet.{k}": torch.from_numpy(v)
          for k, v in head_sd(head).items()}
    sd.update({f"module.postnet.{k}": torch.from_numpy(v)
               for k, v in gag.items()})
    path = str(tmp_path / "100.pth")
    torch.save({"model_state_dict": sd, "iteration": 100, "epoch": 0}, path)
    ours = t_conv.load_torch_checkpoint(path, port_model_cfg(cfg))["params"]
    ref = j_conv.load_torch_checkpoint(path, cfg)["params"]
    assert_same_tree(ours, ref)
    assert set(ours["eabnet"]["bf_map"]) == {"kernel", "bias"}
    model = load_jax_params(build_model(port_model_cfg(cfg)), ours)
    np.testing.assert_array_equal(
        model.eabnet.bf_map.kernel.detach().numpy(),
        head_sd(head)["bf_map.weight"][:, :, 0, 0])


def export_cases():
    """(name, JAX config, template state dict) for the composed model and
    each net alone, templates from the small goldens."""
    eab, _ = _load("eabnet_small")
    gag, _ = _load("gagnet_small")
    cfg = pth_cfg()
    composed = {f"eabnet.{k}": v for k, v in eab.items()}
    composed.update({f"postnet.{k}": v for k, v in gag.items()})
    return {"composed": (cfg, composed), "eabnet": (cfg.eabnet, eab),
            "gagnet": (cfg.gagnet, gag),
            "cnn": (pth_cfg("cnn").eabnet, head_sd("cnn")),
            "miso": (pth_cfg("miso").eabnet, head_sd("miso"))}


def port_config(cfg):
    if isinstance(cfg, JComposed):
        return port_model_cfg(cfg)
    kind = EaBNetConfig if isinstance(cfg, JEaB) else GaGNetConfig
    return kind(**dataclasses.asdict(cfg))


def converter(conv, cfg):
    if isinstance(cfg, (JComposed, ComposedConfig)):
        return lambda sd: conv.convert_composed(sd, cfg)
    if isinstance(cfg, (JEaB, EaBNetConfig)):
        return lambda sd: conv.convert_eabnet(sd, cfg)
    return lambda sd: conv.convert_gagnet(sd, cfg)


@pytest.mark.parametrize("case", ["composed", "eabnet", "gagnet", "cnn",
                                  "miso"])
def test_export_equals_jax_bit_for_bit_and_round_trips(case, tmp_path):
    """Seeded params (the template's tree moved off it) exported by both
    packages: the same keys, dtypes and bits, the same unmapped keys (none);
    the port's ``.pth`` reader gives the params back exactly."""
    jcfg, template = export_cases()[case]
    pcfg = port_config(jcfg)
    rng = np.random.default_rng(7)
    params = jax.tree.map(
        lambda a: (a + rng.standard_normal(a.shape) * 0.01).astype(a.dtype),
        converter(j_conv, jcfg)(template))
    ours, ours_unmapped = t_conv.export_torch_state_dict(params, pcfg,
                                                         template)
    ref, ref_unmapped = j_conv.export_torch_state_dict(params, jcfg,
                                                       template)
    assert ours_unmapped == ref_unmapped == []
    assert list(ours) == list(ref) == list(template)
    for k, v in ref.items():
        assert ours[k].dtype == v.dtype and ours[k].shape == v.shape, k
        assert ours[k].tobytes() == v.tobytes(), k
    assert_same_tree(converter(t_conv, pcfg)(ours), params)
    if case == "composed":  # through a .pth file, as a user reads one
        path = str(tmp_path / "7.pth")
        torch.save({"model_state_dict": {k: torch.from_numpy(v)
                                         for k, v in ours.items()}}, path)
        assert_same_tree(t_conv.load_torch_checkpoint(path, pcfg)["params"],
                         params)


@pytest.mark.parametrize("fault", ["tree", "config", "probe_ids"])
def test_export_raises_where_jax_raises(fault):
    jcfg, template = export_cases()["eabnet"]
    params = converter(j_conv, jcfg)(template)
    if fault == "tree":
        params = dict(params, extra={"kernel": np.zeros(2, np.float32)})
    elif fault == "config":
        jcfg = "EaBNet"
    else:  # more elements than float32 counts exactly, with no memory
        template = dict(template, big=np.broadcast_to(np.float32(0),
                                                      (2 ** 24,)))
    pcfg = jcfg if fault == "config" else port_config(jcfg)
    raised = []
    for conv, cfg in ((t_conv, pcfg), (j_conv, jcfg)):
        with pytest.raises((ValueError, TypeError)) as e:
            conv.export_torch_state_dict(params, cfg, template)
        raised.append((type(e.value), str(e.value)))
    assert raised[0] == raised[1]
