"""Reference PyTorch checkpoints (``<iter>.pth``) and experiment
directories (``args.pickle`` + ``.pth``) in the port, against the JAX
package's readers of the same files.

The checkpoint is built from the committed golden state dicts of the small
reference nets (tests/golden/eabnet_small.npz, gagnet_small.npz), with
DDP ``module.`` prefixes, as tests/test_pth_ingestion.py builds it; the
config is that file's (M=3, c=16, p=2, q=2).
"""

import argparse
import dataclasses
import os
import pickle
import shutil
import types
import warnings

import numpy as np
import pytest
import torch

from eabnet_tpu.config import (ComposedConfig, EaBNetConfig,
                               ExperimentConfig, GaGNetConfig)
from eabnet_tpu.train import checkpoint as JC
from eabnet_tpu.utils import convert_args as j_args
from eabnet_tpu.utils import convert_torch as j_conv
from eabnet_tpu_torch import checkpoint as PCK
from eabnet_tpu_torch.config import ExperimentConfig as PExperimentConfig
from eabnet_tpu_torch.train import checkpoint as PC
from eabnet_tpu_torch.train.step import create_train_state
from eabnet_tpu_torch.utils import convert_args as t_args
from eabnet_tpu_torch.utils import convert_torch as t_conv
from eabnet_tpu_torch.weights import flatten_tree, to_jax_params

from tests.test_golden import _load

STEP, EPOCH = 4217, 3


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for the port: on a host that other test workers
    load, more threads mostly wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def small_cfg(norm: str = "IN") -> ExperimentConfig:
    return ExperimentConfig(model=ComposedConfig(
        eabnet=EaBNetConfig(c=16, M=3, embed_dim=16, cd1=16, p=2, q=2,
                            norm_type=norm),
        gagnet=GaGNetConfig(c=16, cd1=16, p=1, q=2, norm_type=norm)))


def port_cfg(cfg: ExperimentConfig) -> PExperimentConfig:
    return PExperimentConfig.from_dict(dataclasses.asdict(cfg))


def reference_sd(prefix: str = "module.") -> dict:
    eab_sd, _ = _load("eabnet_small")
    gag_sd, _ = _load("gagnet_small")
    sd = {f"{prefix}eabnet.{k}": torch.from_numpy(v)
          for k, v in eab_sd.items()}
    sd.update({f"{prefix}postnet.{k}": torch.from_numpy(v)
               for k, v in gag_sd.items()})
    return sd


def write_pth(directory, prefix: str = "module.") -> str:
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(str(directory), f"{STEP}.pth")
    torch.save({"model_state_dict": reference_sd(prefix),
                "iteration": STEP, "epoch": EPOCH}, path)
    return path


@pytest.fixture(scope="module")
def pth(tmp_path_factory):
    return write_pth(tmp_path_factory.mktemp("ckpts"))


def assert_same_tree(ours: dict, ref: dict) -> None:
    """The same keys, and every array the same dtype, shape and bits."""
    ours, ref = flatten_tree(ours), flatten_tree(ref)
    assert sorted(ours) == sorted(ref)
    for k, v in ref.items():
        v = np.asarray(v)
        assert ours[k].dtype == v.dtype and ours[k].shape == v.shape, k
        assert ours[k].tobytes() == v.tobytes(), k


@pytest.mark.parametrize("prefix", ["module.", ""], ids=["ddp", "plain"])
def test_converted_tree_equals_jax(tmp_path, prefix):
    path = write_pth(tmp_path, prefix)
    cfg = small_cfg()
    assert_same_tree(
        t_conv.load_torch_checkpoint(path, port_cfg(cfg).model)["params"],
        j_conv.load_torch_checkpoint(path, cfg.model)["params"])


@pytest.mark.parametrize("net", ["eabnet", "gagnet"])
def test_each_net_converts_like_jax(net):
    sd, _ = _load(f"{net}_small")
    cfg = small_cfg()
    ours = getattr(t_conv, f"convert_{net}")(
        sd, getattr(port_cfg(cfg).model, net))
    assert_same_tree(ours, getattr(j_conv, f"convert_{net}")(
        sd, getattr(cfg.model, net)))


@pytest.mark.parametrize("norm", ["IN", "cLN", "cLN-ref"])
def test_cln_interop_warning_like_jax(norm):
    cfg = small_cfg(norm)
    caught = []
    for conv, model in ((t_conv, port_cfg(cfg).model), (j_conv, cfg.model)):
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            conv._warn_cln_interop(model)
        caught.append([str(x.message) for x in w])
    assert caught[0] == caught[1]
    assert bool(caught[0]) == (norm == "cLN")


@dataclasses.dataclass(frozen=True)
class JaxStateStub:
    """What the JAX package's load_checkpoint touches of a TrainState for
    a .pth (``replace(step=..., params=...)``), without initialising a flax
    model."""

    step: object = 0
    params: object = None

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def test_load_checkpoint_reads_pth_like_jax(pth):
    cfg = small_cfg()
    jstate, jepoch = JC.load_checkpoint(pth, JaxStateStub(), cfg)
    pcfg = port_cfg(cfg)
    state = create_train_state(pcfg, device="cpu")
    state, epoch = PC.load_checkpoint(pth, state, pcfg)
    assert (state.step, epoch) == (int(jstate.step), jepoch) == (STEP, EPOCH)
    assert state.opt_state.count == 0  # the optimizer stays fresh
    assert_same_tree(to_jax_params(state.model), jstate.params)


def test_load_params_reads_pth(pth):
    cfg = port_cfg(small_cfg())
    assert_same_tree(PCK.load_params(pth, cfg.model),
                     j_conv.load_torch_checkpoint(pth, small_cfg().model)
                     ["params"])
    with pytest.raises(ValueError):  # a .pth is converted for a config
        PCK.load_params(pth)


def test_latest_checkpoint_finds_pth(pth):
    d = os.path.dirname(pth)
    assert PCK.latest_checkpoint(d) == JC.latest_checkpoint(d) == pth


def reference_namespace(exp: str, cfg: ExperimentConfig):
    """The reference trainer's argparse namespace for ``cfg``'s model, as
    tests/test_pth_ingestion.py writes it."""
    e, g = cfg.model.eabnet, cfg.model.gagnet
    return argparse.Namespace(
        batch_size=6, mics=3, M=3, sr=16000, wav_len=6.0, win_size=0.020,
        win_shift=0.010, fft_num=320, k1=(2, 3), k2=(1, 3), c=e.c,
        embed_dim=e.embed_dim, kd1=e.kd1, cd1=e.cd1, d_feat=e.d_feat,
        p=e.p, q=e.q, is_causal=True, is_u2=True, bf_type="lstm",
        topo_type="mimo", intra_connect="cat", norm_type="IN",
        ref_mic=0, freeze_eabnet=False,
        gagnet_fft_num=320, gagnet_k1=(2, 3), gagnet_k2=(1, 3),
        gagnet_c=g.c, gagnet_kd1=g.kd1, gagnet_cd1=g.cd1,
        gagnet_d_feat=g.d_feat, gagnet_p=g.p, gagnet_q=g.q,
        gagnet_dilas=[1, 2, 5, 9], gagnet_is_u2=True,
        gagnet_is_causal=True, gagnet_is_squeezed=False,
        gagnet_acti_type="sigmoid", gagnet_intra_connect="cat",
        gagnet_norm_type="IN", dataset="mcse",
        checkpoint_dir=exp, exp_root=exp)


@pytest.fixture(scope="module")
def reference_exp(pth, tmp_path_factory):
    exp = str(tmp_path_factory.mktemp("ref_exp"))
    shutil.copy(pth, os.path.join(exp, f"{STEP}.pth"))
    with open(os.path.join(exp, "args.pickle"), "wb") as f:
        pickle.dump(reference_namespace(exp, small_cfg()), f)
    return exp


def test_reference_experiment_config_equals_jax(reference_exp):
    ours = t_args.load_reference_experiment(reference_exp)
    ref = j_args.load_reference_experiment(reference_exp)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert ours.model.eabnet.c == 16 and ours.model.gagnet.q == 2


@pytest.mark.parametrize("norm", ["IN", "cLN"])
def test_reference_args_map_like_jax(norm):
    """A sparse namespace (defaults filled in) and the reference's cLN
    name, which maps to the port's and the JAX package's cLN-ref."""
    ns = types.SimpleNamespace(c=32, M=4, norm_type=norm, gagnet_p=1,
                               gagnet_norm_type=norm, batch_size=3)
    ours = t_args.config_from_reference_args(ns)
    ref = j_args.config_from_reference_args(ns)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)


def test_load_enhancer_reads_reference_experiment(reference_exp):
    """The port's load_enhancer on the directory against the JAX
    package's Enhancer on what its load_enhancer reads there (its config
    and converted params; its load_enhancer adds a flax init, ~30 s on the
    CPU, whose params the .pth then replaces)."""
    from eabnet_tpu.inference import Enhancer as JEnhancer
    from eabnet_tpu_torch.inference import load_enhancer

    ours = load_enhancer(reference_exp, device="cpu")
    assert ours.cfg.model.eabnet.c == 16 and ours.cfg.model.gagnet.q == 2
    noisy = (np.random.default_rng(1).standard_normal((3, 3200))
             * 0.1).astype(np.float32)
    got = ours(noisy)
    jcfg = j_args.load_reference_experiment(reference_exp)
    jparams = j_conv.load_torch_checkpoint(
        os.path.join(reference_exp, f"{STEP}.pth"), jcfg.model)["params"]
    want = np.asarray(JEnhancer(jcfg, jparams)(noisy))
    assert got.shape == want.shape == (3200,)
    # 2e-5 of the output's peak (1.35 here): float32 rounding through the
    # two models' different summation orders (one ulp on the input moves
    # either output by 5e-6 to 9e-6); the SNR limit is test_torch_release's
    peak = max(1.0, float(np.abs(want).max()))
    assert np.abs(got - want).max() <= 2e-5 * peak
    snr = 10 * np.log10(np.sum(want ** 2) / np.sum((got - want) ** 2))
    assert snr >= 80.0
