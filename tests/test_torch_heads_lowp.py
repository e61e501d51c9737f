"""bf16 and int8w serving with the cnn and miso beamforming heads in the
port against the JAX package's Enhancer at a small width, on the same
flax parameters and a seeded wav: ``tests/test_torch_lowp.py``'s model
rule (R - 6 dB against the JAX package's bf16 / int8w output, bf16 also
R - 3 dB against its float32; int8w also within
``tests/test_quantize.py``'s criteria of the port's own float32), and the
head's Dense kernel packed as int8.
"""

import json

import jax
import numpy as np
import pytest
import torch

from eabnet_tpu.config import ComposedConfig as JComposed
from eabnet_tpu.config import EaBNetConfig as JEaB
from eabnet_tpu.config import ExperimentConfig as JExperiment
from eabnet_tpu.config import GaGNetConfig as JGaG
from eabnet_tpu.inference import Enhancer as JEnhancer
from eabnet_tpu.train.step import create_train_state as j_create_state
from eabnet_tpu_torch.config import ExperimentConfig
from eabnet_tpu_torch.inference import Enhancer
from eabnet_tpu_torch.models import build_model
from eabnet_tpu_torch.utils.quantize import (pack_for_module,
                                             quantize_weights_int8)

from tests.test_torch_heads import HEADS

MODEL_BF16_DB, MODEL_F32_DB = 6.0, 3.0   # tests/test_torch_lowp.py
INT8W_MAX_ERR, INT8W_MIN_CORR = 0.15, 0.99  # tests/test_quantize.py


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for the port: on a host that other test workers
    load, more threads mostly wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def snr_db(ref, est):
    ref, est = (np.asarray(a, np.float64) for a in (ref, est))
    with np.errstate(divide="ignore"):  # identical signals: +inf dB
        return 10 * np.log10(np.sum(ref ** 2) / np.sum((ref - est) ** 2))


# ------------------------------------------------------- bf16 and int8w
def tiny_experiment(head, norm="cLN"):
    return JExperiment(model=JComposed(
        eabnet=JEaB(M=3, c=16, embed_dim=16, cd1=16, p=2, q=1,
                    norm_type=norm, **HEADS[head]),
        gagnet=JGaG(c=12, cd1=12, p=1, q=1, dilas=(1, 2), norm_type=norm)))


@pytest.mark.parametrize("head", HEADS)
def test_head_bf16_and_int8w_serving_against_jax(head):
    jcfg = tiny_experiment(head)
    _, state = j_create_state(jcfg, jax.random.key(0))
    params = jax.tree.map(np.asarray, state.params)
    cfg = ExperimentConfig.from_dict(json.loads(jcfg.to_json()))
    rng = np.random.default_rng(5)
    wav = (rng.standard_normal((3, 8000)) * 0.05).astype(np.float32)
    j = {d: np.asarray(JEnhancer(jcfg, params, compute_dtype=d)(wav))
         for d in ("float32", "bfloat16", "int8w")}
    ours = {d: Enhancer(cfg, params, compute_dtype=d, device="cpu")(wav)
            for d in ("float32", "bfloat16", "int8w")}
    # the head's Dense kernel is packed as int8, as every >= 2-D leaf
    packed = pack_for_module(build_model(cfg.model),
                             quantize_weights_int8(params))
    assert packed["eabnet.bf_map.kernel"][0].dtype == torch.int8
    assert packed["eabnet.bf_map.bias"][0].dtype == torch.float32
    r = snr_db(j["float32"], j["bfloat16"])
    assert snr_db(j["float32"], ours["float32"]) > r + 20
    assert snr_db(j["bfloat16"], ours["bfloat16"]) >= r - MODEL_BF16_DB
    assert snr_db(j["float32"], ours["bfloat16"]) >= r - MODEL_F32_DB
    assert snr_db(j["int8w"], ours["int8w"]) >= r - MODEL_BF16_DB
    err = np.linalg.norm(ours["int8w"] - ours["float32"]) / np.linalg.norm(
        ours["float32"])
    assert err < INT8W_MAX_ERR, err
    assert np.corrcoef(ours["int8w"], ours["float32"])[0, 1] > INT8W_MIN_CORR
