"""The plain reference against the program's CPU path at a tiny size, the
seeded weights, and what the harness and the reference may load."""

from __future__ import annotations

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import harness, weights
from benchmark.drivers import serve, train
from benchmark.reference.model import Composed
from benchmark.tests.tiny import ROOT, tiny_cell, tiny_config

CONFIGS = ("composed_9mic", "eabnet_9mic_cln")


@pytest.mark.parametrize("config", CONFIGS)
def test_reference_serves_as_the_program(config):
    """The Enhancer's CPU path and the reference agree on the same
    weights and padded batch to float32 rounding."""
    cell = tiny_cell("serve", config)
    enh, ref, ring = serve.setup(cell, 11, "cpu")
    for batch in ring[:2]:
        got = enh.enhance_batch(batch)
        want = serve.reference_outputs(cell, ref, batch, "cpu")
        assert serve.wav_error(got, want) < 2e-5


@pytest.mark.parametrize("config", CONFIGS)
def test_reference_trains_as_the_program(config):
    """Three float32 steps of the program's train step and of the
    reference, from the same weights on the same batches: the losses,
    and the first gradient and the change of every leaf that the
    reference moves by more than rounding."""
    cell = tiny_cell("train", config)
    exp, model_cfg, state, step, ref, ring = train.setup(cell, 12, "cpu")
    state, prog = train.first_steps(state, step, ring, 3)
    want = train.reference(cell, model_cfg, ref,
                           [ring[k % len(ring)] for k in range(3)], 2)
    got = train.compare(prog, want)
    look = train.look(prog, want)
    assert got["loss_gap"] < 1e-5 and max(look["loss_gaps"]) < 1e-5
    assert look["grad_median"] < 1e-4 and look["change_median"] < 1e-3
    assert got["grad_err"] < 1e-4
    # at this size some of IN's rounding-only leaves (the biases right
    # before a norm that takes out what they add) pass the thousandth
    # rule, and Adam moves them by rounding
    assert got["change_gap"] < (1e-2 if config == "eabnet_9mic_cln"
                                else 0.3)


@pytest.mark.parametrize("config", CONFIGS)
def test_released_names_and_sizes(config):
    """The reference holds the program's parameters by name and shape at
    the published widths: 8,789,307 of them."""
    from eabnet_tpu_torch.config import ExperimentConfig
    from eabnet_tpu_torch.models import build_model

    with open(ROOT / "benchmark" / "configs" / f"{config}.json") as f:
        cfg = json.load(f)
    with torch.device("meta"):
        ref = Composed(cfg["model"])
        prog = build_model(ExperimentConfig.from_dict(
            {"model": cfg["model"]}).model)
    shapes = {n: tuple(p.shape) for n, p in ref.named_parameters()}
    assert shapes == {n: tuple(p.shape) for n, p in prog.named_parameters()}
    assert sum(p.numel() for p in ref.parameters()) == cfg["parameters"]


def test_config_files_copy_the_release():
    for config in CONFIGS:
        with open(ROOT / "benchmark" / "configs" / f"{config}.json") as f:
            cfg = json.load(f)
        with open(ROOT / "release" / config / "config.json") as f:
            rel = json.load(f)
        assert cfg["model"] == rel["model"] and cfg["stft"] == rel["stft"]
        for k in ("lr", "grad_clip", "compute_dtype"):
            assert cfg["train"][k] == rel["train"][k]
        assert cfg["reduced"] == []


def test_weights_follow_the_seed():
    cfg = tiny_config()["model"]
    a, b, c = (dict((n, w.clone()) for n, w in weights.draw(
        Composed(cfg), s, "cpu").items()) for s in (2 ** 31 + 7, 2 ** 31 + 7,
                                                    3))
    assert all(torch.equal(a[n], b[n]) for n in a)
    assert not all(torch.equal(a[n], c[n]) for n in a)
    k = a["eabnet.en.unet_0.in_conv.conv.kernel"]
    fan_in = k.shape[1] * k.shape[2] * k.shape[3]
    assert abs(float(k.std()) * fan_in ** 0.5 - 1.0) < 0.2
    assert float(k.abs().max()) <= 2.0 / fan_in ** 0.5 / 0.8796 + 1e-6
    alpha = a["eabnet.en.unet_0.in_act.alpha"]
    assert abs(float(alpha.mean()) - 0.25) < 0.05


def test_jax_tree_loads_into_the_program():
    from eabnet_tpu_torch.config import ExperimentConfig
    from eabnet_tpu_torch.models import build_model
    from eabnet_tpu_torch.weights import load_jax_params

    cfg = tiny_config()
    ref = Composed(cfg["model"])
    drawn = weights.draw(ref, 5, "cpu")
    prog = load_jax_params(build_model(ExperimentConfig.from_dict(
        {"model": cfg["model"]}).model), weights.jax_tree(ref, drawn))
    for n, p in prog.named_parameters():
        assert torch.equal(p, drawn[n]), n


def _top_level_modules(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + (
        "\nimport sys, json\n"
        "print(json.dumps(sorted({m.split('.', 1)[0] for m in sys.modules})))"
    )], cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "USE_FLAX": "0"})
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    """A whole serving and training run of the harness (tiny, on the
    CPU) leaves no module whose top-level name is jax, jaxlib, flax or
    eabnet_tpu in its process."""
    tops = _top_level_modules(
        "from benchmark.tests.tiny import tiny_cell\n"
        "from benchmark.drivers import serve, train\n"
        "import benchmark.run, benchmark.control\n"
        "serve.run(tiny_cell('serve'), 1, 0.2, False, device='cpu')\n"
        "train.run(tiny_cell('train'), 1, 0.2, False, device='cpu')\n")
    assert "eabnet_tpu_torch" in tops
    assert not tops & set(harness.FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program():
    tops = _top_level_modules(
        "import benchmark.reference.model, benchmark.reference.dsp\n"
        "import benchmark.reference.train, benchmark.reference.precision\n"
        "import benchmark.weights, benchmark.traffic, benchmark.flops\n"
        "import benchmark.peaks, benchmark.trace\n"
        "from benchmark.tests.tiny import tiny_config\n"
        "from benchmark.reference.model import Composed\n"
        "import torch\n"
        "m = Composed(tiny_config()['model'])\n"
        "m(torch.zeros(1, 4, 161, 3, 2))\n")
    assert not tops & {"eabnet_tpu_torch", *harness.FORBIDDEN}


def test_precisions_round_as_stated():
    from benchmark.reference.precision import bf16, e4m3, every_op, tf32

    x = torch.tensor([1.0 + 2 ** -12, 1.0 + 3 * 2 ** -12, 1.0 + 2 ** -9,
                      -3.0, 0.0])
    assert torch.equal(tf32(x), torch.tensor([1.0, 1.0 + 2 ** -10,
                                              1.0 + 2 ** -9, -3.0, 0.0]))
    y = torch.linspace(-448.0, 448.0, 1001)
    rel = ((e4m3(y) - y).abs() / y.abs().clamp(min=1.0)).max()
    assert 2 ** -5 <= float(rel) <= 2 ** -4 + 1e-6
    assert np.isfinite(e4m3(torch.zeros(3))).all()
    assert e4m3(torch.zeros(0)).numel() == 0
    a = torch.tensor([1.0 + 2 ** -9, 3.0], requires_grad=True)
    w = torch.ones(1, 1, 3, requires_grad=True)
    with every_op(bf16) as seen:
        b = a * 1.0
        v = b[:1]
        b.add_(2 ** -10)
        (b * b).sum().backward()
        torch.nn.functional.conv1d(torch.ones(1, 1, 4), w).sum().backward()
    assert seen["backward"] >= 1 and seen["ops"] > seen["backward"]
    assert torch.equal(b.detach(), torch.tensor([1.0, 3.0]))  # in place
    assert v._base is b  # a view stays a view
    assert torch.equal(a.grad, torch.tensor([2.0, 6.0]))
