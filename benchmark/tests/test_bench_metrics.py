"""The metric arithmetic on the CPU: each kernel's work against the
bounds the port's card runs printed, the model's FLOPs against
``FlopCounterMode`` over the program, the trace's idle share, launches
and breakdown on a synthetic trace, and the end-to-end numbers on
made-up call times."""

from __future__ import annotations

import json

import pytest
import torch

from benchmark import harness, peaks
from benchmark.drivers import serve
from benchmark.flops import tcn_groups
from benchmark.trace import Trace, by_category, idle_gaps, kernel_category
from benchmark.tests.tiny import ROOT

_cache = {}


def reader(name):
    if name not in _cache:
        spec = harness.metric_reader(name, ROOT)
        _cache[name] = spec.__globals__
    return _cache[name]


def ms(flops_bytes, dtype):
    return 1e3 * peaks.least_seconds(*flops_bytes, dtype)


# (T, L) -> least ms, as PERF.md's kernel table gives them
@pytest.mark.parametrize("t, lanes, want", [(701, 161, 0.1656),
                                             (701, 1127, 1.1591),
                                             (701, 1288, 1.3247)])
def test_lstm_forward_bound(t, lanes, want):
    got = ms(reader("lstm_bf_roofline.serve")["work"](t, lanes, "float32"),
             "float32")
    assert got == pytest.approx(want, abs=1e-4)


@pytest.mark.parametrize("lanes, dtype, fwd, bwd", [
    (1127, "float32", 0.9938, 2.9814), (161, "float32", 0.1420, 0.4259),
    (1127, "bfloat16", 0.2071, 0.3365), (2576, "bfloat16", 0.4733, 0.7691)])
def test_lstm_training_bounds(lanes, dtype, fwd, bwd):
    f, b = reader("lstm_bf_roofline.train")["work"](601, lanes, dtype)
    assert ms(f, dtype) == pytest.approx(fwd, abs=1e-4)
    assert ms(b, dtype) == pytest.approx(bwd, abs=1e-4)


TWIN, SINGLE = (6, 5, 64, 256, 2), (4, 3, 64, 256, 1)


@pytest.mark.parametrize("group, b, want", [
    (TWIN, 1, 0.0093), (TWIN, 7, 0.0648), (TWIN, 16, 0.1481),
    (SINGLE, 7, 0.0264), (SINGLE, 16, 0.0603)])
def test_tcm_chain_forward_bound(group, b, want):
    got = ms(reader("tcm_chain_roofline.serve")["work"](b, 701, group,
                                                         "float32"),
             "float32")
    assert got == pytest.approx(want, abs=1e-4)


@pytest.mark.parametrize("group, b, dtype, want", [
    (TWIN, 7, "float32", 0.1667), (SINGLE, 7, "float32", 0.0679),
    (TWIN, 16, "float32", 0.3809), (TWIN, 7, "bfloat16", 0.0113),
    (SINGLE, 16, "bfloat16", 0.0105)])
def test_tcm_chain_backward_bound(group, b, dtype, want):
    _, bwd = reader("tcm_chain_roofline.train")["work"](b, 601, group, dtype)
    assert ms(bwd, dtype) == pytest.approx(want, abs=1e-4)


def test_groups_of_the_released_models():
    with open(ROOT / "benchmark" / "configs" / "composed_9mic.json") as f:
        model = json.load(f)["model"]
    groups = tcn_groups(model)
    assert len(groups) == 21  # the kernel's launches per forward
    assert groups.count(TWIN) == 3 and groups.count((4, 3, 64, 256, 1)) \
        == 18


def test_frame_flops_match_the_counter_over_the_program():
    """The reference's count per frame equals FlopCounterMode over the
    program's own forward (on the CPU, through its plain versions) at
    B = 1, T = 101."""
    from torch.utils.flop_counter import FlopCounterMode

    from benchmark.flops import frame_flops
    from eabnet_tpu_torch.config import ExperimentConfig
    from eabnet_tpu_torch.models import build_model

    with open(ROOT / "benchmark" / "configs" / "composed_9mic.json") as f:
        cfg = json.load(f)
    model = build_model(ExperimentConfig.from_dict(cfg).model).eval()
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        model(torch.zeros(1, 101, 161, 9, 2))
    per_frame = frame_flops(cfg["model"], 161)
    assert per_frame * 101 == pytest.approx(fc.get_total_flops(), rel=2e-3)
    assert per_frame == pytest.approx(0.1198e9, rel=1e-3)


def _trace():
    # two kernels and a copy on one stream, a gap under an aten op and
    # one under a launch call; times in microseconds
    tr = Trace(window_s=1e-3)
    tr.device = [("void lstm_bf_fwd_kernel<float>", 0.0, 100.0),
                 ("Memcpy HtoD (Pageable -> Device)", 90.0, 150.0),
                 ("void at::vectorized_elementwise_kernel", 400.0, 500.0),
                 ("void tcm_chain_fwd_kernel<1>", 800.0, 900.0)]
    tr.host = [("aten::conv2d", 140.0, 450.0),
               ("cudaLaunchKernel", 700.0, 820.0),
               ("cudaLaunchKernel", 300.0, 310.0)]
    tr.launches = 2
    return tr


def test_trace_arithmetic():
    tr = _trace()
    assert tr.busy_s() == pytest.approx(350e-6)
    assert tr.device_seconds(("lstm_bf_fwd",)) == pytest.approx(100e-6)
    assert tr.device_seconds(("nothing",)) is None
    gaps = dict(idle_gaps(tr))
    assert gaps["aten::conv2d"] == pytest.approx(250e-6)
    assert gaps["no host event"] == pytest.approx(300e-6)
    # a gap is named by its middle, not by the call that covers its
    # start (the host's wait for a copy back)
    tr.host.append(("cudaMemcpyAsync", 480.0, 510.0))
    assert dict(idle_gaps(tr))["no host event"] == pytest.approx(300e-6)
    cats = dict(by_category(tr))
    assert cats["port lstm_bf"] == pytest.approx(100e-6)
    assert cats["memcpy/memset"] == pytest.approx(60e-6)
    assert kernel_category("multi_tensor_apply_kernel<...Adam>") == \
        "optimizer foreach"


def _ctx(tr, calls, dtype="float32", plain_s=None):
    with open(ROOT / "benchmark" / "configs" / "composed_9mic.json") as f:
        cfg = json.load(f)
    return harness.Context(tr, calls, cfg, dtype, plain_s)


def test_device_and_model_readers():
    calls = [{"rows": 8, "frames": 1001, "useful_frames": 4800}] * 2
    # the traced window is 1 ms for 2 calls; untraced a call took 0.4 ms
    ctx = _ctx(_trace(), calls, plain_s=4e-4)
    idle = reader("idle_share.serve")["read"](ctx)
    assert idle == pytest.approx(100 * (1 - 175e-6 / 4e-4))
    assert reader("busy_ms_per_call.serve")["read"](ctx) == \
        pytest.approx(0.175)
    assert reader("idle_share.serve")["read"](_ctx(_trace(), calls)) is None
    assert reader("launches_per_call.serve")["read"](ctx) == 1.0
    assert reader("copy_ms.serve")["read"](ctx) == pytest.approx(0.03)
    lstm = reader("lstm_bf_roofline.serve")["read"](ctx)
    least = 2 * peaks.least_seconds(*reader("lstm_bf_roofline.serve")[
        "work"](1001, 8 * 161, "float32"), "float32")
    assert lstm == pytest.approx(100 * least / 100e-6)
    assert reader("mfu.serve")["read"](ctx) == pytest.approx(
        100 * 9600 * ctx.frame_flops() / (8e-4 * 67e12))
    steps = [{"rows": 32, "frames": 601}] * 2
    ctx = _ctx(_trace(), steps, "bfloat16", plain_s=5e-4)
    assert reader("idle_share.train")["read"](ctx) == pytest.approx(
        100 * (1 - 175e-6 / 5e-4))
    assert reader("busy_ms_per_step.train")["read"](ctx) == \
        pytest.approx(0.175)
    assert reader("mfu.train")["read"](ctx) == pytest.approx(
        100 * 3 * 2 * 32 * 601 * ctx.frame_flops() / (1e-3 * 989e12))


def test_readers_are_absent_without_their_kernels():
    tr = _trace()
    tr.device = [d for d in tr.device if "fwd" not in d[0]]
    ctx = _ctx(tr, [{"rows": 8, "frames": 601, "useful_frames": 4808}],
               "bfloat16")
    for name in ("lstm_bf_roofline.serve", "tcm_chain_roofline.serve",
                 "lstm_bf_roofline.train", "tcm_chain_roofline.train",
                 "optimizer_ms.train"):
        assert reader(name)["read"](ctx) is None
    none = _ctx(None, [])
    for m in harness.load_spec(ROOT)["per_layer"]:
        assert reader(m["name"])["read"](none) is None


def test_end_to_end_on_made_up_calls():
    calls = [{"ms": float(v), "audio_s": 48.0} for v in range(1, 101)]
    got = serve.end_to_end(calls, window_s=4.0, setup_s=12.5)
    assert got["audio_s_per_s"]["value"] == pytest.approx(1200.0)
    assert got["call_ms_p95"]["value"] == pytest.approx(95.05)
    assert got["setup_s"] == {"value": 12.5, "unit": "s"}
    assert harness.quantile([3.0, 1.0, 2.0], 0.5) == 2.0
