"""The controls on the card: at the released widths, the program passes
each cell's limits and the control (the reference in the precision below
the configuration's) fails one of them, and so does half of the
training batch left out; serving on a short ring, training at the cell's
own batch. Needs a CUDA device; skips without
one. On the card:

    python -m pytest -m gpu benchmark/tests/test_bench_card.py
"""

from __future__ import annotations

import copy

import pytest

from benchmark import control, harness
from benchmark.tests.tiny import ROOT


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels)")
    return "cuda"


def _short(name: str) -> harness.Cell:
    cell = copy.deepcopy(harness.find_cell(name, ROOT))
    if cell.workload["driver"] == "serve":
        cell.workload["traffic"].update(ring_batches=2, max_seconds=4.0)
    return cell


def _cells(driver):
    return [w["name"] for w in harness.load_spec(ROOT)["workloads"]
            if harness.find_cell(w["name"], ROOT).workload["driver"]
            == driver]


@pytest.mark.gpu
@pytest.mark.parametrize("name", _cells("serve"))
def test_serving_control_fails(card, name):
    cell = _short(name)
    limit = cell.workload["limits"]["wav_err"]
    r = control.serve_readings(cell, 101, 2, card)
    assert r["program"]["wav_err"] <= limit < r["control_tf32"]["wav_err"]


@pytest.mark.gpu
@pytest.mark.parametrize("name", _cells("train"))
def test_training_control_fails(card, name):
    cell = _short(name)
    limits = cell.workload["limits"]
    r = control.train_readings(cell, 102, card)
    assert all(r["program"][k] <= v for k, v in limits.items())
    for fault in ("control_fp8", "fault_half_batch"):
        assert any(r[fault][k] > limits[k] for k in r[fault]
                   if k in limits), (fault, r[fault])
