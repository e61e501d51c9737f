"""The harness is driven by data: a configuration, a cell and a per-layer
metric written only as new files (and entries of BENCHMARK.json) in a
copy of the tree are found by name and reported, and no file of the
benchmark changes."""

from __future__ import annotations

import hashlib
import json
import shutil

from benchmark import harness
from benchmark.tests.tiny import ROOT


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "benchmark").rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_new_files_are_found_by_name(tmp_path):
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = _digests(tmp_path)
    bench = tmp_path / "benchmark"
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())

    cfg = json.loads((bench / "configs" / "composed_9mic.json").read_text())
    cfg["model"]["gagnet"]["q"] = 2
    (bench / "configs" / "composed_q2.json").write_text(json.dumps(cfg))
    wl = json.loads(
        (bench / "workloads" / "serve_b8.composed_9mic.json").read_text())
    wl["traffic"]["batch"] = 1
    (bench / "workloads" / "serve_b1.composed_q2.json").write_text(
        json.dumps(wl))
    (bench / "metrics" / "rows_per_call.serve.py").write_text(
        "def read(ctx):\n"
        "    return sum(c['rows'] for c in ctx.calls) / len(ctx.calls)\n")
    spec["configs"].append({**spec["configs"][0], "name": "composed_q2",
                            "file": "benchmark/configs/composed_q2.json"})
    spec["workloads"].append({"name": "serve_b1.composed_q2",
                              "config": "composed_q2", "traffic": "serve_b1",
                              "chips": 1, "why": "a test"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "serve_b8.composed_9mic" in m.get("workloads", []):
            m["workloads"].append("serve_b1.composed_q2")
    spec["per_layer"].append({
        "name": "rows_per_call.serve", "unit": "rows", "better": "higher",
        "source": "program_counter", "layer": "entry",
        "moves": "audio_s_per_s", "workloads": ["serve_b1.composed_q2"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    cell = harness.find_cell("serve_b1.composed_q2", tmp_path)
    assert cell.config["model"]["gagnet"]["q"] == 2
    assert cell.workload["traffic"]["batch"] == 1
    assert {m["name"] for m in cell.end_to_end} == {
        "audio_s_per_s", "call_ms_p95", "setup_s"}
    names = [m["name"] for m in cell.per_layer]
    assert "rows_per_call.serve" in names and "mfu.serve" in names
    ctx = harness.Context(None, [{"rows": 1}, {"rows": 1}], cell.config,
                          "float32")
    assert harness.read_per_layer(cell, ctx) == {
        "rows_per_call.serve": {"value": 1.0, "unit": "rows"}}
    after = _digests(tmp_path)
    assert all(after[p] == d for p, d in before.items())
    assert set(after) - set(before) == {
        p.relative_to(tmp_path) for p in (
            bench / "configs" / "composed_q2.json",
            bench / "workloads" / "serve_b1.composed_q2.json",
            bench / "metrics" / "rows_per_call.serve.py")}


def test_every_cell_has_its_files():
    spec = harness.load_spec(ROOT)
    for w in spec["workloads"]:
        cell = harness.find_cell(w["name"], ROOT)
        assert cell.workload["driver"] in ("serve", "train")
        assert any(m["name"] == "setup_s" for m in cell.end_to_end)
        assert len(cell.end_to_end) >= 2 and cell.per_layer
        for m in cell.per_layer:
            assert (ROOT / "benchmark" / "metrics" /
                    f"{m['name']}.py").exists()
