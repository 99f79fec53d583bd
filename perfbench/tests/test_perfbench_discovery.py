"""Cells, configurations, traffic mixes and metrics are found by name,
and a new cell, configuration and metric need only new files and new
``BENCHMARK.json`` entries."""

from __future__ import annotations

import json
import shutil

from conftest import ROOT, SMALL_DQN

from perfbench.harness import bench, runner


def _bench() -> dict:
    return bench.load_json(ROOT / "BENCHMARK.json")


def test_every_cell_finds_its_files():
    b = _bench()
    for w in b["workloads"]:
        cell = bench.load_cell(w["name"])
        assert cell.chips == w["chips"]
        assert hasattr(cell.driver(), "Driver")
        assert hasattr(cell.reference(), "precision")
        assert cell.limits, f"{w['name']}: no limits file"
        assert cell.end_to_end and cell.per_layer
        names = {m.name for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2


def test_every_metric_has_a_reader():
    b = _bench()
    cell = bench.load_cell(b["workloads"][0]["name"])
    for m in b["end_to_end"] + b["per_layer"]:
        assert callable(cell.metric_reader(m["name"]).read), m["name"]


def test_every_config_file_lies_under_paths():
    b = _bench()
    for c in b["configs"]:
        assert c["file"].startswith(tuple(p + "/" for p in b["paths"]))
        data = bench.load_json(ROOT / c["file"])
        assert data["reduced"] == c["reduced"]


def test_a_cell_added_by_files_alone(tmp_path):
    """A dummy configuration, traffic mix, cell, per-layer metric and
    limits, written as new files and new entries into a copy of the
    checkout's benchmark, run without an edit to any file."""
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__", "tests"))  # fmt: skip
    b = _bench()
    cfg = bench.load_json(ROOT / "perfbench" / "configs" / "adfll-dqn.json")
    cfg.update(name="dummy-dqn", dqn=SMALL_DQN)
    (tmp_path / "perfbench" / "configs" / "dummy-dqn.json").write_text(json.dumps(cfg))
    shutil.copy(ROOT / "perfbench" / "reference" / "adfll-dqn.py",
                tmp_path / "perfbench" / "reference" / "dummy-dqn.py")  # fmt: skip
    traffic = bench.load_json(ROOT / "perfbench" / "traffic" / "fleet_paper.json")
    traffic["warmup_flushes"] = 2
    (tmp_path / "perfbench" / "traffic" / "dummy_loop.json").write_text(json.dumps(traffic))
    limits = bench.load_json(ROOT / "perfbench" / "limits" / "adfll-dqn.fleet_paper.json")
    (tmp_path / "perfbench" / "limits" / "dummy-dqn.dummy_loop.json").write_text(json.dumps(limits))
    (tmp_path / "perfbench" / "metrics" / "window_s.dummy.py").write_text(
        "def read(run):\n    return run.window['seconds']\n"
    )
    b["configs"].append({"name": "dummy-dqn", "source": "https://example.org/dummy",
                         "file": "perfbench/configs/dummy-dqn.json", "reduced": [],
                         "why": "test"})  # fmt: skip
    b["workloads"].append({"name": "dummy-dqn.dummy_loop", "config": "dummy-dqn",
                           "traffic": "dummy_loop", "chips": 1, "why": "test"})  # fmt: skip
    for m in b["end_to_end"]:
        if m["name"] == "fleet_steps_per_s":
            m["workloads"].append("dummy-dqn.dummy_loop")
    b["per_layer"].append({"name": "window_s.dummy", "unit": "s", "better": "lower",
                           "source": "host_clock", "layer": "test", "moves": "fleet_steps_per_s",
                           "workloads": ["dummy-dqn.dummy_loop"]})  # fmt: skip
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    cell = bench.load_cell("dummy-dqn.dummy_loop", tmp_path)
    assert [m.name for m in cell.per_layer] == ["window_s.dummy"]
    out = runner.run_cell("dummy-dqn.dummy_loop", 3, 0.5, False, device="cpu", root=tmp_path)
    assert out["correct"]
    assert set(out["metrics"]) == {"fleet_steps_per_s", "setup_s"}
    reader = cell.metric_reader("window_s.dummy")
    assert reader.read(type("R", (), {"window": {"seconds": 2.0}})) == 2.0
