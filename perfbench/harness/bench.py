"""A cell's files, found by the names in ``BENCHMARK.json``.

A cell names a configuration and a traffic mix.  The configuration is
``configs/<config>.json``; the traffic mix is ``traffic/<traffic>.json``,
whose ``driver`` names the module in ``drivers/`` that runs it; the
limits its outputs are held to are ``limits/<cell>.json``.  Each metric
is read by ``metrics/<metric>.py``, a module with ``read(run)`` that
returns a number or None.  Nothing here names a cell, so a cell, a
configuration, a traffic mix or a metric is added by adding files and
entries, never by editing one.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType

ROOT = Path(__file__).resolve().parents[2]  # the checkout


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str | None = None) -> ModuleType:
    """Import the file at ``path`` as a module of its own (file names may
    hold dots and dashes, as metric and configuration names do)."""
    mod_name = name or "perfbench_" + path.stem.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass(frozen=True)
class Metric:
    name: str
    unit: str
    better: str
    source: str
    moves: str | None
    workloads: tuple[str, ...] | None
    per_layer: bool


@dataclass
class Cell:
    root: Path
    name: str
    config_name: str
    traffic_name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list[Metric]
    per_layer: list[Metric]

    def driver(self) -> ModuleType:
        return load_module(self.root / "perfbench" / "drivers" / f"{self.traffic['driver']}.py")

    def reference(self) -> ModuleType:
        return load_module(self.root / "perfbench" / "reference" / f"{self.config_name}.py")

    def metric_reader(self, name: str) -> ModuleType:
        return load_module(self.root / "perfbench" / "metrics" / f"{name}.py")


def _metrics(entries: list[dict], per_layer: bool) -> list[Metric]:
    return [
        Metric(
            name=e["name"],
            unit=e["unit"],
            better=e["better"],
            source=e["source"],
            moves=e.get("moves"),
            workloads=tuple(e["workloads"]) if "workloads" in e else None,
            per_layer=per_layer,
        )
        for e in entries
    ]


def cell_metrics(bench: dict, cell: str) -> tuple[list[Metric], list[Metric]]:
    """The end-to-end and the per-layer metrics ``cell`` reports: an
    end-to-end metric with no ``workloads`` key is every cell's; a
    per-layer one with none is every cell's that reports what it moves."""
    e2e = [
        m
        for m in _metrics(bench["end_to_end"], False)
        if m.workloads is None or cell in m.workloads
    ]
    names = {m.name for m in e2e}
    layer = [
        m
        for m in _metrics(bench["per_layer"], True)
        if (cell in m.workloads if m.workloads is not None else m.moves in names)
    ]
    return e2e, layer


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = load_json(root / "BENCHMARK.json")
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have {sorted(entries)}")
    w = entries[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(root / configs[w["config"]]["file"])
    traffic = load_json(root / "perfbench" / "traffic" / f"{w['traffic']}.json")
    limits_path = root / "perfbench" / "limits" / f"{name}.json"
    limits = load_json(limits_path) if limits_path.exists() else {}
    e2e, layer = cell_metrics(bench, name)
    return Cell(
        root=root,
        name=name,
        config_name=w["config"],
        traffic_name=w["traffic"],
        chips=int(w["chips"]),
        config=config,
        traffic=traffic,
        limits=limits,
        end_to_end=e2e,
        per_layer=layer,
    )

