"""Trace exporters: Chrome/Perfetto ``trace_event`` JSON and flat JSONL.

Perfetto layout
---------------
Two synthetic processes separate the clocks so spans never interleave
across timelines:

- pid 1 (``sim``)  — simulated scheduler time; one thread row per
  track ("agent0".."agentN", "gossip", "population", "scheduler").
- pid 2 (``host``) — wall time; thread rows for "fleet", "serve", …

Timestamps are microseconds (the ``trace_event`` unit): sim seconds and
zero-based wall seconds both scale by 1e6.  Metric totals ride along as
``repro.metrics`` metadata on the trace-level ``otherData`` dict so the
Perfetto JSON alone round-trips the registry snapshot; the tracer's
clock anchor rides as ``repro.clock_anchor``, and a wall span's ``id``
and ``parent`` in its ``args``.

JSONL layout
------------
One JSON object per line: first a header row (``{"kind": "header"}``,
with the tracer's ``clock_anchor``), then every trace event verbatim,
then one row per metric series — the shape
:class:`repro_torch.sweeps.store.ReportStore` artifacts use, greppable
and streamable.  ``load_trace`` sniffs either format back into the
common event-dict list.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any

from .trace import Telemetry

_SIM_PID = 1
_WALL_PID = 2
_CLOCK_PID = {"sim": _SIM_PID, "wall": _WALL_PID}
_PROCESS_NAME = {_SIM_PID: "sim", _WALL_PID: "host"}


def _track_order(track: str) -> tuple[int, str, int]:
    """Sort agent tracks numerically, then everything else by name."""
    if track.startswith("agent"):
        suffix = track[5:]
        if suffix.isdigit():
            return (0, "agent", int(suffix))
    return (1, track, 0)


def to_perfetto(tel: Telemetry) -> dict[str, Any]:
    """Render the telemetry bundle as a ``trace_event`` JSON object."""
    events: list[dict[str, Any]] = []

    # stable tid assignment per (pid, track), ordered for a tidy UI
    tracks: dict[int, list[str]] = {_SIM_PID: [], _WALL_PID: []}
    for e in tel.tracer.events:
        pid = _CLOCK_PID.get(e["clock"], _SIM_PID)
        if e["track"] not in tracks[pid]:
            tracks[pid].append(e["track"])
    tids: dict[tuple[int, str], int] = {}
    for pid, names in tracks.items():
        for i, name in enumerate(sorted(names, key=_track_order)):
            tids[(pid, name)] = i + 1

    for pid, pname in _PROCESS_NAME.items():
        events.append(
            {
                "name": "process_name",
                "ph": "M",
                "pid": pid,
                "tid": 0,
                "args": {"name": pname},
            }
        )
    for (pid, track), tid in sorted(tids.items(), key=lambda kv: (kv[0][0], kv[1])):
        events.append(
            {
                "name": "thread_name",
                "ph": "M",
                "pid": pid,
                "tid": tid,
                "args": {"name": track},
            }
        )

    for e in tel.tracer.events:
        pid = _CLOCK_PID.get(e["clock"], _SIM_PID)
        tid = tids[(pid, e["track"])]
        ts = e["t0"] * 1e6
        base = {"name": e["name"], "pid": pid, "tid": tid, "ts": ts}
        if e["kind"] == "span":
            args = e["args"]
            if "id" in e:  # a wall span's nesting rides in its args
                args = {**args, "id": e["id"], "parent": e["parent"]}
            events.append(
                {
                    **base,
                    "ph": "X",
                    "dur": max(e["t1"] - e["t0"], 0.0) * 1e6,
                    "args": args,
                }
            )
        elif e["kind"] == "counter":
            events.append(
                {**base, "ph": "C", "args": {e["name"]: e["args"].get("value", 0.0)}}
            )
        else:  # instant
            events.append({**base, "ph": "i", "s": "t", "args": e["args"]})

    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {
            "repro.metrics": tel.registry.summary(),
            "repro.dropped_events": tel.tracer.n_dropped,
            "repro.clock_anchor": tel.tracer.anchor,
        },
    }


def write_perfetto(tel: Telemetry, path: str | Path) -> Path:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(to_perfetto(tel)))
    return path


def write_jsonl(tel: Telemetry, path: str | Path) -> Path:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with path.open("w") as f:
        header = {
            "kind": "header",
            "format": "repro.telemetry/v1",
            "n_events": len(tel.tracer.events),
            "n_dropped_events": tel.tracer.n_dropped,
            "clock_anchor": tel.tracer.anchor,
        }
        f.write(json.dumps(header) + "\n")
        for e in tel.tracer.events:
            f.write(json.dumps(e) + "\n")
        for row in tel.registry.rows():
            f.write(json.dumps({**row, "kind": f"metric.{row['kind']}"}) + "\n")
    return path


def write_trace(tel: Telemetry, path: str | Path) -> Path:
    """Write Perfetto JSON, or JSONL when the suffix is ``.jsonl``."""
    path = Path(path)
    if path.suffix == ".jsonl":
        return write_jsonl(tel, path)
    return write_perfetto(tel, path)


# -- loaders -----------------------------------------------------------------


def _from_perfetto(doc: dict[str, Any]) -> dict[str, Any]:
    """Fold a Perfetto document back into the common event/metric shape."""
    names: dict[tuple[int, int], str] = {}
    pnames: dict[int, str] = {}
    for e in doc.get("traceEvents", []):
        if e.get("ph") == "M" and e.get("name") == "thread_name":
            names[(e["pid"], e["tid"])] = e["args"]["name"]
        elif e.get("ph") == "M" and e.get("name") == "process_name":
            pnames[e["pid"]] = e["args"]["name"]

    events: list[dict[str, Any]] = []
    for e in doc.get("traceEvents", []):
        ph = e.get("ph")
        if ph not in ("X", "i", "C"):
            continue
        clock = "wall" if pnames.get(e["pid"]) == "host" else "sim"
        t0 = e["ts"] / 1e6
        common = {
            "name": e["name"],
            "track": names.get((e["pid"], e["tid"]), f"tid{e.get('tid')}"),
            "clock": clock,
        }
        if ph == "X":
            events.append(
                {
                    "kind": "span",
                    **common,
                    "t0": t0,
                    "t1": t0 + e.get("dur", 0.0) / 1e6,
                    "args": e.get("args", {}),
                }
            )
        elif ph == "C":
            args = e.get("args", {})
            value = args.get(e["name"], next(iter(args.values()), 0.0))
            events.append(
                {
                    "kind": "counter",
                    **common,
                    "t0": t0,
                    "t1": t0,
                    "args": {"value": value},
                }
            )
        else:
            events.append(
                {
                    "kind": "instant",
                    **common,
                    "t0": t0,
                    "t1": t0,
                    "args": e.get("args", {}),
                }
            )
    metrics = doc.get("otherData", {}).get("repro.metrics", [])
    return {"events": events, "metrics": metrics}


def _from_jsonl(lines: list[dict[str, Any]]) -> dict[str, Any]:
    events = [r for r in lines if r.get("kind") in ("span", "instant", "counter")]
    metrics = [
        {**r, "kind": r["kind"][len("metric.") :]}
        for r in lines
        if str(r.get("kind", "")).startswith("metric.")
    ]
    return {"events": events, "metrics": metrics}


def load_trace(path: str | Path) -> dict[str, Any]:
    """Load either export format into ``{"events": [...], "metrics": [...]}``."""
    text = Path(path).read_text()
    stripped = text.lstrip()
    if stripped.startswith("{") and "\n{" not in stripped.rstrip():
        doc = json.loads(stripped)
        if "traceEvents" in doc:
            return _from_perfetto(doc)
        return _from_jsonl([doc])
    return _from_jsonl([json.loads(line) for line in text.splitlines() if line.strip()])


__all__ = [
    "load_trace",
    "to_perfetto",
    "write_jsonl",
    "write_perfetto",
    "write_trace",
]
