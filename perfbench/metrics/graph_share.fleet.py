"""The share of the fleet's agent steps trained by a replayed CUDA graph,
in percent: over the ``fleet.flush`` spans that ended in the span
readers' window (``collect_share.fleet``: to the flush boundary where
the profiler was asked to start), the ``jobs x k_steps`` of those whose
``graph`` argument is ``"replay"`` over those of all of them.  None
where no such span carries the argument (a program that captures no
graph), where the run has no telemetry, or where its tracer dropped
events."""

from pathlib import Path

from perfbench.harness.bench import load_module

_collect = load_module(Path(__file__).with_name("collect_share.fleet.py"))


def read(run):
    part = _collect.span_window(run)
    if part is None:
        return None
    lo, hi, _ = part
    flushes = [
        s["args"]
        for s in run.telemetry.tracer.spans("fleet.flush")
        if "graph" in s["args"] and lo < s["t1"] <= hi
    ]
    steps = sum(a["jobs"] * a["k_steps"] for a in flushes)
    if not steps:
        return None
    replayed = sum(a["jobs"] * a["k_steps"] for a in flushes if a["graph"] == "replay")
    return 100.0 * replayed / steps
