"""Blocking copies between host and device per agent step over the
fleet's window: those a collection counts for its environment steps
(``syncs`` on the program's ``fleet.collect`` spans) and the program's
``fleet.sync`` wall spans, each that ended in the window, over the
agent steps the window trained.  The window is the span readers'
(``collect_share.fleet``).  None where the program records no such span
or its tracer dropped events."""

from pathlib import Path

from perfbench.harness.bench import load_module

_collect = load_module(Path(__file__).with_name("collect_share.fleet.py"))


def read(run):
    part = _collect.span_window(run)
    if part is None:
        return None
    lo, hi, steps = part
    syncs = run.telemetry.tracer.spans("fleet.sync")
    collects = _collect.collect_syncs(run, lo, hi)
    if not (syncs or collects) or not steps:
        return None
    n = sum(c["syncs"] for c in collects)
    n += sum(1 for s in syncs if lo < s["t1"] <= hi)
    return n / steps
