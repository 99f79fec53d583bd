"""The share of the fleet's window in which the host sat in a blocking
copy between host and device, in percent: the seconds a collection
counts for its environment steps' copies (``sync_s`` on the program's
``fleet.collect`` spans) and the union of the program's ``fleet.sync``
wall spans (every other copy: a cohort's gather index, a flush's), each
of which waits for every operation queued before it.  The window is
the span readers' (``collect_share.fleet``).  None where the program
records no such span or its tracer dropped events."""

from pathlib import Path

from perfbench.harness.bench import load_module

_collect = load_module(Path(__file__).with_name("collect_share.fleet.py"))


def read(run):
    part = _collect.span_window(run)
    if part is None:
        return None
    lo, hi, _ = part
    syncs = run.telemetry.tracer.spans("fleet.sync")
    collects = _collect.collect_syncs(run, lo, hi)
    if not syncs and not collects:
        return None
    covered, end = sum(c["sync_s"] for c in collects), lo
    for s in sorted(syncs, key=lambda s: s["t0"]):
        a, b = max(s["t0"], end), min(s["t1"], hi)
        if b > a:
            covered += b - a
            end = b
    return 100.0 * covered / (hi - lo)
