"""The self time of collection over the fleet's window, in percent: the
program's ``fleet.collect`` wall spans less the ``fleet.flush`` spans
nested in them (reading a slot that has a round pending flushes the
engine from inside collection), so that this share and
``flush_share.fleet`` count no second twice.  None where the program
records no such span (it has no ``parent`` linkage) or its tracer
dropped events.

The fleet's span readers (this one, ``plan_share.fleet``,
``sync_wait_share.fleet``, ``syncs_per_step.fleet``) read the window up
to the flush boundary where the profiler was asked to start, as
``mfu.fleet`` does: the profiler's first start takes seconds and runs
no program work.  ``flush_share.fleet`` reads on to where it had
started."""

from perfbench.drivers.fleet import before_profile


def span_window(run) -> tuple[float, float, int] | None:
    """(start, end, agent steps) of the part of the window the span
    readers read, on the program's wall clock: to the window's end where
    nothing was profiled, else to the flush boundary where the profiler
    was asked to start.  Both ends lie between the scheduler's events,
    so a collection or a plan lies wholly in it or wholly out.  None
    where the run has no telemetry or its tracer dropped events."""
    tel, w = run.telemetry, run.window
    if tel is None or w.get("tel_t0") is None or tel.tracer.n_dropped:
        return None
    lo = w["tel_t0"]
    if run.profile is None:
        return lo, lo + w["unprofiled_s"], w["units"]
    part = before_profile(run)
    return None if part is None else (lo, lo + part[0], part[1])


def self_share(run, name: str) -> float | None:
    """The self time of the wall spans called ``name``, less the
    ``fleet.flush`` spans below them, over the span readers' window."""
    part = span_window(run)
    if part is None:
        return None
    lo, hi, _ = part
    wall = [e for e in run.telemetry.tracer.events if e["kind"] == "span" and "id" in e]
    by_id = {e["id"]: e for e in wall}
    outer = {e["id"] for e in wall if e["name"] == name}
    if not outer:
        return None

    def clip(e) -> float:
        return max(0.0, min(e["t1"], hi) - max(e["t0"], lo))

    inside = sum(clip(by_id[i]) for i in outer)
    for e in wall:
        if e["name"] != "fleet.flush":
            continue
        p = e["parent"]
        while p is not None and p not in outer:
            p = by_id.get(p, {}).get("parent")
        if p is not None:
            inside -= clip(e)
    return 100.0 * inside / (hi - lo)


def collect_syncs(run, lo: float, hi: float) -> list[dict]:
    """The args of the ``fleet.collect`` spans that ended in ``(lo, hi]``
    (each counts its environment steps' blocking copies, ``syncs``, and
    their seconds, ``sync_s``)."""
    return [
        c["args"]
        for c in run.telemetry.tracer.spans("fleet.collect")
        if "syncs" in c["args"] and lo < c["t1"] <= hi
    ]


def read(run):
    return self_share(run, "fleet.collect")
