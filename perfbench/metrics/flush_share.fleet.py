"""The share of the fleet's unprofiled window spent inside the fleet
engine's flushes (the program's ``fleet.flush`` wall spans), in percent:
the rest is collection, replay planning and the scheduler."""


def read(run):
    tel, w = run.telemetry, run.window
    if tel is None or w.get("tel_t0") is None:
        return None
    lo = w["tel_t0"]
    hi = lo + w["unprofiled_s"]
    inside = 0.0
    for s in tel.tracer.spans("fleet.flush"):
        inside += max(0.0, min(s["t1"], hi) - max(s["t0"], lo))
    return 100.0 * inside / (hi - lo) if inside else None
