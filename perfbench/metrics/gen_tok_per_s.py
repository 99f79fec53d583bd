"""Tokens served over the whole window, per second: each sequence's
prefill token and its decode tokens, the prefills' time included; the
window holds whole batches."""


def read(run):
    w = run.window
    return w["units"] / w["seconds"] if w.get("units") else None
