"""Tokens trained over the whole window, per second (the window waits
for the card at its end)."""


def read(run):
    w = run.window
    return w["units"] / w["seconds"] if w.get("units") else None
