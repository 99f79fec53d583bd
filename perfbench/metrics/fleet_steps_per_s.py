"""Agent steps (one TD update of ``batch_size`` rows for one agent)
trained across the fleet over the whole window, per second."""


def read(run):
    w = run.window
    return w["units"] / w["seconds"] if w.get("units") else None
