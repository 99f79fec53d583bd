"""The share of the profiled decode steps' wall time in which no
operation ran on the device, in percent."""


def read(run):
    p = run.profile
    return None if p is None else 100.0 * p.idle_share
