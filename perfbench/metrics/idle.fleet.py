"""The share of the profiled part of the fleet's window in which no
operation ran on the device, in percent."""


def read(run):
    p = run.profile
    return None if p is None else 100.0 * p.idle_share
