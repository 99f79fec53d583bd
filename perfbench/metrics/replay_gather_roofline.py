"""Kernel A (``replay_gather``) in the profiled part of the fleet's
window: the bytes its launches need at their shapes (each flush of n
jobs launches it once a step for n x batch rows) over its device time,
as a share of the least time the card's bandwidth allows, in percent.
Nothing where the trace's launches are not the flushes' count."""

from perfbench.drivers.fleet import profiled_flushes
from perfbench.roofline import dqn as counts
from perfbench.roofline.peaks import peaks, roofline_share


def read(run):
    p, flushes = peaks(run.device), profiled_flushes(run)
    if p is None or not flushes:
        return None
    dqn, k = run.cell.config["dqn"], run.window["k_steps"]
    launches, seconds = run.profile.kernel("replay_gather")
    if launches != k * len(flushes) or seconds <= 0:
        return None
    rows = k * dqn["batch_size"] * sum(flushes)
    return roofline_share(0.0, counts.replay_gather_bytes(dqn, rows), seconds, p, 1.0)
