"""Kernel B (``fused_td``) in the profiled part of the fleet's window:
the bytes its launches need (each flush of n jobs launches it once a
step for n agents) over its device time, as a share of the least time
the card's bandwidth allows, in percent.  Nothing where the trace's
launches are not the flushes' count."""

from perfbench.drivers.fleet import profiled_flushes
from perfbench.roofline import dqn as counts
from perfbench.roofline.peaks import peaks, roofline_share


def read(run):
    p, flushes = peaks(run.device), profiled_flushes(run)
    if p is None or not flushes:
        return None
    dqn, k = run.cell.config["dqn"], run.window["k_steps"]
    launches, seconds = run.profile.kernel("fused_td")
    if launches != k * len(flushes) or seconds <= 0:
        return None
    nbytes = k * sum(counts.fused_td_bytes(dqn, n) for n in flushes)
    return roofline_share(0.0, nbytes, seconds, p, 1.0)
