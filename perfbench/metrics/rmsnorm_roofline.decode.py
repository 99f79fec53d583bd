"""Kernel C (``rmsnorm``) in the profiled decode steps: the bytes its
launches need ([batch, hidden] bf16 rows read and written once, two a
layer and the final one a step) over their device time, as a share of
the least time the card's bandwidth allows, in percent.  Nothing where
the trace's launches are not that count."""

from perfbench.roofline import lm
from perfbench.roofline.peaks import peaks, roofline_share


def read(run):
    p, prof = peaks(run.device), run.profile
    if p is None or prof is None or not prof.units:
        return None
    c = run.cell.config
    launches, seconds = prof.kernel("rmsnorm_")
    if launches != prof.units * lm.rmsnorm_launches_per_forward(c) or seconds <= 0:
        return None
    nbytes = launches * lm.rmsnorm_bytes(c, run.window["batch"])
    return roofline_share(0.0, nbytes, seconds, p, 1.0)
