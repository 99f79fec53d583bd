"""The fused KDA decode step (``kda_step``) in the profiled decode steps:
the bytes its launches need (``roofline/kda.py``: per sequence and head
the float32 state read and written, q, k, v, the decay and beta read, o
written; one launch a KDA layer a step) over their device time, as a
share of the least time the card's bandwidth allows, in percent.
Nothing where the trace's launches are not that count."""

from perfbench.roofline import kda
from perfbench.roofline.peaks import peaks, roofline_share


def read(run):
    p, prof = peaks(run.device), run.profile
    if p is None or prof is None or not prof.units:
        return None
    c = run.cell.config
    launches, seconds = prof.kernel("kda_step")
    if launches != prof.units * kda.kda_layers(c) or seconds <= 0:
        return None
    nbytes = launches * kda.kda_step_bytes(c, run.window["batch"])
    return roofline_share(0.0, nbytes, seconds, p, 1.0)
