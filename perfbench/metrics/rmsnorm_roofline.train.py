"""Kernel C (``rmsnorm``) in the profiled train steps: the bytes its
forward launches need at the step's shape ([batch x seq, hidden] bf16
rows, each read and written once) over its device time, as a share of
the least time the card's bandwidth allows, in percent.  Nothing where
the trace's launches are not the configuration's count."""

from perfbench.roofline import lm
from perfbench.roofline.peaks import peaks, roofline_share


def read(run):
    p, prof = peaks(run.device), run.profile
    if p is None or prof is None or not prof.units:
        return None
    c, w = run.cell.config, run.window
    steps = prof.units / w["tokens_per_step"]
    launches, seconds = prof.kernel("rmsnorm_")
    want = steps * lm.rmsnorm_launches_per_train_step(c)
    if launches != want or seconds <= 0:
        return None
    nbytes = launches * lm.rmsnorm_bytes(c, w["tokens_per_step"])
    return roofline_share(0.0, nbytes, seconds, p, 1.0)
