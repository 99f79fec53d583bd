"""The model's serving work over the unprofiled part of the window as
a share of the card's bf16 peak, in percent: each prefill (every layer
over every prompt token, the head over the last, causal attention) and
each decode step (every layer and the head over the batch's tokens,
attention over the cache), from the configuration (``roofline/lm.py``)."""

from perfbench.drivers.lm_decode import before_profile
from perfbench.roofline.peaks import peaks


def read(run):
    p, part = peaks(run.device), before_profile(run)
    if p is None or part is None:
        return None
    seconds, flops = part
    return 100.0 * flops / (seconds * p["bf16_flops"])
