"""Xing4.0's serving work over the unprofiled part of the window as a
share of the card's bf16 peak, in percent: each prefill and each decode
step up to the step where the profiler started, counted from the
window's logged decode steps and the traffic's fixed cycle
(``roofline/xing4.py``: q-LoRA MLA over its context, the dense FFNs, the
router, the shared expert, the routed experts at this card's share, the
mHC sites' projections and mixes, the head)."""

from perfbench.drivers.lm_decode import before_profile
from perfbench.roofline import xing4
from perfbench.roofline.peaks import peaks


def read(run):
    p, part = peaks(run.device), before_profile(run)
    if p is None or part is None:
        return None
    seconds = part[0]
    prof, log = run.profiler, run.window["log"]
    steps = [e[1] for e in log if e[0] <= prof.started_at][-1]
    flops = xing4.served_flops(run.cell.config, run.cell.traffic, steps)
    return 100.0 * flops / (seconds * p["bf16_flops"])
