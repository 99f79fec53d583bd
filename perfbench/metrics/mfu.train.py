"""The model's training work over the unprofiled steps of the window as
a share of the card's bf16 peak, in percent: per token 6 x the weights
it multiplies by plus its causal attention forward and backward, from
the configuration (``roofline/lm.py``); no recompute, no capacity
padding."""

from perfbench.roofline import lm
from perfbench.roofline.peaks import peaks


def read(run):
    p, prof, w = peaks(run.device), run.profiler, run.window
    if p is None or prof is None or prof.started_at is None or not prof.started_units:
        return None
    seconds = prof.started_at - run.window_start
    flops = prof.started_units * lm.train_flops_per_token(run.cell.config, w["model"]["seq"])
    return 100.0 * flops / (seconds * p["bf16_flops"])
