"""The fleet's model work over the unprofiled part of the window as a
share of the card's float32 peak (TF32 where the configuration turns it
on), in percent: each agent step's forward, backward and target forward
over its batch, and a forward for each row collected, from the DQN's
widths (``roofline/dqn.py``)."""

from perfbench.drivers.fleet import before_profile
from perfbench.roofline import dqn as counts
from perfbench.roofline.peaks import float32_peak, peaks


def read(run):
    p = peaks(run.device)
    part = before_profile(run)
    if p is None or part is None:
        return None
    seconds, steps, rows = part
    dqn = run.cell.config["dqn"]
    flops = steps * counts.agent_step_flops(dqn) + rows * counts.forward_flops(dqn)
    peak = float32_peak(p, run.cell.config.get("tf32", False))
    return 100.0 * flops / (seconds * peak)
