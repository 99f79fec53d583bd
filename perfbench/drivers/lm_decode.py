"""A language model serves in a closed loop of static batches:
``launch/serve.py::generate`` (one prefill of the batch, then greedy
decode steps through the latent cache) on ``batch`` prompts of one
length, ``gen`` tokens each.  The prompt lengths follow the traffic
file's fixed ``cycle``, the same for every seed; the seed draws the
token ids and the weights.

Set-up builds the model with the weights the benchmark drew from the
seed and generates two tokens at every prompt length of the cycle,
which warms every shape the window uses.  The window runs whole cycles
from the cycle's start, and ends at the first end of a cycle after
``--seconds`` have passed, so every window serves the traffic file's
mix exactly; a unit is a served token (the prefill's and each decode
step's).

The check takes a batch of the longest prompts the window served (drawn
from the seed) and runs the reference over every one of its prompts with
its served tokens: each served token's gap below the reference's best
logit at its position, their mean and their widest over the batch, and
the share of served tokens that are not the reference's best.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from perfbench.drivers import lm_common
from perfbench.roofline import lm

FAULTS = ("altered",)


class Driver:
    check_needs_window = True

    def __init__(self, run):
        self.run = run
        self.c = run.cell.config
        self.tr = run.cell.traffic
        self.ref = run.cell.reference()

    def setup(self) -> None:
        from repro_torch.launch.serve import generate
        from repro_torch.models.model import Model

        run = self.run
        self.b, self.gen = int(self.tr["batch"]), int(self.tr["gen"])
        self.cycle = [int(x) for x in self.tr["cycle"]]
        cfg = self.cfg = lm_common.port_config(self.c)
        self.model = Model(cfg, run.device)
        self.params = lm_common.draw_params(cfg, run.seed, run.device)
        self.stream = lm_common.TokenStream(run.seed, cfg.vocab_size, run.device)
        self._generate = generate
        self._step_hook = None
        serve_step = self.model.serve_step

        def watched(params, caches, batch):
            out = serve_step(params, caches, batch)
            if self._step_hook is not None:
                out = self._step_hook(out)
            return out

        self.model.serve_step = watched
        run.note("model and weights built")
        for length in sorted(set(self.cycle)):
            self._generate(self.model, self.params, self.stream(self.b, length), 2)
        if run.device.type == "cuda":
            torch.cuda.synchronize(run.device)

    def _fault_hook(self):
        if self.run.fault is None:
            return None
        if self.run.fault not in FAULTS:
            raise ValueError(f"unknown fault {self.run.fault!r}; have {FAULTS}")

        def altered(out):
            # row 0's answer altered where it is produced: each of its
            # decode tokens is another than the logits' best
            lg, caches = out
            lg = lg.clone()
            best = lg[0].argmax()
            lg[0, (best + 1) % lg.shape[1]] = lg[0, best] + 1.0
            return lg, caches

        return altered

    def window(self, seconds: float) -> None:
        run, b, g = self.run, self.b, self.gen
        c = self.c
        fault = self._fault_hook()
        state = {"steps": 0, "flops": 0.0, "in_batch": 0, "length": 0}
        max_prof = run.profiler.max_units if run.profiler is not None else 0
        log = []  # (perf_counter, decode steps, model flops so far)

        def on_step(out):
            state["steps"] += 1
            state["in_batch"] += 1
            ctx = b * (state["length"] + state["in_batch"])
            state["flops"] += lm.forward_flops(c, b, ctx)
            log.append((time.perf_counter(), state["steps"], state["flops"]))
            # the profiler starts only where the batch's decode steps
            # left can fill its span
            run.tick(state["steps"], can_start=g - state["in_batch"] >= max_prof)
            return out if fault is None else fault(out)

        self._step_hook = on_step
        served, batches = 0, []
        cursor = 0
        t0 = run.start_window()
        deadline = t0 + seconds
        while True:
            length = self.cycle[cursor % len(self.cycle)]
            cursor += 1
            state["length"], state["in_batch"] = length, 0
            prompt = self.stream(b, length)
            state["flops"] += lm.prefill_flops(c, b, length)
            out = self._generate(self.model, self.params, prompt, g)
            bad = (~torch.isfinite(out.logits).all(2).all(0)).sum()
            batches.append((length, prompt.cpu(), out.tokens.cpu(), int(bad)))
            served += b * (g + 1)
            if cursor % len(self.cycle) == 0 and time.perf_counter() >= deadline:
                break
        t1 = time.perf_counter()
        self._step_hook = None
        unprofiled_s = run.end_window(state["steps"])
        self.batches = batches
        run.attempted = b * len(batches)
        run.failed = sum(x[3] for x in batches)
        run.window = {
            "seconds": t1 - t0,
            "units": served,
            "batches": len(batches),
            "unprofiled_s": unprofiled_s,
            "t0": t0,
            "log": log,
            "batch": b,
        }

    def check(self, mode: str) -> dict:
        """The widest gap of a served token below the reference's best
        logit over one batch of the longest prompts served.
        ``mode="control"``: the token the reference in float8 puts first
        at each of those positions, read against the reference."""
        dev = self.run.device
        self.model = None
        from perfbench.harness.runner import free_device

        free_device()
        longest = max(x[0] for x in self.batches)
        pool = [x for x in self.batches if x[0] == longest]
        pick = pool[int(np.random.default_rng(self.run.seed).integers(len(pool)))]
        length, prompt, tokens, _ = pick
        seq = torch.cat([prompt, tokens[:, :-1]], 1).to(dev)
        served = tokens.to(dev)
        self.ref.precision("fp32")
        ref = self.ref.served_logits(self.c, self.params, seq, length)
        best = ref.max(-1).values
        if mode == "control":
            self.ref.precision("fp8")
            low = self.ref.served_logits(self.c, self.params, seq, length)
            self.ref.precision("fp32")
            served = low.argmax(-1)
            del low
        gap = best - ref.gather(-1, served.long()[..., None])[..., 0]
        return {
            "token_gap": float(gap.max()),
            "token_gap_mean": float(gap.mean()),
            "token_disagree": float((gap > 0).float().mean()),
        }


# -- what the metric readers take from a window --------------------------------
def before_profile(run) -> tuple[float, float] | None:
    """(seconds, model flops) from the window's start to the decode step
    where the profiler started."""
    prof, w = run.profiler, run.window
    if prof is None or prof.started_at is None:
        return None
    done = [e for e in w["log"] if e[0] <= prof.started_at]
    if not done:
        return None
    return done[-1][0] - w["t0"], done[-1][2]
