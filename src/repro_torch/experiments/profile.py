"""Where the main path's time goes on the card.

    PYTHONPATH=src python -m repro_torch.experiments.profile

Profiles the run ``chip_smoke.py`` drives: ``paper_fig2 --fast`` with
the full DQN width ``DQNConfig()``.  The scenario runs on the CUDA card
from one seed three times: a warm-up, a plain run for the wall times,
and a run under ``torch.profiler`` (CPU + CUDA activities) for the
device side.  Prints one JSON object with, for the training run
(``system.run()``: collection + flushes) and the final evaluation
separately: the unprofiled wall seconds, the device's busy seconds (the
sum of CUDA kernel and memcpy time the profiler saw), the idle share
``1 - busy / profiled wall`` (both from the profiled window), the device
operations launched, and the ten kernels with the most device time.  A
third section profiles eight stacked train steps alone
(``FleetSteps.train_chunk`` for the scenario's agents on a random pool):
wall and device time and device operations per step.
"""

from __future__ import annotations

import json
import sys
import time
from dataclasses import replace

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs.adfll_dqn import DQNConfig
from repro_torch.core.erb import flat_width
from repro_torch.experiments.registry import get_scenario
from repro_torch.experiments.runner import build, evaluate_into
from repro_torch.rl.fleet import FleetSteps

ACTIVITIES = [ProfilerActivity.CPU, ProfilerActivity.CUDA]


def _device_summary(prof, wall_s: float) -> dict:
    rows = [
        e
        for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total
    ]
    busy_s = sum(e.self_device_time_total for e in rows) / 1e6
    top = sorted(rows, key=lambda e: e.self_device_time_total, reverse=True)[:10]
    return {
        "profiled_wall_s": wall_s,
        "device_busy_s": busy_s,
        "idle_share": 1.0 - busy_s / wall_s,
        "device_ops": sum(e.count for e in rows),
        "top": [
            {
                "name": e.key[:80],
                "count": e.count,
                "ms": e.self_device_time_total / 1e3,
            }
            for e in top
        ],
    }


def _timed(fn) -> tuple[object, float]:
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _profile_steps(cfg: DQNConfig, n_agents: int, k_steps: int = 8) -> dict:
    """Stacked train steps alone: ``k_steps`` steps of ``n_agents`` agents
    on a random pool of valid rows, after one warm-up chunk."""
    rng = np.random.default_rng(0)
    steps = FleetSteps(cfg, "cuda")
    slots = [steps.init_slot(seed) for seed in range(n_agents)]
    state = slots[0].map(lambda *xs: torch.cat(xs), *slots[1:])
    rows = 4096
    pool = rng.random((rows, flat_width(cfg.box_size)), dtype=np.float32)
    obs_f = int(np.prod(cfg.box_size))
    pool[:, obs_f + 3] = rng.integers(0, cfg.n_actions, rows)  # action column
    pool = torch.from_numpy(pool).cuda()
    idx = torch.from_numpy(
        rng.integers(0, rows, (k_steps, n_agents, cfg.batch_size)).astype(np.int32)
    ).cuda()
    _timed(lambda: steps.train_chunk(state, pool, idx))  # warm-up
    with profile(activities=ACTIVITIES) as prof:
        _, wall_s = _timed(lambda: steps.train_chunk(state, pool, idx))
    dev = _device_summary(prof, wall_s)
    return {
        "agents": n_agents,
        "steps": k_steps,
        "wall_ms_per_step": wall_s / k_steps * 1e3,
        "device_ms_per_step": dev["device_busy_s"] / k_steps * 1e3,
        "device_ops_per_step": dev["device_ops"] / k_steps,
        "idle_share": dev["idle_share"],
        "top": dev["top"],
    }


def profile_main_path() -> dict:
    spec = replace(get_scenario("paper_fig2"), dqn=DQNConfig()).fast()
    out = {"scenario": "paper_fig2 --fast, dqn=DQNConfig()"}
    # a warm-up run (first-use costs: cuDNN setup, lazy loading), then a
    # plain one for the wall times without the profiler's host overhead
    for _ in range(2):
        system = build(spec, device="cuda")
        report, run_s = _timed(system.run)
        _, eval_s = _timed(lambda: evaluate_into(report, system, spec))
    # the same run (same seeds, same work) under the profiler
    system = build(spec, device="cuda")
    with profile(activities=ACTIVITIES) as prof_run:
        report, prun_s = _timed(system.run)
    with profile(activities=ACTIVITIES) as prof_eval:
        _, peval_s = _timed(lambda: evaluate_into(report, system, spec))
    out["run"] = {
        "wall_s": run_s,
        "agent_steps": system.engine.n_steps_trained,
        "stacked_steps": system.engine.n_chunk_steps,
        **_device_summary(prof_run, prun_s),
    }
    out["eval"] = {"wall_s": eval_s, **_device_summary(prof_eval, peval_s)}
    out["step"] = _profile_steps(spec.dqn, spec.sys.n_agents)
    out["mean_dist_err"] = report.mean_dist_err
    return out


def main() -> int:
    result = profile_main_path()
    result["device"] = torch.cuda.get_device_name(0)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
