"""Where the main path's time goes on the card.

    PYTHONPATH=src python -m repro_torch.experiments.profile \
        [--scenario {paper_fig2,flash_crowd,serve_localization}]

Profiles a run ``chip_smoke.py`` drives at the full DQN width
``DQNConfig()``: ``paper_fig2 --fast`` (the default), ``flash_crowd``
at its full population of 4 + 200 agents with ``--fast``'s train steps
and the population phase's evaluation cut (one patient, one task), or
``serve_localization --fast`` (train-while-serve).  The
scenario runs on the CUDA card
from one seed three times: a warm-up, a plain run for the wall times,
and a run under ``torch.profiler`` (CPU + CUDA activities) for the
device side.  Prints one JSON object with, for the training run
(``system.run()``: collection + flushes) and the final evaluation
separately: the unprofiled wall seconds, the device's busy seconds (the
sum of CUDA kernel and memcpy time the profiler saw), the idle share
``1 - busy / profiled wall`` (both from the profiled window), the device
operations launched, and the ten kernels with the most device time.  A
third section profiles eight stacked train steps alone
(``FleetSteps.train_chunk`` for as many agents as the run's widest flush
on a random pool):
the median unprofiled wall of a step over ten chunks, then, from one
profiled chunk, wall and device time and device operations per step.
For ``serve_localization`` a fourth section profiles the serving window
alone: after the run, the scenario's traffic is served once more through
the live service (a warm-up wave), once for the unprofiled wall and once
under the profiler, each wave from the same requests on the same params;
it reports wall and device busy time per tick, the idle share and device
operations per tick.

The profiled training run (not a serving session's) carries a
:class:`~repro_torch.telemetry.Telemetry` on its fleet engine, and its
section adds ``idle_by_span``: the device's idle gaps of 5 us or more
summed by the innermost program wall span (``fleet.collect``,
``fleet.plan``, ``fleet.flush``, ``fleet.sync``) open at each gap's
middle, or ``(no span)``: what the host was doing while the card
waited.
"""

from __future__ import annotations

import argparse
import json
import statistics
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
from repro_torch.serve.traffic import synthetic_requests
from repro_torch.telemetry import Telemetry

ACTIVITIES = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
# the profiled scenarios and their cuts (chip_smoke.py's main and
# population phases): flash_crowd keeps its full population
SCENARIOS = {
    "paper_fig2": {},
    "flash_crowd": dict(fast_population_scale=1.0, eval_patients=1, eval_tasks=1),
    "serve_localization": {},
}


GAP_MIN_US = 5.0  # shorter idle gaps are launch jitter, not named


def _on_device(e) -> bool:
    """A device interval: a kernel, copy or set on the card (not a CUDA
    user annotation, which only marks a host range on the device row)."""
    return e.device_type == torch.autograd.DeviceType.CUDA and not getattr(
        e, "is_user_annotation", False
    )


def idle_by_span(events, tracer, trace_start_ns: int) -> dict[str, float]:
    """Seconds of the device's idle gaps of ``GAP_MIN_US`` or more (between
    the merged intervals of ``events``, a profiler's ``FunctionEvent``s)
    by the name of the innermost wall span of ``tracer`` open at each
    gap's middle, or ``"(no span)"``; largest first.  ``trace_start_ns``
    is the profile's ``kineto_results.trace_start_ns()``."""
    intervals = sorted(
        (e.time_range.start, e.time_range.end) for e in events if _on_device(e)
    )
    merged: list[list[float]] = []
    for t0, t1 in intervals:
        if merged and t0 <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t1)
        else:
            merged.append([t0, t1])
    mids = [
        (0.5 * (a1 + b0), b0 - a1)
        for (_, a1), (b0, _) in zip(merged, merged[1:])
        if b0 - a1 >= GAP_MIN_US
    ]
    # the spans' starts and ends in time order (a start before an end at
    # the same time), swept with the gaps: wall spans nest, so the
    # innermost one open is the last one opened
    spans = [e for e in tracer.events if e["kind"] == "span" and e["clock"] == "wall"]
    bounds = []
    for i, e in enumerate(spans):
        bounds.append((tracer.to_profiler_us(e["t0"], trace_start_ns), 0, i))
        bounds.append((tracer.to_profiler_us(e["t1"], trace_start_ns), 1, i))
    bounds.sort()
    out: dict[str, float] = {}
    open_spans: list[int] = []
    k = 0
    for mid, gap_us in mids:
        while k < len(bounds) and bounds[k][0] <= mid:
            _, ends, i = bounds[k]
            if ends:
                open_spans.remove(i)
            else:
                open_spans.append(i)
            k += 1
        name = spans[open_spans[-1]]["name"] if open_spans else "(no span)"
        out[name] = out.get(name, 0.0) + gap_us / 1e6
    return dict(sorted(out.items(), key=lambda kv: kv[1], reverse=True))


def device_summary(prof, wall_s: float, telemetry: Telemetry | None = None) -> dict:
    """The device side of a profile over ``wall_s`` seconds; with the
    ``telemetry`` that traced the profiled work, ``idle_by_span``.  Named
    ranges (``record_function``, e.g. the zoo's ``models/layers.py::named_ranges``)
    leave a device-side annotation spanning their kernels and the gaps
    between them: they are no operations, and where the profile holds any
    they are listed apart under ``ranges``."""
    rows, ranges = [], []
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total:
            (ranges if getattr(e, "is_user_annotation", False) else rows).append(e)
    busy_s = sum(e.self_device_time_total for e in rows) / 1e6
    top = sorted(rows, key=lambda e: e.self_device_time_total, reverse=True)[:10]
    out = {
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
    if ranges:
        ranges.sort(key=lambda e: e.self_device_time_total, reverse=True)
        out["ranges"] = [
            {"name": e.key, "count": e.count, "ms": e.self_device_time_total / 1e3}
            for e in ranges
        ]
    if telemetry is not None:
        start_ns = prof.profiler.kineto_results.trace_start_ns()
        out["idle_by_span"] = idle_by_span(prof.events(), telemetry.tracer, start_ns)
    return out


def _timed(fn) -> tuple[object, float]:
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _profile_steps(
    cfg: DQNConfig,
    n_agents: int,
    k_steps: int = 8,
    *,
    stats: bool = False,
    repeats: int = 10,
    shards: int = 1,
) -> dict:
    """Stacked train steps alone: ``k_steps`` steps of ``n_agents`` agents
    on a random pool of valid rows, after one warm-up chunk; the median
    unprofiled wall of ``repeats`` chunks.  ``stats`` profiles the
    observatory's chunk (``train_chunk_stats``) instead.  ``shards`` > 1
    splits the agents as a fleet mesh of that many entries on this one
    card does (agent i in shard i % shards): one chunk per shard on its
    rows and its slice of the indices, the outputs concatenated on the
    card, as a sharded ``FleetEngine`` flush runs them."""
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
    chunk = steps.train_chunk_stats if stats else steps.train_chunk
    parts = [
        (
            state.map(lambda x, j=j: x[j::shards].contiguous()),
            idx[:, j::shards].contiguous(),
        )
        for j in range(shards)
    ]

    def run():
        if shards == 1:
            return chunk(state, pool, idx)
        return torch.cat([chunk(s, pool, i)[1] for s, i in parts], 1)

    _timed(run)  # warm-up
    plain = [_timed(run)[1] for _ in range(repeats)]
    with profile(activities=ACTIVITIES) as prof:
        _, wall_s = _timed(run)
    dev = device_summary(prof, wall_s)
    return {
        "agents": n_agents,
        "shards": shards,
        "steps": k_steps,
        "stats": stats,
        "plain_wall_ms_per_step": statistics.median(plain) / k_steps * 1e3,
        "wall_ms_per_step": wall_s / k_steps * 1e3,
        "device_ms_per_step": dev["device_busy_s"] / k_steps * 1e3,
        "device_ops_per_step": dev["device_ops"] / k_steps,
        "idle_share": dev["idle_share"],
        "top": dev["top"],
    }


def _profile_serving(system, spec) -> dict:
    """The scenario's traffic served again through the live service: a
    warm-up wave, a plain one and a profiled one, each of the same
    requests on the same params (the same ticks)."""
    session = system.session
    service = session.service
    requests = synthetic_requests(
        spec.serve_traffic, spec.dqn, n_agents=len(session.agents), tasks=session.tasks
    )

    def wave():
        ticks = service.report.n_ticks
        _, wall_s = _timed(lambda: service.serve(requests))
        return service.report.n_ticks - ticks, wall_s

    wave()
    ticks, plain_s = wave()
    with profile(activities=ACTIVITIES) as prof:
        pticks, wall_s = wave()
    dev = device_summary(prof, wall_s)
    return {
        "requests": len(requests),
        "ticks": ticks,
        "plain_wall_ms_per_tick": plain_s / ticks * 1e3,
        "wall_ms_per_tick": wall_s / pticks * 1e3,
        "device_ms_per_tick": dev["device_busy_s"] / pticks * 1e3,
        "device_ops_per_tick": dev["device_ops"] / pticks,
        "idle_share": dev["idle_share"],
        "requests_per_s": len(requests) / plain_s,
        "top": dev["top"],
    }


def profile_main_path(name: str = "paper_fig2") -> dict:
    cuts = SCENARIOS[name]
    spec = replace(get_scenario(name), dqn=DQNConfig(), **cuts).fast()
    out = {"scenario": f"{name} --fast, dqn=DQNConfig()", "cuts": cuts}
    # a warm-up run (first-use costs: cuDNN setup, lazy loading), then a
    # plain one for the wall times without the profiler's host overhead
    for _ in range(2):
        system = build(spec, device="cuda")
        report, run_s = _timed(system.run)
        _, eval_s = _timed(lambda: evaluate_into(report, system, spec))
    # the same run (same seeds, same work) under the profiler, its fleet
    # engine traced (the engine's telemetry alone: a system-wide bundle
    # would turn on the observatory and change the work; a serving
    # session builds its engine inside the run, untraced)
    system = build(spec, device="cuda")
    serving = spec.system == "serve"
    tel = None
    if not serving:
        tel = system.engine.telemetry = Telemetry()
    with profile(activities=ACTIVITIES) as prof_run:
        report, prun_s = _timed(system.run)
    with profile(activities=ACTIVITIES) as prof_eval:
        _, peval_s = _timed(lambda: evaluate_into(report, system, spec))
    engine = system.session.engine if serving else system.engine
    out["run"] = {
        "wall_s": run_s,
        "agent_steps": engine.n_steps_trained,
        "stacked_steps": engine.n_chunk_steps,
        **device_summary(prof_run, prun_s, tel),
    }
    out["eval"] = {"wall_s": eval_s, **device_summary(prof_eval, peval_s)}
    out["step"] = _profile_steps(spec.dqn, max(engine.flush_sizes))
    if serving:
        out["serve"] = _profile_serving(system, spec)
    out["mean_dist_err"] = report.mean_dist_err
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.experiments.profile")
    ap.add_argument("--scenario", choices=sorted(SCENARIOS), default="paper_fig2")
    args = ap.parse_args(argv)
    result = profile_main_path(args.scenario)
    result["device"] = torch.cuda.get_device_name(0)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
