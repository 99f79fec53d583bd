"""Build and execute scenarios: ``run(spec) -> Report``.

The runner is the only place a system is ever constructed from a
scenario: it resolves the named spec, mirrors ``spec.seed`` into the
system config (one seed, every stream derived), builds the system the
spec names on ``device`` (``None`` = the CUDA card) — the ADFLL
deployment, synchronous FedAvg, one of the Table 1 baseline agents or
the train-while-serve serving plane —
wires churn schedules, hub failures, populations and evaluation probes
into the ADFLL system, runs it, and folds the probes and the final
evaluation into the :class:`~repro_torch.core.experiment.Report`.
Enabled telemetry reaches the ADFLL and serving systems (FedAvg and
the single-agent baselines run without it, as in the reference); a
trace and a dashboard of it are written on request.
"""

from __future__ import annotations

import json
from collections.abc import Sequence
from dataclasses import replace

import numpy as np
import torch

from repro_torch.core.experiment import EvalPoint, ExperimentHooks, Report
from repro_torch.core.federated import ADFLLSystem, CentralAggregationSystem
from repro_torch.experiments.protocol import System
from repro_torch.experiments.registry import get_scenario
from repro_torch.experiments.spec import ScenarioSpec
from repro_torch.experiments.systems import BaselineSystem, ServeSystem
from repro_torch.rl.synth import all_tasks, paper_eight_tasks, patient_split
from repro_torch.telemetry import Telemetry, write_dashboard, write_trace

SpecLike = str | ScenarioSpec


def resolve(
    spec: SpecLike, *, fast: bool = False, seed: int | None = None
) -> ScenarioSpec:
    """Name -> registered spec, plus the seed/fast variants."""
    if isinstance(spec, str):
        spec = get_scenario(spec)
    if seed is not None:
        spec = spec.with_seed(seed)
    if fast:
        spec = spec.fast()
    return spec


def _tasks_for(spec: ScenarioSpec) -> list:
    tasks = list(paper_eight_tasks() if spec.task_set == "paper8" else all_tasks())
    if spec.n_tasks is not None:
        tasks = tasks[: spec.n_tasks]
    return tasks


def _eval_tasks_for(spec: ScenarioSpec) -> list:
    tasks = _tasks_for(spec)
    return tasks if spec.eval_tasks is None else tasks[: spec.eval_tasks]


def _eval_point(system: System, spec: ScenarioSpec, t: float) -> EvalPoint:
    _, test_p = patient_split(spec.n_patients)
    errors = system.evaluate(
        _eval_tasks_for(spec),
        test_p,
        max_patients=spec.eval_patients,
        n_episodes=spec.eval_episodes,
    )
    per_agent = {
        label: float(np.mean(list(errs.values()))) for label, errs in errors.items()
    }
    mean = float(np.mean(list(per_agent.values()))) if per_agent else float("nan")
    return EvalPoint(t=t, n_agents=len(per_agent), mean_err=mean, per_agent=per_agent)


def _schedule_probes(system: ADFLLSystem, spec: ScenarioSpec) -> None:
    """Evaluation probes at each churn/hub-failure/population event time
    (before the event applies: scheduler ties break by insertion order,
    and these are registered first), collected in ``system.probes``."""
    if not spec.eval_at_churn:
        return

    def probe(sched, t: float) -> None:
        point = _eval_point(system, spec, t)
        system.probes.append(point)
        system._emit("on_eval", point)

    times = {ev.at for ev in spec.churn} | {ev.at for ev in spec.hub_failures}
    if spec.population is not None:
        # probe at each membership event; t=0 is just the incumbents
        # arriving — there is nothing to evaluate before them
        times |= {t for t in spec.population.event_times() if t > 0.0}
    for at in sorted(times):
        system.sched.at(at, probe, tag="eval_probe")


def build(
    spec: SpecLike,
    *,
    fast: bool = False,
    seed: int | None = None,
    hooks: Sequence[ExperimentHooks] = (),
    device: str | torch.device | None = None,
    telemetry: Telemetry | None = None,
) -> System:
    """Construct (but do not run) the system a scenario describes."""
    spec = resolve(spec, fast=fast, seed=seed)
    tasks = _tasks_for(spec)
    train_p, _ = patient_split(spec.n_patients)
    sys_cfg = replace(spec.sys, seed=spec.seed)  # one seed, every stream
    if spec.system != "adfll" and (
        spec.churn or spec.agent_sites or spec.hub_failures
    ):
        raise ValueError(
            f"{spec.name}: {spec.system} supports no churn/sites/hub failures"
        )
    if spec.system == "adfll":
        if spec.population is not None:
            # every agent arrives through a cohort (arrive_at=0 cohorts
            # are the incumbents): the system starts empty
            sys_cfg = replace(sys_cfg, n_agents=0, agent_hub=(), agent_speed=())
        system = ADFLLSystem(
            sys_cfg,
            spec.dqn,
            tasks,
            train_p,
            hooks=hooks,
            telemetry=telemetry,
            device=device,
        )
        if spec.agent_sites:
            system.network.configure_sites(
                dict(enumerate(spec.agent_sites)),
                hub_site=dict(enumerate(spec.hub_sites)),
                intra=spec.intra_link,
                inter=spec.inter_link,
            )
        if spec.churn or spec.hub_failures or spec.population is not None:
            _schedule_probes(system, spec)
        system.schedule_churn(spec.churn)
        system.schedule_hub_failures(spec.hub_failures)
        if spec.population is not None:
            system.apply_population(spec.population)
        return system
    if spec.system == "fedavg":
        return CentralAggregationSystem(
            sys_cfg.n_agents,
            spec.dqn,
            tasks,
            train_p,
            rounds=sys_cfg.rounds,
            steps=sys_cfg.train_steps_per_round,
            erb_capacity=sys_cfg.erb_capacity,
            seed=spec.seed,
            device=device,
        )
    if spec.system == "serve":
        return ServeSystem(
            spec.dqn,
            tasks,
            train_p,
            traffic=spec.serve_traffic,
            n_agents=sys_cfg.n_agents,
            n_waves=max(2, sys_cfg.rounds),  # >= one hot swap per session
            train_steps=sys_cfg.train_steps_per_round,
            seed=spec.seed,
            device=device,
            telemetry=telemetry,
        )
    return BaselineSystem(  # the single-agent Table 1 baselines
        spec.system,
        spec.dqn,
        tasks,
        train_p,
        steps=sys_cfg.train_steps_per_round,
        erb_capacity=sys_cfg.erb_capacity,
        seed=spec.seed,
        device=device,
    )


def evaluate_into(report: Report, system: System, spec: ScenarioSpec) -> Report:
    """Fill the report's evaluation fields from ``system.evaluate``: the
    final point, after the probes that fired during the run."""
    _, test_p = patient_split(spec.n_patients)
    report.scenario = spec.name
    report.seed = spec.seed
    report.task_errors = system.evaluate(
        _eval_tasks_for(spec),
        test_p,
        max_patients=spec.eval_patients,
        n_episodes=spec.eval_episodes,
    )
    means = report.agent_means()
    vals = list(means.values())  # empty if churn removed every agent
    report.mean_dist_err = float(np.mean(vals)) if vals else float("nan")
    report.best_agent_err = float(np.min(vals)) if vals else float("nan")
    report.eval_patients = spec.eval_patients
    report.eval_episodes = spec.eval_episodes
    final = EvalPoint(
        t=report.makespan,
        n_agents=len(means),
        mean_err=report.mean_dist_err,
        per_agent=means,
    )
    probes = system.probes if isinstance(system, ADFLLSystem) else []
    report.eval_curve = [*probes, final]
    return report


def run(
    spec: SpecLike,
    *,
    fast: bool = False,
    seed: int | None = None,
    hooks: Sequence[ExperimentHooks] = (),
    device: str | torch.device | None = None,
    json_path: str | None = None,
    trace_path: str | None = None,
    dashboard_path: str | None = None,
    telemetry: Telemetry | None = None,
) -> Report:
    """Execute one scenario end to end and return its :class:`Report`.

    ``json_path`` writes the report as :func:`write_json` does.
    ``trace_path`` captures the run's telemetry (Perfetto JSON, or JSONL
    when the suffix is ``.jsonl``) and ``dashboard_path`` renders it
    (with the observatory's learning, propagation and health series)
    into a self-contained HTML page; either one turns telemetry on, as
    does an enabled ``telemetry`` bundle.  Telemetry is observe-only:
    with or without it the run's numbers are bit-identical.
    """
    rspec = resolve(spec, fast=fast, seed=seed)
    if telemetry is None and (trace_path is not None or dashboard_path is not None):
        telemetry = Telemetry(enabled=True)
    system = build(rspec, hooks=hooks, device=device, telemetry=telemetry)
    report = evaluate_into(system.run(), system, rspec)
    if trace_path is not None and telemetry is not None:
        # after the evaluation: serving scenarios keep emitting through it
        write_trace(telemetry, trace_path)
    if dashboard_path is not None and telemetry is not None:
        trace = {
            "events": list(telemetry.tracer.events),
            "metrics": telemetry.registry.summary(),
        }
        write_dashboard(
            dashboard_path, trace, title=f"Fleet observatory — {rspec.name}"
        )
    if json_path:
        write_json(json_path, [report], fast=fast)
    return report


def write_json(path: str, reports: Sequence[Report], *, fast: bool = False) -> None:
    """One ``BENCH_*.json`` in the shape ``benchmarks/check_regression.py``
    gates on (the reference's payload, key for key)."""
    payload = {
        "benchmark": "experiments",
        "fast": bool(fast),
        "configs": {r.scenario: r.summary() for r in reports},
    }
    with open(path, "w") as f:
        json.dump(payload, f, indent=2, sort_keys=True)


__all__ = ["build", "evaluate_into", "resolve", "run", "write_json"]
