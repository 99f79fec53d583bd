"""Build and execute scenarios: ``run(spec) -> Report``.

The runner is the only place a system is ever constructed from a
scenario: it resolves the named spec, mirrors ``spec.seed`` into the
system config (one seed, every stream derived), builds the system the
spec names on ``device`` (``None`` = the CUDA card) — the ADFLL
deployment, synchronous FedAvg, or one of the Table 1 baseline agents —
runs it, and folds the final evaluation into the
:class:`~repro_torch.core.experiment.Report`.
"""

from __future__ import annotations

from collections.abc import Sequence
from dataclasses import replace

import numpy as np
import torch

from repro_torch.core.experiment import EvalPoint, ExperimentHooks, Report
from repro_torch.core.federated import ADFLLSystem, CentralAggregationSystem
from repro_torch.experiments.protocol import System
from repro_torch.experiments.registry import get_scenario
from repro_torch.experiments.spec import ScenarioSpec
from repro_torch.experiments.systems import BaselineSystem
from repro_torch.rl.synth import all_tasks, paper_eight_tasks, patient_split

SpecLike = str | ScenarioSpec

# the reference's scenario dynamics; the port's spec gains these fields
# with the churn and site-link slices, and a spec that carries them is
# refused rather than run without them
_DYNAMICS = ("churn", "agent_sites", "hub_failures")


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


def build(
    spec: SpecLike,
    *,
    fast: bool = False,
    seed: int | None = None,
    hooks: Sequence[ExperimentHooks] = (),
    device: str | torch.device | None = None,
) -> System:
    """Construct (but do not run) the system a scenario describes."""
    spec = resolve(spec, fast=fast, seed=seed)
    tasks = _tasks_for(spec)
    train_p, _ = patient_split(spec.n_patients)
    sys_cfg = replace(spec.sys, seed=spec.seed)  # one seed, every stream
    dynamics = [f for f in _DYNAMICS if getattr(spec, f, ())]
    if dynamics and spec.system == "adfll":
        raise NotImplementedError(
            f"{spec.name}: repro_torch does not run {'/'.join(dynamics)} yet "
            "(the churn and site-link slices)"
        )
    if dynamics:
        raise ValueError(
            f"{spec.name}: {spec.system} supports no churn/sites/hub failures"
        )
    if spec.system == "adfll":
        return ADFLLSystem(
            sys_cfg, spec.dqn, tasks, train_p, hooks=hooks, device=device
        )
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
        raise NotImplementedError(
            f"{spec.name}: repro_torch does not run system='serve' yet "
            "(the serving-plane slice)"
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
    """Fill the report's evaluation fields from ``system.evaluate``."""
    tasks = _tasks_for(spec)
    eval_tasks = tasks if spec.eval_tasks is None else tasks[: spec.eval_tasks]
    _, test_p = patient_split(spec.n_patients)
    report.scenario = spec.name
    report.seed = spec.seed
    report.task_errors = system.evaluate(
        eval_tasks,
        test_p,
        max_patients=spec.eval_patients,
        n_episodes=spec.eval_episodes,
    )
    means = report.agent_means()
    vals = list(means.values())
    report.mean_dist_err = float(np.mean(vals)) if vals else float("nan")
    report.best_agent_err = float(np.min(vals)) if vals else float("nan")
    report.eval_patients = spec.eval_patients
    report.eval_episodes = spec.eval_episodes
    report.eval_curve = [
        EvalPoint(
            t=report.makespan,
            n_agents=len(means),
            mean_err=report.mean_dist_err,
            per_agent=means,
        )
    ]
    return report


def run(
    spec: SpecLike,
    *,
    fast: bool = False,
    seed: int | None = None,
    hooks: Sequence[ExperimentHooks] = (),
    device: str | torch.device | None = None,
) -> Report:
    """Execute one scenario end to end and return its :class:`Report`."""
    rspec = resolve(spec, fast=fast, seed=seed)
    system = build(rspec, hooks=hooks, device=device)
    return evaluate_into(system.run(), system, rspec)


__all__ = ["build", "evaluate_into", "resolve", "run"]
