"""Build and execute scenarios: ``run(spec) -> Report``.

The runner resolves the named spec, mirrors ``spec.seed`` into the
system config (one seed, every stream derived), builds the
:class:`~repro_torch.core.federated.ADFLLSystem` on ``device`` (``None``
= the CUDA card) over the paper's eight task-environments, runs it, and
folds the final evaluation into the
:class:`~repro_torch.core.experiment.Report`.
"""

from __future__ import annotations

from collections.abc import Sequence
from dataclasses import replace

import numpy as np
import torch

from repro_torch.core.experiment import EvalPoint, ExperimentHooks, Report
from repro_torch.core.federated import ADFLLSystem
from repro_torch.experiments.registry import get_scenario
from repro_torch.experiments.spec import ScenarioSpec
from repro_torch.rl.synth import paper_eight_tasks, patient_split

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


def build(
    spec: SpecLike,
    *,
    fast: bool = False,
    seed: int | None = None,
    hooks: Sequence[ExperimentHooks] = (),
    device: str | torch.device | None = None,
) -> ADFLLSystem:
    """Construct (but do not run) the system a scenario describes."""
    spec = resolve(spec, fast=fast, seed=seed)
    train_p, _ = patient_split(spec.n_patients)
    sys_cfg = replace(spec.sys, seed=spec.seed)  # one seed, every stream
    return ADFLLSystem(
        sys_cfg, spec.dqn, paper_eight_tasks(), train_p, hooks=hooks, device=device
    )


def evaluate_into(report: Report, system: ADFLLSystem, spec: ScenarioSpec) -> Report:
    """Fill the report's evaluation fields from ``system.evaluate``."""
    tasks = list(paper_eight_tasks())
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
