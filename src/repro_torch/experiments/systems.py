"""Baseline trainers wrapped as single-agent ``System`` implementations.

The paper's Table 1 comparison rows — Agent X (all-knowing), Agent Y
(partially-knowing), Agent M (sequential lifelong) — are plain training
functions in :mod:`repro_torch.core.federated`.  :class:`BaselineSystem`
lifts each into the :class:`~repro_torch.experiments.protocol.System`
protocol so the runner drives them exactly like ``ADFLLSystem`` and
``CentralAggregationSystem``.  The serving plane's system comes with
the serving slice of the port.
"""

from __future__ import annotations

from collections.abc import Sequence

import torch

from repro_torch.configs.adfll_dqn import DQNConfig
from repro_torch.core.erb import TaskTag
from repro_torch.core.experiment import Report
from repro_torch.core.federated import (
    evaluate_on_tasks,
    train_all_knowing,
    train_partial,
    train_sequential_ll,
)

_LABELS = {
    "all_knowing": "AgentX",
    "partial": "AgentY",
    "sequential": "AgentM",
}


class BaselineSystem:
    """Agent X / Y / M as a single-agent system.

    ``kind`` selects the trainer; ``steps`` is the per-task (X), total
    (Y), or per-round (M) step budget — all three consume the scenario's
    ``train_steps_per_round``.  The agent trains on ``device`` (``None``
    = CUDA).
    """

    def __init__(
        self,
        kind: str,
        dqn_cfg: DQNConfig,
        tasks: Sequence[TaskTag],
        patients: Sequence[int],
        *,
        steps: int = 150,
        erb_capacity: int = 2048,
        seed: int = 0,
        device: str | torch.device | None = None,
    ):
        if kind not in _LABELS:
            raise ValueError(f"unknown baseline kind: {kind!r}")
        self.kind = kind
        self.label = _LABELS[kind]
        self.dqn_cfg = dqn_cfg
        self.tasks = list(tasks)
        self.patients = list(patients)
        self.steps = steps
        self.erb_capacity = erb_capacity
        self.seed = seed
        self.device = device
        self.agent = None

    def run(self) -> Report:
        kw = dict(erb_capacity=self.erb_capacity, seed=self.seed, device=self.device)
        if self.kind == "all_knowing":
            self.agent = train_all_knowing(
                self.dqn_cfg, self.tasks, self.patients, steps_per_task=self.steps, **kw
            )
            n_rounds = 1
        elif self.kind == "partial":
            self.agent = train_partial(
                self.dqn_cfg, self.tasks[0], self.patients, steps=self.steps, **kw
            )
            n_rounds = 1
        else:
            self.agent = train_sequential_ll(
                self.dqn_cfg,
                self.tasks,
                self.patients,
                steps_per_round=self.steps,
                **kw,
            )
            n_rounds = len(self.tasks)
        return Report(system=self.kind, seed=self.seed, n_rounds=n_rounds)

    def evaluate(
        self,
        tasks: Sequence[TaskTag],
        patients: Sequence[int],
        *,
        max_patients: int | None = 4,
        n_episodes: int = 4,
    ) -> dict[str, dict[str, float]]:
        if self.agent is None:
            raise RuntimeError("evaluate() before run(): the agent is untrained")
        return {
            self.label: evaluate_on_tasks(
                self.agent,
                tasks,
                patients,
                self.dqn_cfg,
                max_patients=max_patients,
                n_episodes=n_episodes,
            )
        }


__all__ = ["BaselineSystem"]
