"""Baseline trainers wrapped as single-agent ``System`` implementations.

The paper's Table 1 comparison rows — Agent X (all-knowing), Agent Y
(partially-knowing), Agent M (sequential lifelong) — are plain training
functions in :mod:`repro_torch.core.federated`.  :class:`BaselineSystem`
lifts each into the :class:`~repro_torch.experiments.protocol.System`
protocol so the runner drives them exactly like ``ADFLLSystem`` and
``CentralAggregationSystem``.

:class:`ServeSystem` does the same for the online inference plane
(:mod:`repro_torch.serve`): its ``run()`` is a train-while-serve session
over synthetic traffic, and its ``evaluate()`` answers queries *through
the continuous-batching service* instead of a local rollout loop — so
the scenario gates the serving path itself.
"""

from __future__ import annotations

from collections.abc import Sequence

import numpy as np
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
from repro_torch.rl.synth import make_volume
from repro_torch.serve.driver import build_session, run_session
from repro_torch.serve.queue import ServeRequest
from repro_torch.serve.traffic import TrafficSpec
from repro_torch.telemetry import Telemetry

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


class ServeSystem:
    """The online inference plane as a scenario system.

    ``run()`` builds a fleet + publisher + service session on ``device``
    (``None`` = CUDA) and drives traffic waves interleaved with
    train+publish rounds (every session exercises a hot swap); the
    serve-side metrics land in ``Report.extra["serve"]``.  ``evaluate()``
    routes held-out queries through the *same* continuous-batching
    service, so the scenario's ``mean_dist_err`` measures served
    accuracy, not offline rollouts.  Enabled ``telemetry`` reaches the
    session (its fleet, observatory and service) and its digest lands in
    ``Report.extra["telemetry"]``.
    """

    label = "Serve"

    def __init__(
        self,
        dqn_cfg: DQNConfig,
        tasks: Sequence[TaskTag],
        patients: Sequence[int],
        *,
        traffic: TrafficSpec | None = None,
        n_agents: int = 2,
        n_waves: int = 2,
        train_steps: int = 20,
        seed: int = 0,
        device: str | torch.device | None = None,
        telemetry: Telemetry | None = None,
    ):
        self.dqn_cfg = dqn_cfg
        self.tasks = list(tasks)
        self.patients = list(patients)
        self.traffic = traffic if traffic is not None else TrafficSpec()
        self.n_agents = n_agents
        self.n_waves = n_waves
        self.train_steps = train_steps
        self.seed = seed
        self.device = device
        self.telemetry = telemetry
        self.session = None

    def run(self) -> Report:
        self.session = build_session(
            self.dqn_cfg,
            n_agents=self.n_agents,
            traffic=self.traffic,
            seed=self.seed,
            tasks=self.tasks,
            patients=self.patients,
            device=self.device,
            telemetry=self.telemetry,
        )
        serve_report = run_session(
            self.session,
            self.traffic,
            n_waves=self.n_waves,
            train_steps=self.train_steps,
        )
        report = Report(
            system="serve",
            seed=self.seed,
            n_rounds=(self.n_waves - 1) * self.n_agents,
        )
        # snapshot now: evaluate() keeps serving through the same
        # service, which would otherwise mutate these counters
        report.extra["serve"] = serve_report.summary()
        if self.telemetry is not None and self.telemetry.enabled:
            report.extra["telemetry"] = self.telemetry.summary()
        return report

    def evaluate(
        self,
        tasks: Sequence[TaskTag],
        patients: Sequence[int],
        *,
        max_patients: int | None = 4,
        n_episodes: int = 4,
    ) -> dict[str, dict[str, float]]:
        if self.session is None:
            raise RuntimeError("evaluate() before run(): no live service")
        service = self.session.service
        n = self.dqn_cfg.volume_shape[0]
        rng = np.random.default_rng(self.seed + 1)
        lo, hi = n // 4, 3 * n // 4
        errs: dict[str, float] = {}
        for task in tasks:
            pats = list(patients)[: max_patients or None]
            requests = []
            for patient in pats:
                vol, lm = make_volume(task, patient, n=n)
                for _ in range(n_episodes):
                    requests.append(
                        ServeRequest(
                            volume=vol,
                            start=rng.integers(lo, hi, size=3).astype(np.int32),
                            agent_id=int(rng.integers(0, self.n_agents)),
                            landmark=lm,
                        )
                    )
            ids = [service.submit(r) for r in requests]
            service.drain()
            errs[task.name] = float(
                np.mean([service.results[i].dist_err for i in ids])
            )
        return {self.label: errs}


__all__ = ["BaselineSystem", "ServeSystem"]
