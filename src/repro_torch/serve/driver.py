"""Train-while-serve session driver.

One reusable loop under ``launch.serve --fleet`` and the
``serve_localization`` scenario: build a fleet, publish its params,
then alternate serving traffic waves with training rounds — each round
ends in a ``publish()`` the service hot-swaps in before the next wave,
so every session exercises the continuous-batching and hot-swap paths
together.  Every training round is one fleet flush: each of its stacked
train steps launches the ``replay_gather`` and ``fused_td`` kernels once.
"""

from __future__ import annotations

from collections.abc import Sequence
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.configs.adfll_dqn import DQNConfig
from repro_torch.core.federated import env_for
from repro_torch.models.sharding import make_fleet_mesh
from repro_torch.rl.agent import DQNAgent
from repro_torch.rl.fleet import FleetEngine, collect_fleet
from repro_torch.rl.synth import paper_eight_tasks, patient_split
from repro_torch.serve.publisher import ParamPublisher
from repro_torch.serve.report import ServeReport
from repro_torch.observatory import Observatory
from repro_torch.serve.service import LocalizationService
from repro_torch.serve.traffic import TrafficSpec, synthetic_requests
from repro_torch.telemetry import Telemetry


@dataclass
class ServeSession:
    """A live fleet + publisher + service triple."""

    cfg: DQNConfig
    engine: FleetEngine
    agents: list[DQNAgent]
    publisher: ParamPublisher
    service: LocalizationService
    tasks: list
    patients: list

    def train_round(self, round_idx: int, train_steps: int) -> None:
        """One lifelong round per agent (personal replay, no federation
        — the serving session exercises the inference plane, not the
        sharing planes); callers publish.

        The cohort collects through one stacked greedy-rollout forward a
        step (:func:`repro_torch.rl.fleet.collect_fleet`) and trains as
        one batched flush, every rng draw in its agent's own stream
        order."""
        agents = self.agents
        tasks = [
            self.tasks[(round_idx + a.agent_id) % len(self.tasks)] for a in agents
        ]
        envs = [
            env_for(t, int(a.rng.choice(self.patients)), self.cfg)
            for a, t in zip(agents, tasks, strict=True)
        ]
        erbs = [
            a.new_round_erb(t, 512) for a, t in zip(agents, tasks, strict=True)
        ]
        collect_fleet(agents, envs, erbs, n_episodes=24)
        for agent, env, task, erb in zip(agents, envs, tasks, erbs, strict=True):
            agent.begin_round(
                env,
                task,
                incoming=(),
                erb_capacity=512,
                share_size=0,
                train_steps=train_steps,
                current=erb,
            )
        self.engine.flush()

    def publish(self) -> None:
        self.publisher.publish()


def build_session(
    cfg: DQNConfig,
    *,
    n_agents: int,
    traffic: TrafficSpec,
    seed: int = 0,
    tasks: Sequence | None = None,
    patients: Sequence[int] | None = None,
    warmup: bool = True,
    telemetry: Telemetry | None = None,
    devices: int = 0,
    device: str | torch.device | None = None,
) -> ServeSession:
    """Fleet + publisher + service on ``device`` (``None`` = the CUDA
    card), params published once (version 0).  ``devices`` > 0 (or -1 =
    all) shards the fleet axis across the cards ``device`` names
    (:func:`repro_torch.models.sharding.make_fleet_mesh`; none with at
    most one card); the service then serves each published snapshot from
    the mesh's first card.  Enabled ``telemetry`` reaches the fleet and
    the service and brings the observatory, as in ``ADFLLSystem``
    (observe-only: the same results request by request)."""
    mesh = make_fleet_mesh(devices, device=device) if devices else None
    engine = FleetEngine(cfg, device=device, mesh=mesh)
    if telemetry is not None:
        engine.telemetry = telemetry
    agents = [
        DQNAgent(i, cfg, seed=seed + i, engine=engine) for i in range(n_agents)
    ]
    if telemetry is not None and telemetry.enabled:
        obs = Observatory(telemetry)
        engine.observatory = obs
        for i, a in enumerate(agents):
            obs.register_slot(a.slot, i)
    task_list = list(tasks if tasks is not None else paper_eight_tasks())
    if patients is None:
        patients, _ = patient_split(16)
    publisher = ParamPublisher(engine)
    publisher.publish()
    service = LocalizationService(
        cfg,
        publisher=publisher,
        max_batch=traffic.max_batch,
        n_version_slots=traffic.n_version_slots,
        max_staleness=traffic.max_staleness,
        warmup=warmup,
        telemetry=telemetry,
        device=engine.device,
    )
    return ServeSession(
        cfg=cfg,
        engine=engine,
        agents=agents,
        publisher=publisher,
        service=service,
        tasks=task_list,
        patients=list(patients),
    )


def run_session(
    session: ServeSession,
    traffic: TrafficSpec,
    *,
    n_waves: int = 2,
    train_steps: int = 20,
    train_rounds_per_wave: int = 1,
) -> ServeReport:
    """Alternate traffic waves with train+publish rounds.

    Wave 0 serves on version 0; each later wave is preceded by
    ``train_rounds_per_wave`` fleet rounds and one publish, so waves
    1..n serve hot-swapped versions 1..n — train-while-serve in one
    thread (interleaving at wave granularity is the deterministic
    equivalent of concurrency).
    """
    requests = synthetic_requests(
        traffic, session.cfg, n_agents=len(session.agents), tasks=session.tasks
    )
    waves = np.array_split(np.arange(len(requests)), max(1, n_waves))
    round_idx = 0
    for w, idx in enumerate(waves):
        if w > 0:
            for _ in range(train_rounds_per_wave):
                session.train_round(round_idx, train_steps)
                round_idx += 1
            session.publish()
        session.service.serve([requests[i] for i in idx], rate=traffic.rate)
    return session.service.report


__all__ = ["ServeSession", "build_session", "run_session"]
