"""ADFLL system orchestration (the paper's deployment experiment).

:class:`ADFLLSystem` runs asynchronous decentralized federated lifelong
learning over the paper's hub topology, driven by the event-driven
scheduler with heterogeneous agent speeds and communication dropout.
Link time (latency + bytes/rate) of every pull/push is charged to
simulated time.  Rounds are submitted to one shared
:class:`~repro_torch.rl.fleet.FleetEngine`, which trains them in batched
flushes on the device (``engine="fleet"``) or after every round
(``engine="fleet-eager"``).

The paper's Table 1 comparison rows are here too: Agent X
(:func:`train_all_knowing`), Agent Y (:func:`train_partial`), Agent M
(:func:`train_sequential_ll`), and the synchronous FedAvg contrast
system (:class:`CentralAggregationSystem`), all on the fleet engine.

What this slice of the port leaves out raises ``NotImplementedError``
naming the slice that brings it: gossip/hybrid topologies and the
weight plane, multi-device fleet sharding, telemetry and the
observatory, population dynamics and churn, and the legacy stepwise
engine.
"""

from __future__ import annotations

from collections.abc import Sequence

import numpy as np
import torch

from repro_torch.configs.adfll_dqn import ADFLLConfig, DQNConfig
from repro_torch.core.erb import TaskTag, erb_init
from repro_torch.core.experiment import (
    ExperimentHooks,
    HistoryRecorder,
    Report,
    RoundRecord,
)
from repro_torch.core.gossip import LinkModel
from repro_torch.core.hub import Hub
from repro_torch.core.network import Network
from repro_torch.core.scheduler import Scheduler
from repro_torch.rl.agent import DQNAgent
from repro_torch.rl.env import LandmarkEnv
from repro_torch.rl.fleet import FleetEngine, collect_fleet, tree_map
from repro_torch.rl.synth import make_volume


def env_for(task: TaskTag, patient: int, cfg: DQNConfig) -> LandmarkEnv:
    vol, lm = make_volume(task, patient, n=cfg.volume_shape[0])
    return LandmarkEnv(vol, lm, cfg)


def evaluate_on_tasks(
    agent: DQNAgent,
    tasks: Sequence[TaskTag],
    patients: Sequence[int],
    cfg: DQNConfig,
    *,
    max_patients: int | None = 4,
    n_episodes: int = 4,
) -> dict[str, float]:
    """Mean terminal distance per task over the held-out patients
    (``max_patients`` of them, None = all; ``n_episodes`` greedy
    rollouts each)."""
    pats = list(patients) if max_patients is None else list(patients)[:max_patients]
    out = {}
    for t in tasks:
        errs = [agent.evaluate(env_for(t, p, cfg), n_episodes=n_episodes) for p in pats]
        out[t.name] = float(np.mean(errs))
    return out


_POPULATION = "churn, hub failures and populations come with a later slice of the port"


def _unsupported(sys_cfg: ADFLLConfig) -> str | None:
    """What of ``sys_cfg`` this slice cannot run, or None."""
    if sys_cfg.topology != "hub":
        return f"topology={sys_cfg.topology!r} (the gossip transport slice)"
    if "weights" in sys_cfg.share_planes:
        return "the weight plane (the weight-plane slice)"
    if sys_cfg.fleet_devices != 0:
        return "fleet_devices != 0 (the multi-GPU fleet-sharding slice)"
    if sys_cfg.engine == "stepwise":
        return "engine='stepwise' (the stepwise-backend slice)"
    return None


class ADFLLSystem:
    """The paper's deployment system (Fig. 2 topology by default).

    ``seed`` is the single source of truth for every random stream
    (defaulting to ``sys_cfg.seed``): the round rng, the network rng and
    each agent's init seed (``seed + agent_id``) all derive from it.
    ``device=None`` runs the fleet on the CUDA card.
    """

    def __init__(
        self,
        sys_cfg: ADFLLConfig,
        dqn_cfg: DQNConfig,
        tasks: Sequence[TaskTag],
        train_patients: Sequence[int],
        *,
        seed: int | None = None,
        hooks: Sequence[ExperimentHooks] = (),
        telemetry=None,
        device: str | torch.device | None = None,
    ):
        missing = _unsupported(sys_cfg)
        if missing is None and telemetry is not None and telemetry.enabled:
            missing = "enabled telemetry (the observatory/telemetry slice)"
        if missing is not None:
            raise NotImplementedError(f"repro_torch does not run {missing} yet")
        if sys_cfg.engine not in ("fleet", "fleet-eager"):
            raise ValueError(f"unknown engine: {sys_cfg.engine!r}")
        if sys_cfg.task_curriculum not in ("roundrobin", "blocked", "shuffled"):
            raise ValueError(f"unknown curriculum: {sys_cfg.task_curriculum!r}")
        self.sys_cfg = sys_cfg
        self.dqn_cfg = dqn_cfg
        self.tasks = list(tasks)
        self.train_patients = list(train_patients)
        self.seed = int(sys_cfg.seed if seed is None else seed)
        self._recorder = HistoryRecorder()
        self.hooks: tuple[ExperimentHooks, ...] = (self._recorder, *hooks)
        self.history: list[RoundRecord] = self._recorder.records
        self.rng = np.random.default_rng(self.seed)
        self.network = Network(
            hubs=[Hub(h) for h in range(sys_cfg.n_hubs)],
            dropout=sys_cfg.dropout,
            rng=np.random.default_rng(self.seed + 1),
            link=LinkModel(
                latency=sys_cfg.link_latency,
                rate=sys_cfg.link_rate,
                drop=sys_cfg.link_drop,
            ),
        )
        self.engine = FleetEngine(dqn_cfg, device=device)
        self.device = self.engine.device
        self.use_erb = "erb" in sys_cfg.share_planes
        self._task_rng = np.random.default_rng(self.seed + 4)
        self._task_queue: list[int] = []
        self.agents: dict[int, DQNAgent] = {}
        self.sched = Scheduler()
        self._task_cursor = 0
        self._next_agent_id = 0
        self._outstanding = 0  # finish events not yet processed
        for i in range(sys_cfg.n_agents):
            hub = sys_cfg.agent_hub[i] if i < len(sys_cfg.agent_hub) else None
            speed = sys_cfg.agent_speed[i] if i < len(sys_cfg.agent_speed) else 1.0
            self.add_agent(speed=speed, hub_id=hub)
        self.sched.every(
            sys_cfg.hub_sync_period, lambda s, t: self.network.sync(), tag="hub_sync"
        )

    # -- hooks ----------------------------------------------------------------
    def _emit(self, name: str, *args) -> None:
        for h in self.hooks:
            getattr(h, name)(self, *args)

    # -- membership -----------------------------------------------------------
    def add_agent(
        self,
        *,
        speed: float = 1.0,
        hub_id: int | None = None,
    ) -> int:
        """Add an agent that starts its first round now."""
        aid = self._next_agent_id
        self._next_agent_id += 1
        agent = DQNAgent(
            aid, self.dqn_cfg, seed=self.seed + aid, speed=speed, engine=self.engine
        )
        self.agents[aid] = agent
        self.network.attach_agent(aid, hub_id)
        self.sched.at(
            self.sched.now, lambda s, t, a=aid: self._start_round(a), tag=f"A{aid}_join"
        )
        return aid

    def remove_agent(self, agent_id: int):
        raise NotImplementedError(_POPULATION)

    def apply_population(self, pop) -> None:
        raise NotImplementedError(_POPULATION)

    def schedule_churn(self, events) -> None:
        raise NotImplementedError(_POPULATION)

    def schedule_hub_failures(self, events) -> None:
        raise NotImplementedError(_POPULATION)

    # -- round machinery --------------------------------------------------------
    def _next_task(self) -> TaskTag:
        """Round-robin (the paper), blocked (one task per cohort of agents
        before moving on), or a seeded shuffle of each full pass."""
        cur = self.sys_cfg.task_curriculum
        if cur == "roundrobin":
            idx = self._task_cursor % len(self.tasks)
        elif cur == "blocked":
            block = max(1, self.sys_cfg.n_agents)
            idx = (self._task_cursor // block) % len(self.tasks)
        else:  # shuffled
            if not self._task_queue:
                self._task_queue = list(self._task_rng.permutation(len(self.tasks)))
            idx = int(self._task_queue.pop())
        self._task_cursor += 1
        return self.tasks[idx]

    def _round_duration(self, agent: DQNAgent, n_incoming: int) -> float:
        """Simulated wall time of one round: base cost grows with replay
        volume; divided by hardware speed."""
        base = 1.0 + 0.1 * n_incoming
        jitter = float(self.rng.uniform(0.9, 1.1))
        return base * jitter / agent.speed

    def _start_round(self, agent_id: int):
        agent = self.agents.get(agent_id)
        if agent is None or agent.rounds_done >= self.sys_cfg.rounds:
            return
        task = self._next_task()
        self._emit("on_round_start", agent_id, task, self.sched.now)
        patient = int(self.rng.choice(self.train_patients))
        env = env_for(task, patient, self.dqn_cfg)
        comm = 0.0
        if self.use_erb:
            pulled = self.network.agent_pull(agent_id, agent.seen_erb_ids)
            incoming = list(pulled.records)
            comm += pulled.comm_time
        else:
            incoming = []
        start = self.sched.now
        shared, future = agent.begin_round(
            env,
            task,
            incoming,
            erb_capacity=self.sys_cfg.erb_capacity,
            share_size=self.sys_cfg.erb_share_size,
            train_steps=self.sys_cfg.train_steps_per_round,
        )
        if self.sys_cfg.engine == "fleet-eager":
            self.engine.flush()
        dur = self._round_duration(agent, len(incoming)) + comm
        end = start + dur
        # the round record is complete except for the loss, which the
        # fleet engine produces at flush time; futures resolve in
        # submission order, so history order matches sequential driving
        round_idx = agent.rounds_done - 1
        n_incoming = len(incoming)

        def emit_record(loss):
            record = RoundRecord(
                agent_id, round_idx, task.name, start, end, n_incoming, loss, 0, comm
            )
            self._emit("on_round_end", record)

        future.on_done(emit_record)

        def finish(s: Scheduler, t: float, aid=agent_id, erb=shared):
            self._outstanding -= 1
            comm_out = 0.0
            if self.use_erb:
                res = self.network.agent_push(aid, erb)
                comm_out += res.comm_time
                self._emit("on_push", aid, "erb", res, t)
            if comm_out > 0.0:
                # the upload occupies the agent's link before its next round
                s.at(
                    t + comm_out,
                    lambda s2, t2, a2=aid: self._maybe_continue(a2),
                    tag=f"A{aid}_push_done",
                )
            else:
                self._maybe_continue(aid)

        self._outstanding += 1
        self.sched.at(end, finish, tag=f"A{agent_id}_round_done")

    def _maybe_continue(self, agent_id: int):
        """Paper policy: start a new round whenever rounds remain."""
        agent = self.agents.get(agent_id)
        if agent is None or agent.rounds_done >= self.sys_cfg.rounds:
            return
        self._start_round(agent_id)

    # -- run ------------------------------------------------------------------
    def run(self, until: float = 1e6) -> Report:
        def done() -> bool:
            return self._outstanding == 0 and all(
                a.rounds_done >= self.sys_cfg.rounds for a in self.agents.values()
            )

        t = self.sched.run(until=until, stop=done)
        self.engine.flush()  # retire in-flight rounds before reporting
        self.network.sync()
        return self.report(makespan=t)

    def report(self, *, makespan: float) -> Report:
        """Assemble the run-side :class:`Report` (evaluation fields are
        filled by the runner via :meth:`evaluate`)."""
        hist = list(self.history)
        meter = self.network.meter
        return Report(
            system="adfll",
            seed=self.seed,
            makespan=float(makespan),
            n_rounds=len(hist),
            comm_time=float(sum(r.comm_time for r in hist)),
            history=hist,
            n_mixed=0,
            n_foreign_erbs=sum(r.n_incoming for r in hist),
            bytes_by_plane=dict(meter.bytes_by_plane),
            msgs_by_plane=dict(meter.msgs_by_plane),
            plane_pushed=dict(self.network.plane_pushed),
            records_known={
                p: len(self.network.all_known(p)) for p in sorted(self.network.planes)
            },
        )

    # -- evaluation -----------------------------------------------------------
    def evaluate(
        self,
        tasks: Sequence[TaskTag],
        patients: Sequence[int],
        *,
        max_patients: int | None = 4,
        n_episodes: int = 4,
    ) -> dict[str, dict[str, float]]:
        """Per-agent mean terminal distance per task (labels follow the
        paper's 1-based numbering: agent 0 is ``"Agent1"``)."""
        return {
            f"Agent{aid + 1}": evaluate_on_tasks(
                agent,
                tasks,
                patients,
                self.dqn_cfg,
                max_patients=max_patients,
                n_episodes=n_episodes,
            )
            for aid, agent in sorted(self.agents.items())
        }


# ---------------------------------------------------------------------------
# Baselines
# ---------------------------------------------------------------------------
def train_all_knowing(
    dqn_cfg: DQNConfig,
    tasks: Sequence[TaskTag],
    patients: Sequence[int],
    *,
    steps_per_task: int = 150,
    erb_capacity: int = 2048,
    seed: int = 100,
    device: str | torch.device | None = None,
) -> DQNAgent:
    """Agent X: all datasets available at once, ONE round over the union."""
    agent = DQNAgent(-1, dqn_cfg, seed=seed, device=device)
    rng = np.random.default_rng(seed)
    erbs = []
    for t in tasks:
        env = env_for(t, int(rng.choice(patients)), dqn_cfg)
        erb = erb_init(erb_capacity, dqn_cfg.box_size, task=t)
        agent.collect(env, erb, n_episodes=24)
        erbs.append(erb)
    # one round of training over the union (current pool = all ERBs)
    agent.personal_erbs = erbs
    agent.train_steps(steps_per_task * len(tasks), None, ())
    return agent


def train_partial(
    dqn_cfg: DQNConfig,
    task: TaskTag,
    patients: Sequence[int],
    *,
    steps: int = 150,
    erb_capacity: int = 2048,
    seed: int = 200,
    device: str | torch.device | None = None,
) -> DQNAgent:
    """Agent Y: a single dataset, a single round."""
    agent = DQNAgent(-2, dqn_cfg, seed=seed, device=device)
    rng = np.random.default_rng(seed)
    env = env_for(task, int(rng.choice(patients)), dqn_cfg)
    erb = erb_init(erb_capacity, dqn_cfg.box_size, task=task)
    agent.collect(env, erb, n_episodes=24)
    agent.train_steps(steps, erb, ())
    return agent


def train_sequential_ll(
    dqn_cfg: DQNConfig,
    tasks: Sequence[TaskTag],
    patients: Sequence[int],
    *,
    steps_per_round: int = 150,
    erb_capacity: int = 2048,
    seed: int = 300,
    device: str | torch.device | None = None,
) -> DQNAgent:
    """Agent M: traditional lifelong learner — tasks arrive sequentially,
    replay over personal past ERBs only (no federation)."""
    agent = DQNAgent(-3, dqn_cfg, seed=seed, device=device)
    rng = np.random.default_rng(seed)
    for t in tasks:
        env = env_for(t, int(rng.choice(patients)), dqn_cfg)
        agent.train_round(
            env,
            t,
            incoming=(),
            erb_capacity=erb_capacity,
            share_size=1,  # nothing is shared
            train_steps=steps_per_round,
        )
    return agent


class CentralAggregationSystem:
    """Conventional synchronous FedAvg over DQN weights: all agents train
    locally for a round, a central server averages, repeat.  The contrast
    system ADFLL is measured against (it requires homogeneous
    architectures and a central node — both restrictions ADFLL removes).

    Implements the ``System`` protocol: ``run()`` executes ``rounds``
    synchronous rounds and returns a :class:`Report`; ``evaluate()``
    reports the shared post-aggregation model under the ``"FedAvg"``
    label (after a sync round every agent holds identical parameters).
    The cohort shares one fleet engine on ``device`` (``None`` = CUDA).
    """

    def __init__(
        self,
        n_agents: int,
        dqn_cfg: DQNConfig,
        tasks: Sequence[TaskTag],
        patients: Sequence[int],
        *,
        rounds: int = 3,
        steps: int = 150,
        erb_capacity: int = 2048,
        seed: int = 400,
        devices: int = 0,
        device: str | torch.device | None = None,
    ):
        if devices != 0:
            raise NotImplementedError(
                "repro_torch does not run devices != 0 (the multi-GPU "
                "fleet-sharding slice) yet"
            )
        self.dqn_cfg = dqn_cfg
        self.tasks = list(tasks)
        self.patients = list(patients)
        self.rounds = rounds
        self.steps = steps
        self.erb_capacity = erb_capacity
        self.seed = seed
        self.engine = FleetEngine(dqn_cfg, device=device)  # one stacked cohort
        self.agents = [
            DQNAgent(i, dqn_cfg, seed=seed + i, engine=self.engine)
            for i in range(n_agents)
        ]
        self.rng = np.random.default_rng(seed)

    def round(
        self,
        round_idx: int,
        *,
        steps: int | None = None,
        erb_capacity: int | None = None,
    ):
        steps = self.steps if steps is None else steps
        erb_capacity = self.erb_capacity if erb_capacity is None else erb_capacity
        agents = self.agents
        tasks = [
            self.tasks[(round_idx * len(agents) + i) % len(self.tasks)]
            for i in range(len(agents))
        ]
        # the cohort's patient draws come off self.rng before collection,
        # which draws from per-agent streams
        envs = [
            env_for(t, int(self.rng.choice(self.patients)), self.dqn_cfg)
            for t in tasks
        ]
        erbs = [
            erb_init(
                erb_capacity,
                self.dqn_cfg.box_size,
                task=t,
                source_agent=i,
                round_idx=round_idx,
            )
            for i, t in enumerate(tasks)
        ]
        # one stacked greedy-act forward per env step collects for the
        # whole cohort, and submit-only training makes the round one
        # batched flush, forced by the params read during aggregation
        collect_fleet(agents, envs, erbs, n_episodes=24)
        for agent, erb in zip(agents, erbs, strict=True):
            agent._submit_steps(steps, erb, ())
            agent.personal_erbs.append(erb)
        # synchronous central aggregation (the bottleneck ADFLL removes):
        # every agent's params are read before any are written
        mean_params = tree_map(
            lambda *xs: sum(xs) / len(xs), *[a.params for a in agents]
        )
        for a in agents:
            a.params = mean_params
            a.target_params = mean_params

    def run(self) -> Report:
        for r in range(self.rounds):
            self.round(r)
        return Report(
            system="fedavg",
            seed=self.seed,
            n_rounds=self.rounds * len(self.agents),
        )

    def evaluate(
        self,
        tasks: Sequence[TaskTag],
        patients: Sequence[int],
        *,
        max_patients: int | None = 4,
        n_episodes: int = 4,
    ) -> dict[str, dict[str, float]]:
        return {
            "FedAvg": evaluate_on_tasks(
                self.agents[0],
                tasks,
                patients,
                self.dqn_cfg,
                max_patients=max_patients,
                n_episodes=n_episodes,
            )
        }


__all__ = [
    "ADFLLSystem",
    "CentralAggregationSystem",
    "RoundRecord",
    "env_for",
    "evaluate_on_tasks",
    "train_all_knowing",
    "train_partial",
    "train_sequential_ll",
]
