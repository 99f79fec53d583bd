"""ADFLL system orchestration (the paper's deployment experiment).

:class:`ADFLLSystem` runs asynchronous decentralized federated lifelong
learning over a pluggable topology (the paper's hub layout, hub-less
gossip, or both), driven by the event-driven scheduler with
heterogeneous agent speeds, communication dropout, agent churn, hub
failures and population dynamics.  Agents share ERBs,
weight snapshots (FedAsync-style staleness-discounted mixing, optionally
int8 or top-k compressed on the wire), or both.  Link time (latency +
bytes/rate) of every pull/push is charged to simulated time, so message
size shows up in the makespan.  Rounds are submitted to one shared
:class:`~repro_torch.rl.fleet.FleetEngine`, which trains them in batched
flushes on the device (``engine="fleet"``) or after every round
(``engine="fleet-eager"``); ``engine="stepwise"`` gives every agent its
own state and trains each step as its own dispatch (the baseline the
fleet is measured against).  Membership changes through
:meth:`ADFLLSystem.apply_population` (cohort arrivals, availability,
departures, hub outages), with :meth:`ADFLLSystem.schedule_churn` and
:meth:`ADFLLSystem.schedule_hub_failures` as shims over it.

The paper's Table 1 comparison rows are here too: Agent X
(:func:`train_all_knowing`), Agent Y (:func:`train_partial`), Agent M
(:func:`train_sequential_ll`), and the synchronous FedAvg contrast
system (:class:`CentralAggregationSystem`), all on the fleet engine.

Enabled telemetry is observe-only: it brings the fleet observatory
(per-agent learning dynamics from the fleet's stats chunk, version
vectors and propagation latencies, health incidents in
``Report.extra``) and the round, push, availability, churn and hub
spans and counters, and changes no number of the run.  ``fleet_devices``
(and ``devices`` of :class:`CentralAggregationSystem`) resolve through
``models/sharding.py::make_fleet_mesh`` over the devices the system's
``device`` names, as in the reference: on a host with several visible
cards the fleet engine shards its agents across them (slot ``i`` on card
``i % n``); with at most one card, or on the CPU, there is no mesh and
the run is the single-device one.  Reductions across agents (FedAvg's
mean, the weight plane's mixing) bring their operands to one device
first.
"""

from __future__ import annotations

from collections.abc import Sequence
from dataclasses import replace

import numpy as np
import torch

from repro_torch.configs.adfll_dqn import ADFLLConfig, DQNConfig
from repro_torch.core.erb import TaskTag, erb_init
from repro_torch.core.experiment import (
    ChurnEvent,
    EvalPoint,
    ExperimentHooks,
    HistoryRecorder,
    HubFailure,
    Report,
    RoundRecord,
)
from repro_torch.core.gossip import LinkModel, make_sampler
from repro_torch.core.hub import Hub
from repro_torch.core.network import Network
from repro_torch.core.plane import CompressedWeightPlane, WeightPlane, staleness_alphas
from repro_torch.core.scheduler import Scheduler
from repro_torch.device import resolve_device
from repro_torch.observatory import Observatory
from repro_torch.models.sharding import make_fleet_mesh
from repro_torch.population.compile import compile_onto
from repro_torch.population.spec import PopulationSpec
from repro_torch.rl.agent import DQNAgent
from repro_torch.rl.env import LandmarkEnv
from repro_torch.rl.fleet import FleetEngine, collect_fleet, tree_map
from repro_torch.rl.synth import make_volume
from repro_torch.telemetry import NULL, Telemetry


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


def _make_weight_plane(cfg: ADFLLConfig) -> WeightPlane:
    if cfg.weight_compression == "none":
        return WeightPlane(max_versions=cfg.weight_max_versions)
    return CompressedWeightPlane(
        max_versions=cfg.weight_max_versions,
        compression=cfg.weight_compression,
        k_frac=cfg.weight_topk_frac,
    )


class ADFLLSystem:
    """The paper's deployment system (Fig. 2 topology by default).

    ``seed`` is the single source of truth for every random stream
    (defaulting to ``sys_cfg.seed``): the round rng, the network rng,
    the gossip sampler/rng, the task-curriculum rng, and each agent's
    init seed (``seed + agent_id``) all derive from it.  ``device=None``
    trains on the CUDA card.  Enabled ``telemetry`` attaches an
    :class:`~repro_torch.observatory.Observatory` (to the fleet engine
    too, unless the engine is ``stepwise``, whose private per-agent
    engines run without one, as the reference's stepwise agents do).
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
        telemetry: Telemetry | None = None,
        device: str | torch.device | None = None,
    ):
        if sys_cfg.engine not in ("fleet", "fleet-eager", "stepwise"):
            raise ValueError(f"unknown engine: {sys_cfg.engine!r}")
        if sys_cfg.task_curriculum not in ("roundrobin", "blocked", "shuffled"):
            raise ValueError(f"unknown curriculum: {sys_cfg.task_curriculum!r}")
        self.sys_cfg = sys_cfg
        self.dqn_cfg = dqn_cfg
        self.tasks = list(tasks)
        self.train_patients = list(train_patients)
        self.seed = int(sys_cfg.seed if seed is None else seed)
        # observe-only: telemetry never touches a random stream or any
        # run state, so enabled/disabled runs stay bit-identical
        self.telemetry = telemetry if telemetry is not None else NULL
        self._recorder = HistoryRecorder()
        self.hooks: tuple[ExperimentHooks, ...] = (self._recorder, *hooks)
        self.history: list[RoundRecord] = self._recorder.records
        self.rng = np.random.default_rng(self.seed)
        n_hubs = 0 if sys_cfg.topology == "gossip" else sys_cfg.n_hubs
        self.network = Network(
            hubs=[Hub(h) for h in range(n_hubs)],
            dropout=sys_cfg.dropout,
            rng=np.random.default_rng(self.seed + 1),
            topology=sys_cfg.topology,
            link=LinkModel(
                latency=sys_cfg.link_latency,
                rate=sys_cfg.link_rate,
                drop=sys_cfg.link_drop,
            ),
        )
        self.network.meter.bind(self.telemetry.registry)
        if sys_cfg.topology in ("gossip", "hybrid"):
            self.network.enable_gossip(
                make_sampler(
                    sys_cfg.gossip_sampler,
                    fanout=sys_cfg.gossip_fanout,
                    seed=self.seed + 2,
                ),
                rng=np.random.default_rng(self.seed + 3),
            )
            self.network.gossip.telemetry = self.telemetry
        self.device = resolve_device(device)
        mesh = (
            make_fleet_mesh(sys_cfg.fleet_devices, device=self.device)
            if sys_cfg.fleet_devices
            else None
        )
        self.engine: FleetEngine | None = (
            FleetEngine(dqn_cfg, device=self.device, mesh=mesh)
            if sys_cfg.engine.startswith("fleet")
            else None
        )
        if self.engine is not None:
            self.engine.telemetry = self.telemetry
        # the observatory rides the telemetry bundle: enabled telemetry
        # means per-agent learning dynamics, propagation tracking, and
        # health detection — all observe-only, like telemetry itself
        self.observatory: Observatory | None = (
            Observatory(self.telemetry) if self.telemetry.enabled else None
        )
        if self.observatory is not None and self.engine is not None:
            self.engine.observatory = self.observatory
        if self.observatory is not None and self.network.gossip is not None:
            prop = self.observatory.propagation
            self.network.gossip.on_deliver = prop.on_gossip_deliver
        self.use_erb = "erb" in sys_cfg.share_planes
        self.use_weights = "weights" in sys_cfg.share_planes
        if self.use_weights:
            self.network.register_plane(_make_weight_plane(sys_cfg))
        self._task_rng = np.random.default_rng(self.seed + 4)
        self._task_queue: list[int] = []
        self.agents: dict[int, DQNAgent] = {}
        self.sched = Scheduler(telemetry=self.telemetry)
        if self.engine is not None:
            self.engine.sim_clock = lambda: self.sched.now
        self._tel_off_since: dict[int, float] = {}  # open offline windows
        self._task_cursor = 0
        self._next_agent_id = 0
        self._outstanding = 0  # finish events not yet processed
        self._pending_churn = 0  # scheduled churn events not yet applied
        self._pending_failures = 0  # scheduled hub failures not yet applied
        # population dynamics: availability bookkeeping (set lazily by
        # repro_torch.population.compile_onto) and rounds deferred offline
        self.population = None
        self._deferred: set[int] = set()
        # evaluation probes the runner schedules, in the order they fired
        self.probes: list[EvalPoint] = []
        if self.network.gossip is not None:
            # availability view: anti-entropy never samples an offline peer
            self.network.gossip.online = self._agent_is_online
        for i in range(sys_cfg.n_agents):
            hub = sys_cfg.agent_hub[i] if i < len(sys_cfg.agent_hub) else None
            speed = sys_cfg.agent_speed[i] if i < len(sys_cfg.agent_speed) else 1.0
            self.add_agent(speed=speed, hub_id=hub, at=0.0)
        if sys_cfg.topology != "gossip":
            self.sched.every(
                sys_cfg.hub_sync_period,
                lambda s, t: self.network.sync(),
                tag="hub_sync",
            )
        if self.network.gossip is not None:
            self.sched.every(
                sys_cfg.gossip_period,
                lambda s, t: self.network.gossip.anti_entropy(s),
                tag="gossip",
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
        at: float | None = None,
    ) -> int:
        """Add an agent that starts its first round at ``at`` (default:
        now)."""
        aid = self._next_agent_id
        self._next_agent_id += 1
        agent = DQNAgent(
            aid,
            self.dqn_cfg,
            seed=self.seed + aid,
            speed=speed,
            backend="fleet" if self.engine is not None else "stepwise",
            engine=self.engine,
            device=self.device,
        )
        self.agents[aid] = agent
        if self.observatory is not None:
            if self.engine is not None:
                self.observatory.register_slot(agent.slot, aid)
            self.observatory.propagation.note_round(aid, 0)
        self.network.attach_agent(aid, hub_id)
        t = self.sched.now if at is None else at
        if self.population is not None:
            self.population.note_join(aid, t, speed)
        self.sched.at(t, lambda s, tt, a=aid: self._start_round(a), tag=f"A{aid}_join")
        return aid

    def remove_agent(self, agent_id: int):
        """The agent leaves: its in-flight round trains (the record
        stays) but shares nothing, and its slot stays resident, idle."""
        agent = self.agents[agent_id]
        if self.engine is not None:
            # retire the departing agent's in-flight round now so its
            # record lands in the same history position as sequential
            self.engine.ensure_flushed(agent.slot)
        agent.active = False
        self._deferred.discard(agent_id)
        if self.population is not None:
            self.population.note_depart(agent_id, self.sched.now)
        self.network.detach_agent(agent_id)

    def live_agents(self) -> dict[int, DQNAgent]:
        return {aid: a for aid, a in self.agents.items() if a.active}

    # -- availability ---------------------------------------------------------
    def set_online(self, agent_id: int, online: bool) -> None:
        """Flip one agent's availability.  Offline agents keep in-flight
        rounds (disconnection granularity is one round) but start no new
        ones; coming back online resumes a round deferred while away.
        Emits ``on_availability`` on every state *change*."""
        agent = self.agents.get(agent_id)
        if agent is None or not agent.active:
            return
        was = agent.online
        agent.online = online
        if self.population is not None:
            self.population.note_toggle(agent_id, online, self.sched.now)
        if online == was:
            return
        now = self.sched.now
        if self.telemetry.enabled:
            track = f"agent{agent_id}"
            self.telemetry.instant(
                "online" if online else "offline", track, now, agent=agent_id
            )
            self.telemetry.count("availability.toggles", 1, agent=agent_id)
            if online:
                t0 = self._tel_off_since.pop(agent_id, None)
                if t0 is not None:
                    self.telemetry.span("offline", track, t0, now, agent=agent_id)
            else:
                self._tel_off_since[agent_id] = now
        self._emit("on_availability", agent_id, online, now)
        if online and agent_id in self._deferred:
            self._deferred.discard(agent_id)
            self._start_round(agent_id)

    def _agent_is_online(self, agent_id: int) -> bool:
        """The gossip layer's availability view: live *and* online."""
        agent = self.agents.get(agent_id)
        return agent is not None and agent.active and agent.online

    # -- population -----------------------------------------------------------
    def apply_population(self, pop: PopulationSpec) -> None:
        """Compile a :class:`~repro_torch.population.PopulationSpec` onto
        the scheduler: cohort arrivals, availability processes,
        departures, and hub outages all become ordinary events feeding
        the churn machinery."""
        compile_onto(self, pop)

    def schedule_churn(self, events: Sequence[ChurnEvent]) -> None:
        """Classic churn shim: lifts the events into a
        :class:`~repro_torch.population.PopulationSpec` (point-arrival
        cohorts and departures) and compiles it.  Each event fires at its
        time and emits ``on_churn``; the run does not stop while churn
        events are pending, so late joiners get their rounds even if the
        incumbents finished first."""
        if events:
            self.apply_population(PopulationSpec.from_churn(events))

    def _apply_churn(self, ev: ChurnEvent, t: float) -> list[int]:
        self._pending_churn -= 1
        ids: list[int] = []
        if ev.action == "add":
            for _ in range(ev.count):
                ids.append(self.add_agent(speed=ev.speed, hub_id=ev.hub))
        else:
            for _ in range(ev.count):
                aid = ev.agent_id
                live = self.live_agents()
                if aid is None:
                    if not live:
                        break
                    aid = max(live)  # newest joiner leaves first
                elif aid not in live:
                    break  # unknown/already-departed id: nothing to remove
                self.remove_agent(aid)
                ids.append(aid)
        if self.telemetry.enabled and ids:
            self.telemetry.instant(f"churn.{ev.action}", "population", t, agents=ids)
            self.telemetry.count("churn.events", 1, action=ev.action)
        self._emit("on_churn", ev, ids, t)
        return ids

    # -- hub failures -----------------------------------------------------------
    def schedule_hub_failures(self, events: Sequence[HubFailure]) -> None:
        """Classic hub-failure shim (the paper's Table 2): lifts the
        events into hub outages and compiles them.  Bad schedules raise
        before anything touches the scheduler; each outage kills its hub
        at its time and emits ``on_hub_failure``.  The run does not stop
        while failures are pending."""
        if events:
            self.apply_population(PopulationSpec.from_churn(hub_failures=events))

    def _apply_hub_failure(self, ev: HubFailure, t: float) -> None:
        self._pending_failures -= 1
        orphaned = self.network.fail_hub(ev.hub_id)
        if self.telemetry.enabled:
            self.telemetry.instant(
                "hub.failure", "population", t, hub=ev.hub_id, orphaned=orphaned
            )
            self.telemetry.count("hub.failures", 1)
        self._emit("on_hub_failure", ev, orphaned, t)

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
        """Paper policy: a live agent starts a new round whenever rounds
        remain."""
        agent = self.agents[agent_id]
        if not agent.active or agent.rounds_done >= self.sys_cfg.rounds:
            return
        if not agent.online:
            # offline: park the round; set_online(True) resumes it
            self._deferred.add(agent_id)
            if self.telemetry.enabled:
                self.telemetry.instant(
                    "round.deferred", f"agent{agent_id}", self.sched.now
                )
                self.telemetry.count("rounds.deferred", 1)
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
            if self.observatory is not None and incoming:
                self.observatory.propagation.note_erb_consumed(
                    agent_id, incoming, self.sched.now
                )
        else:
            incoming = []
        if self.use_weights:
            n_mixed, mix_comm = self._mix_peer_weights(agent_id)
            comm += mix_comm
            if n_mixed:
                self._emit("on_mix", agent_id, n_mixed, mix_comm, self.sched.now)
        else:
            n_mixed = 0
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
        if self.telemetry.enabled:
            self.telemetry.span(
                "round",
                f"agent{agent_id}",
                start,
                end,
                task=task.name,
                round_idx=round_idx,
                n_incoming=n_incoming,
                n_mixed=n_mixed,
                comm=comm,
            )
            self.telemetry.count("rounds.started", 1)
            self.telemetry.observe("round.duration", dur)
            self.telemetry.observe("round.incoming", n_incoming)
            if n_mixed:
                self.telemetry.count("mix.snapshots", n_mixed)

        def emit_record(loss):
            record = RoundRecord(
                agent_id,
                round_idx,
                task.name,
                start,
                end,
                n_incoming,
                loss,
                n_mixed,
                comm,
            )
            self._emit("on_round_end", record)

        future.on_done(emit_record)

        def finish(s: Scheduler, t: float, aid=agent_id, erb=shared):
            self._outstanding -= 1
            # an agent removed mid-round shares nothing: its untrained round
            # is lost (the paper's failure semantics), and it is no longer
            # attached to any hub or gossip store anyway
            a = self.agents[aid]
            if not a.active:
                return
            obs = self.observatory
            comm_out = 0.0
            if self.use_erb:
                if obs is not None:
                    # stamp BrainTorrent-style provenance (observe-only:
                    # the default empty vector is never read numerically)
                    erb.meta = replace(
                        erb.meta, version_vector=obs.propagation.version_vector()
                    )
                    obs.propagation.note_erb_push(aid, erb, t)
                res = self.network.agent_push(aid, erb)
                comm_out += res.comm_time
                self._emit("on_push", aid, "erb", res, t)
                if self.telemetry.enabled and res.comm_time > 0.0:
                    self.telemetry.span("push.erb", f"agent{aid}", t, t + res.comm_time)
            if self.use_weights:
                snap = a.snapshot_params(t)
                if obs is not None:
                    snap = replace(snap, version_vector=obs.propagation.version_vector())
                    obs.propagation.note_snapshot_push(aid, snap, t)
                res = self.network.agent_push(aid, snap, plane="weights")
                comm_out += res.comm_time
                self._emit("on_push", aid, "weights", res, t)
                if self.telemetry.enabled and res.comm_time > 0.0:
                    self.telemetry.span(
                        "push.weights", f"agent{aid}", t, t + res.comm_time
                    )
            if comm_out > 0.0:
                # the upload occupies the agent's link before its next round
                s.at(
                    t + comm_out,
                    lambda s2, t2, a2=aid: self._start_round(a2),
                    tag=f"A{aid}_push_done",
                )
            else:
                self._start_round(aid)

        self._outstanding += 1
        self.sched.at(end, finish, tag=f"A{agent_id}_round_done")

    def _mix_peer_weights(self, agent_id: int) -> tuple[int, float]:
        """Pull unseen peer snapshots and fold them into the agent's
        params, staleness-discounted (FedAsync alpha*s(dtau)); compressed
        snapshots are dequantized inside the mix.  Returns the number of
        snapshots consumed and the pull's link time."""
        agent = self.agents[agent_id]
        res = self.network.agent_pull(agent_id, agent.seen_snap_ids, plane="weights")
        snaps = list(res.records)
        if not snaps:
            return 0, res.comm_time
        cfg = self.sys_cfg
        now = self.sched.now if cfg.staleness_clock == "time" else agent.rounds_done
        alphas = staleness_alphas(
            snaps,
            now,
            alpha=cfg.mix_alpha,
            flag=cfg.staleness_flag,
            hinge_a=cfg.staleness_hinge_a,
            hinge_b=cfg.staleness_hinge_b,
            poly_a=cfg.staleness_poly_a,
            clock=cfg.staleness_clock,
        )
        if self.observatory is not None:
            self.observatory.propagation.note_mix(
                agent_id, snaps, alphas, now, cfg.staleness_clock
            )
        return agent.mix_params(snaps, alphas), res.comm_time

    # -- run ------------------------------------------------------------------
    def run(self, until: float = 1e6) -> Report:
        def done() -> bool:
            return (
                self._outstanding == 0
                and self._pending_churn == 0
                and self._pending_failures == 0
                and all(
                    a.rounds_done >= self.sys_cfg.rounds
                    for a in self.live_agents().values()
                )
            )

        t = self.sched.run(until=until, stop=done)
        if self.engine is not None:
            self.engine.flush()  # retire in-flight rounds before reporting
        self.network.sync()
        return self.report(makespan=t)

    def report(self, *, makespan: float) -> Report:
        """Assemble the run-side :class:`Report` (evaluation fields are
        filled by the runner via :meth:`evaluate`)."""
        hist = list(self.history)
        meter = self.network.meter
        extra = {}
        if self.network.gossip is not None:
            st = self.network.gossip.stats
            extra["gossip"] = {
                "rounds": st.n_rounds,
                "exchanges": st.n_exchanges,
                "sent": st.n_sent,
                "delivered": st.n_delivered,
                "dropped": st.n_dropped,
            }
        if self.population is not None:
            extra["population"] = self.population.summary(float(makespan))
        if self.telemetry.enabled:
            extra["telemetry"] = self.telemetry.summary()
        if self.observatory is not None:
            extra.update(self.observatory.report_extra(makespan=float(makespan)))
        return Report(
            system="adfll",
            seed=self.seed,
            makespan=float(makespan),
            n_rounds=len(hist),
            comm_time=float(sum(r.comm_time for r in hist)),
            history=hist,
            n_mixed=sum(r.n_mixed for r in hist),
            n_foreign_erbs=sum(r.n_incoming for r in hist),
            bytes_by_plane=dict(meter.bytes_by_plane),
            msgs_by_plane=dict(meter.msgs_by_plane),
            plane_pushed=dict(self.network.plane_pushed),
            records_known={
                p: len(self.network.all_known(p)) for p in sorted(self.network.planes)
            },
            extra=extra,
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
        """Per-live-agent mean terminal distance per task (labels follow
        the paper's 1-based numbering: agent 0 is ``"Agent1"``)."""
        return {
            f"Agent{aid + 1}": evaluate_on_tasks(
                agent,
                tasks,
                patients,
                self.dqn_cfg,
                max_patients=max_patients,
                n_episodes=n_episodes,
            )
            for aid, agent in sorted(self.live_agents().items())
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
    The cohort shares one fleet engine on ``device`` (``None`` = CUDA),
    sharded over ``make_fleet_mesh(devices)`` where that is a mesh.
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
        self.dqn_cfg = dqn_cfg
        self.tasks = list(tasks)
        self.patients = list(patients)
        self.rounds = rounds
        self.steps = steps
        self.erb_capacity = erb_capacity
        self.seed = seed
        mesh = make_fleet_mesh(devices, device=device) if devices else None
        # one stacked cohort
        self.engine = FleetEngine(dqn_cfg, device=device, mesh=mesh)
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
        # every agent's params are read before any are written, and meet
        # on the engine's first device (a mesh holds them on several)
        home = self.engine.device
        mean_params = tree_map(
            lambda *xs: sum(x.to(home) for x in xs) / len(xs),
            *[a.params for a in agents],
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
