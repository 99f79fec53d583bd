"""Compile a :class:`~repro_torch.population.spec.PopulationSpec` onto a
running system's scheduler.

Everything an agent population does — cohort arrivals, timed departures,
hub outages, availability toggles — becomes ordinary scheduler events
feeding the system's existing churn machinery (``_apply_churn`` /
``_apply_hub_failure``), so the ``done()`` accounting, lifecycle hooks,
and CI-gated churn behavior are shared, not reimplemented.  Simple
point-arrival cohorts (no spread, no straggler tail, no availability)
compile to the *same single grouped event* the classic
``schedule_churn`` emitted, which is what keeps the shim bit-identical.

The system is duck-typed (``sched`` / ``seed`` / ``sys_cfg`` /
``network`` / ``set_online`` / ``_apply_churn`` / ``_apply_hub_failure``
/ ``_pending_churn`` / ``_pending_failures``): this module must not
import :mod:`repro_torch.core.federated`, which imports it back.

Every per-member random draw comes from
``np.random.default_rng((seed, _POP_STREAM, cohort_idx, member_idx))`` —
a pure function of the spec position and the ctor seed, disjoint from
the system's ``seed + k`` streams, so availability timelines are
bit-reproducible across processes.
"""

from __future__ import annotations

import hashlib

import numpy as np

from repro_torch.core.experiment import ChurnEvent, HubFailure
from repro_torch.population.processes import AvailabilityProcess, availability_segments
from repro_torch.population.spec import Cohort, PopulationSpec

_POP_STREAM = 0x706F70  # "pop": keyed into the per-member rng spawn


class PopulationState:
    """Availability bookkeeping for one run: who joined when, who is
    online now, and the accumulated online time per agent.

    The system notifies it through ``note_join`` / ``note_toggle`` /
    ``note_depart`` (pure observers — they never touch the scheduler),
    gossip reads ``is_online`` through the system's availability view,
    and :meth:`summary` folds everything into the report's
    ``extra["population"]`` block, including a digest of the full
    timeline for bit-identity checks.
    """

    def __init__(self):
        self.joined: dict[int, float] = {}
        self.departed: dict[int, float] = {}
        self.speed: dict[int, float] = {}
        self.online_since: dict[int, float] = {}  # present iff online
        self.online_time: dict[int, float] = {}
        self.n_toggles = 0
        self.events: list[tuple[float, int, str]] = []
        self._processes: dict[int, AvailabilityProcess] = {}

    # -- observers wired into the system ------------------------------------
    def note_join(self, agent_id: int, t: float, speed: float) -> None:
        self.joined[agent_id] = t
        self.speed[agent_id] = speed
        self.online_since[agent_id] = t
        self.events.append((t, agent_id, "join"))

    def note_toggle(self, agent_id: int, online: bool, t: float) -> None:
        if agent_id not in self.joined or agent_id in self.departed:
            return
        if online == (agent_id in self.online_since):
            return  # idempotent: only state *changes* are events
        if online:
            self.online_since[agent_id] = t
        else:
            since = self.online_since.pop(agent_id)
            self.online_time[agent_id] = self.online_time.get(agent_id, 0.0) + (
                t - since
            )
        self.n_toggles += 1
        self.events.append((t, agent_id, "on" if online else "off"))

    def note_depart(self, agent_id: int, t: float) -> None:
        if agent_id in self.departed:
            return
        self.departed[agent_id] = t
        since = self.online_since.pop(agent_id, None)
        if since is not None:
            self.online_time[agent_id] = self.online_time.get(agent_id, 0.0) + (
                t - since
            )
        self.events.append((t, agent_id, "depart"))
        proc = self._processes.pop(agent_id, None)
        if proc is not None:
            proc.stop()

    def register_process(self, agent_id: int, proc: AvailabilityProcess) -> None:
        self._processes[agent_id] = proc

    # -- queries -------------------------------------------------------------
    def is_online(self, agent_id: int) -> bool:
        return agent_id in self.online_since

    def timeline_digest(self) -> str:
        """Stable digest of the full (time, agent, kind) event timeline;
        ``repr`` keeps float bits exact, so equal digests mean
        bit-identical availability histories."""
        text = "\n".join(f"{t!r} {aid} {kind}" for t, aid, kind in self.events)
        return hashlib.sha256(text.encode()).hexdigest()[:16]

    def summary(self, makespan: float) -> dict[str, object]:
        online = dict(self.online_time)
        for aid, since in self.online_since.items():
            online[aid] = online.get(aid, 0.0) + max(0.0, makespan - since)
        agent_time = sum(
            self.departed.get(aid, makespan) - t0 for aid, t0 in self.joined.items()
        )
        total_online = sum(online.values())
        step_times = [1.0 / s for s in self.speed.values()]
        return {
            "n_agents": len(self.joined),
            "n_departed": len(self.departed),
            "n_toggles": self.n_toggles,
            "agent_time": round(agent_time, 9),
            "online_time": round(total_online, 9),
            "availability": (
                round(total_online / agent_time, 9) if agent_time > 0 else 1.0
            ),
            "mean_step_time": (
                round(float(np.mean(step_times)), 9) if step_times else 1.0
            ),
            "timeline_digest": self.timeline_digest(),
        }


def _is_simple(c: Cohort) -> bool:
    """A cohort the classic churn path could have expressed: one grouped
    join event, no per-member randomness, no availability, no departure."""
    return (
        c.arrive_spread == 0.0
        and c.speed_sigma == 0.0
        and c.availability is None
        and c.depart_at is None
    )


def member_rng(seed: int, cohort_idx: int, member_idx: int) -> np.random.Generator:
    """The per-member stream: arrival offset, speed multiplier, and the
    availability process all draw from it, in that order."""
    return np.random.default_rng((seed, _POP_STREAM, cohort_idx, member_idx))


def compile_onto(system, pop: PopulationSpec) -> PopulationState:
    """Schedule every population event onto ``system.sched``.

    Same-time ordering is defined: joins, then departures, then hub
    outages (scheduling order + the scheduler's insertion-order ties).
    Hub outages are validated up front — bad specs raise before anything
    is scheduled, matching the classic ``schedule_hub_failures``
    contract.  Idempotent across calls on the shared state: the churn
    and hub-failure shims may each compile their own partial spec.
    """
    state = getattr(system, "population", None)
    if state is None:
        state = PopulationState()
        system.population = state
    sched = system.sched

    if pop.hub_outages:
        if system.sys_cfg.topology == "gossip":
            raise ValueError("topology='gossip' has no hubs to fail")
        for o in pop.hub_outages:
            if o.hub_id >= len(system.network.hubs):
                raise ValueError(
                    f"hub_id {o.hub_id} out of range "
                    f"(n_hubs={len(system.network.hubs)})"
                )

    for ci, c in enumerate(pop.cohorts):
        if _is_simple(c):
            # classic grouped join: value-equal ChurnEvent, same tag, same
            # pending accounting — bit-identical to old schedule_churn
            ev = ChurnEvent(
                at=c.arrive_at, action="add", count=c.n_agents, speed=c.speed, hub=c.hub
            )
            system._pending_churn += 1
            sched.at(ev.at, lambda s, t, e=ev: system._apply_churn(e, t), tag="churn")
            continue
        for mi in range(c.n_agents):
            rng = member_rng(system.seed, ci, mi)
            u = float(rng.uniform())
            z = float(rng.standard_normal())
            arrival = c.arrive_at + c.arrive_spread * u
            speed = c.speed * (
                float(np.exp(c.speed_sigma * z)) if c.speed_sigma else 1.0
            )
            ev = ChurnEvent(at=arrival, action="add", count=1, speed=speed, hub=c.hub)
            system._pending_churn += 1

            def join(s, t, e=ev, cohort=c, r=rng, m=mi):
                ids = system._apply_churn(e, t)
                for aid in ids:
                    if cohort.availability is not None:
                        proc = AvailabilityProcess(
                            s,
                            aid,
                            availability_segments(cohort.availability, r, m),
                            system.set_online,
                        )
                        state.register_process(aid, proc)
                        proc.start()
                    if cohort.depart_at is not None:
                        dep = ChurnEvent(
                            at=cohort.depart_at, action="remove", count=1, agent_id=aid
                        )
                        system._pending_churn += 1
                        s.at(
                            dep.at,
                            lambda s2, t2, e2=dep: system._apply_churn(e2, t2),
                            tag="churn",
                        )

            sched.at(arrival, join, tag="churn")

    for d in pop.departures:
        ev = ChurnEvent(at=d.at, action="remove", count=d.count, agent_id=d.agent_id)
        system._pending_churn += 1
        sched.at(ev.at, lambda s, t, e=ev: system._apply_churn(e, t), tag="churn")

    for o in pop.hub_outages:
        ev = HubFailure(at=o.at, hub_id=o.hub_id)
        system._pending_failures += 1
        sched.at(
            ev.at, lambda s, t, e=ev: system._apply_hub_failure(e, t), tag="hub_fail"
        )

    return state


__all__ = ["PopulationState", "compile_onto", "member_rng"]
