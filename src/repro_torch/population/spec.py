"""Declarative population descriptions: one frozen spec for who joins,
when, how fast they are, and when they are reachable.

A :class:`PopulationSpec` unifies what used to be three ad-hoc scenario
channels — timed ``ChurnEvent`` schedules, ``HubFailure`` schedules, and
the implicit per-agent speed tuple — into one description of a *fleet
population*:

* :class:`Cohort` — a homogeneous slice of agents: arrival window,
  optional permanent departure, base speed with an optional lognormal
  straggler tail (compute heterogeneity as per-agent step-time
  multipliers), hub preference, and an availability process;
* :class:`Departure` — a timed removal of live agents (the paper's
  deletion ablation: newest joiners retire first);
* :class:`HubOutage` — a timed hub death (the paper's Table 2).

Availability processes come in three kinds, all deterministic functions
of the scenario seed (FLGo-style trace-driven client simulation):

* :class:`Diurnal` — day/night duty cycles with per-agent phase jitter;
* :class:`Sessions` — distribution-driven on/off session lengths;
* :class:`Trace` — replayable explicit windows (inline or loaded from a
  JSONL trace file via :mod:`repro_torch.population.trace`).

Nothing here touches a scheduler: the spec is pure data, compiled onto a
running system by :func:`repro_torch.population.compile.compile_onto`.
"""

from __future__ import annotations

from collections.abc import Sequence
from dataclasses import dataclass, replace

from repro_torch.core.experiment import ChurnEvent, HubFailure

# ---------------------------------------------------------------------------
# availability processes
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Diurnal:
    """Day/night duty cycle: online for the first ``on_fraction`` of
    every ``period``, starting ``phase`` into the cycle at join time.

    ``jitter`` (fraction of a period) adds a per-agent uniform phase
    shift drawn from the population stream, so a cohort's members do not
    all drop at the same instant.
    """

    period: float = 2.0
    on_fraction: float = 0.5
    phase: float = 0.0
    jitter: float = 0.0

    def __post_init__(self):
        if self.period <= 0.0:
            raise ValueError(f"period must be positive: {self.period}")
        if not 0.0 < self.on_fraction <= 1.0:
            raise ValueError(f"on_fraction not in (0, 1]: {self.on_fraction}")
        if self.jitter < 0.0:
            raise ValueError(f"negative jitter: {self.jitter}")


@dataclass(frozen=True)
class Sessions:
    """Alternating online/offline sessions with distribution-driven
    lengths (mean ``mean_on`` / ``mean_off``): ``"exp"`` (memoryless),
    ``"lognormal"`` (heavy-tailed, shape ``sigma``), or ``"fixed"``.
    Agents join online."""

    mean_on: float = 1.0
    mean_off: float = 1.0
    distribution: str = "exp"  # exp | lognormal | fixed
    sigma: float = 1.0

    def __post_init__(self):
        if self.mean_on <= 0.0 or self.mean_off <= 0.0:
            raise ValueError("session means must be positive")
        if self.distribution not in ("exp", "lognormal", "fixed"):
            raise ValueError(f"unknown distribution: {self.distribution!r}")


@dataclass(frozen=True)
class Trace:
    """Replayable availability windows.

    The agent is online during each ``(on, off)`` window (times relative
    to its join), offline between them.  ``stagger`` shifts member ``k``
    of a cohort by ``k * stagger``.  With ``repeat`` the windows tile
    every ``repeat`` time units forever; without it the agent comes back
    online after the last window and stays — a finite trace describes
    the disturbed prefix of a run, and a permanently-offline tail would
    deadlock the round policy.  Load windows from a JSONL trace file
    with :func:`repro_torch.population.trace.load_windows`.
    """

    windows: tuple[tuple[float, float], ...] = ()
    stagger: float = 0.0
    repeat: float | None = None

    def __post_init__(self):
        last = 0.0
        for on, off in self.windows:
            if on < last or off <= on:
                raise ValueError(f"windows not disjoint/increasing: {self.windows}")
            last = off
        if self.repeat is not None and self.repeat < last:
            raise ValueError(f"repeat {self.repeat} shorter than the windows")


Availability = Diurnal | Sessions | Trace


# ---------------------------------------------------------------------------
# population structure
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Cohort:
    """One homogeneous slice of the population.

    Members join uniformly over ``[arrive_at, arrive_at + arrive_spread]``
    (a point in time when the spread is 0), each with speed ``speed``
    scaled by a per-agent lognormal multiplier of shape ``speed_sigma``
    (0 = homogeneous; larger values grow a long tail of stragglers —
    speed divides round duration, so a small multiplier is a slow
    machine).  ``depart_at`` removes every member permanently at that
    time; ``availability`` drives the member's online/offline timeline
    while it lives (None = always on).
    """

    n_agents: int
    name: str = ""
    arrive_at: float = 0.0
    arrive_spread: float = 0.0
    depart_at: float | None = None
    speed: float = 1.0
    speed_sigma: float = 0.0
    hub: int | None = None
    availability: Availability | None = None

    def __post_init__(self):
        if self.n_agents < 1:
            raise ValueError(f"cohort needs n_agents >= 1: {self.n_agents}")
        if self.arrive_at < 0.0 or self.arrive_spread < 0.0:
            raise ValueError("negative arrival window")
        if self.depart_at is not None and self.depart_at <= self.arrive_at:
            raise ValueError("depart_at must be after arrive_at")
        if self.speed <= 0.0 or self.speed_sigma < 0.0:
            raise ValueError("speed must be positive, speed_sigma >= 0")


@dataclass(frozen=True)
class Departure:
    """Timed removal of live agents: ``agent_id`` when given, else the
    ``count`` newest joiners (the paper's deletion-ablation order)."""

    at: float
    count: int = 1
    agent_id: int | None = None

    def __post_init__(self):
        if self.agent_id is not None and self.count != 1:
            raise ValueError("explicit agent_id implies count=1")


@dataclass(frozen=True)
class HubOutage:
    """Timed hub death (the paper's Table 2 as a population event)."""

    at: float
    hub_id: int

    def __post_init__(self):
        if self.hub_id < 0:
            raise ValueError(f"negative hub_id: {self.hub_id}")


@dataclass(frozen=True)
class PopulationSpec:
    """The whole population of a scenario, incumbents included.

    When a :class:`~repro_torch.experiments.spec.ScenarioSpec` carries a
    population, the runner builds the system *empty* and compiles this
    spec onto its scheduler: every agent arrives through a cohort
    (``arrive_at=0`` cohorts are the incumbents).  Same-time events
    apply joins before departures before hub outages — a defined order,
    independent of construction order.
    """

    cohorts: tuple[Cohort, ...] = ()
    departures: tuple[Departure, ...] = ()
    hub_outages: tuple[HubOutage, ...] = ()

    def __post_init__(self):
        if not (self.cohorts or self.departures or self.hub_outages):
            raise ValueError("empty population: no cohorts, departures, or outages")

    @property
    def n_agents(self) -> int:
        """Total agents ever joining (not live at any one time)."""
        return sum(c.n_agents for c in self.cohorts)

    def event_times(self) -> tuple[float, ...]:
        """Sorted distinct times of the discrete membership events
        (cohort arrivals/departures, timed departures, hub outages) —
        what the runner probes evaluation at.  Availability toggles are
        continuous dynamics, not probe points."""
        times = set()
        for c in self.cohorts:
            times.add(c.arrive_at)
            if c.depart_at is not None:
                times.add(c.depart_at)
        times |= {d.at for d in self.departures}
        times |= {o.at for o in self.hub_outages}
        return tuple(sorted(times))

    def scaled(self, frac: float) -> "PopulationSpec":
        """The CI-sized population: every cohort shrunk to
        ``max(1, round(n_agents * frac))`` members, dynamics unchanged."""
        if frac == 1.0:
            return self
        return replace(
            self,
            cohorts=tuple(
                replace(c, n_agents=max(1, round(c.n_agents * frac)))
                for c in self.cohorts
            ),
        )

    @staticmethod
    def from_churn(
        events: Sequence[ChurnEvent] = (),
        hub_failures: Sequence[HubFailure] = (),
    ) -> "PopulationSpec":
        """Lift classic churn/hub-failure schedules into a population —
        the bridge the ``ADFLLSystem.schedule_churn`` /
        ``schedule_hub_failures`` shims ride.  Each ``add`` becomes a
        point-arrival cohort, each ``remove`` a :class:`Departure`, each
        :class:`~repro_torch.core.experiment.HubFailure` a :class:`HubOutage`.
        """
        cohorts, departures = [], []
        for ev in sorted(events, key=lambda e: e.at):
            if ev.action == "add":
                cohorts.append(
                    Cohort(
                        n_agents=ev.count,
                        arrive_at=ev.at,
                        speed=ev.speed,
                        hub=ev.hub,
                    )
                )
            else:
                departures.append(
                    Departure(at=ev.at, count=ev.count, agent_id=ev.agent_id)
                )
        outages = tuple(
            HubOutage(at=f.at, hub_id=f.hub_id)
            for f in sorted(hub_failures, key=lambda f: f.at)
        )
        return PopulationSpec(
            cohorts=tuple(cohorts),
            departures=tuple(departures),
            hub_outages=outages,
        )


__all__ = [
    "Availability",
    "Cohort",
    "Departure",
    "Diurnal",
    "HubOutage",
    "PopulationSpec",
    "Sessions",
    "Trace",
]
