"""Experiment-facing primitives shared by the system and the runner.

The artifacts a run produces (:class:`Report`, :class:`RoundRecord`,
:class:`EvalPoint`), the declarative membership events
(:class:`ChurnEvent`, :class:`HubFailure`) and the lifecycle hook
protocol (:class:`ExperimentHooks`) that
:class:`~repro_torch.core.federated.ADFLLSystem` emits into.  It imports
nothing from the rest of ``repro_torch``, so the system and
``repro_torch.experiments`` can both import it without cycles.  The
default :class:`HistoryRecorder` collects the ``system.history`` list of
round records; :class:`CommLog` is an optional bandwidth log.
"""

from __future__ import annotations

from collections.abc import Sequence
from dataclasses import dataclass, field
from typing import Any


@dataclass
class RoundRecord:
    """One completed ADFLL round (what ``system.history`` collects)."""

    agent_id: int
    round_idx: int
    task: str
    start: float
    end: float
    n_incoming: int
    loss: float
    n_mixed: int = 0  # peer weight snapshots folded in (weight plane)
    comm_time: float = 0.0  # link time charged to this round (pull side)


@dataclass
class EvalPoint:
    """One evaluation probe: mean error over the live agents at time t."""

    t: float
    n_agents: int
    mean_err: float
    per_agent: dict[str, float] = field(default_factory=dict)


@dataclass(frozen=True)
class ChurnEvent:
    """One timed membership change in a scenario's churn schedule.

    ``action="add"`` joins ``count`` fresh agents (``speed``/``hub``
    apply to each); ``action="remove"`` detaches ``agent_id`` — or, when
    ``agent_id`` is None, the ``count`` newest live agents (matching the
    paper's deletion ablation, which retires the most recent joiners).
    """

    at: float
    action: str  # "add" | "remove"
    count: int = 1
    agent_id: int | None = None
    speed: float = 1.0
    hub: int | None = None

    def __post_init__(self):
        if self.action not in ("add", "remove"):
            raise ValueError(f"unknown churn action: {self.action!r}")
        if self.agent_id is not None and self.count != 1:
            raise ValueError("explicit agent_id implies count=1")


@dataclass(frozen=True)
class HubFailure:
    """One timed hub failure in a scenario's failure schedule.

    At simulated time ``at`` hub ``hub_id`` dies, losing every record no
    other hub holds; its agents re-home to surviving hubs (if any) or
    fall back to the gossip overlay under ``topology="hybrid"`` (the
    paper's Table 2 robustness experiment).
    """

    at: float
    hub_id: int

    def __post_init__(self):
        if self.hub_id < 0:
            raise ValueError(f"negative hub_id: {self.hub_id}")


@dataclass
class Report:
    """What ``ADFLLSystem.run()`` returns: one experiment's full outcome.

    The run-side fields (makespan, history, transport counters) are
    filled by the system itself; the evaluation fields (``task_errors``,
    ``mean_dist_err``, ``eval_curve``) are filled by the runner after it
    calls ``ADFLLSystem.evaluate``.  ``task_errors`` maps an agent label
    (``"Agent1"``, ...) to per-task mean terminal distance errors.  The
    fields mirror the reference's ``Report`` so reports compare field by
    field.
    """

    scenario: str = ""
    system: str = ""
    seed: int = 0
    # -- run ---------------------------------------------------------------
    makespan: float = 0.0
    n_rounds: int = 0
    comm_time: float = 0.0
    history: list[RoundRecord] = field(default_factory=list)
    n_mixed: int = 0
    n_foreign_erbs: int = 0
    # -- transport ---------------------------------------------------------
    bytes_by_plane: dict[str, int] = field(default_factory=dict)
    msgs_by_plane: dict[str, int] = field(default_factory=dict)
    plane_pushed: dict[str, int] = field(default_factory=dict)
    records_known: dict[str, int] = field(default_factory=dict)
    # -- evaluation --------------------------------------------------------
    task_errors: dict[str, dict[str, float]] = field(default_factory=dict)
    mean_dist_err: float = float("nan")
    best_agent_err: float = float("nan")
    eval_curve: list[EvalPoint] = field(default_factory=list)
    eval_patients: int | None = None
    eval_episodes: int = 0
    extra: dict[str, Any] = field(default_factory=dict)

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_plane.values())

    def agent_means(self) -> dict[str, float]:
        """Per-agent mean error across the evaluated tasks."""
        return {
            label: float(sum(errs.values()) / len(errs))
            for label, errs in self.task_errors.items()
            if errs
        }

    def summary(self) -> dict[str, Any]:
        """Flat JSON-able metrics (what a sweep stores per cell)."""
        out = {
            "system": self.system,
            "seed": self.seed,
            "mean_dist_err": self.mean_dist_err,
            "best_agent_err": self.best_agent_err,
            # None (not 0.0) for systems with no simulated clock
            "sim_makespan": self.makespan or None,
            "comm_time": self.comm_time,
            "n_rounds": self.n_rounds,
            "n_mixed": self.n_mixed,
            "n_foreign_erbs": self.n_foreign_erbs,
            "pushed": dict(self.plane_pushed),
            "bytes_by_plane": dict(self.bytes_by_plane),
            "msgs_by_plane": dict(self.msgs_by_plane),
            "total_bytes": self.total_bytes,
            "eval_patients": self.eval_patients,
            "eval_episodes": self.eval_episodes,
            "eval_curve": [
                {"t": p.t, "n_agents": p.n_agents, "mean_err": p.mean_err}
                for p in self.eval_curve
            ],
        }
        if self.extra:
            out["extra"] = dict(self.extra)
        return out


class ExperimentHooks:
    """Lifecycle callbacks a system emits; every method is a no-op.

    ``system`` is the emitting system object; hooks must not consume any
    of its random streams (determinism across hook configurations is a
    tested invariant).
    """

    def on_round_start(self, system, agent_id: int, task, t: float) -> None:
        """An agent begins a round on ``task`` at simulated time ``t``."""

    def on_mix(
        self, system, agent_id: int, n_mixed: int, comm_time: float, t: float
    ) -> None:
        """An agent folded ``n_mixed`` peer weight snapshots into its
        params at round start (weight plane only)."""

    def on_push(self, system, agent_id: int, plane: str, result, t: float) -> None:
        """A record left the agent on ``plane`` (``result`` is a
        :class:`~repro_torch.core.network.PushResult`)."""

    def on_round_end(self, system, record: RoundRecord) -> None:
        """A round's training completed (training is eager; ``record``
        carries the projected simulated ``start``/``end``).  The round's
        pushes fire later, at ``record.end`` on the simulated clock —
        and never fire at all if the agent is removed while the round is
        in flight, though the record remains (the paper's failure
        semantics: the work happened, its shares were lost)."""

    def on_eval(self, system, point: EvalPoint) -> None:
        """An evaluation probe fired."""

    def on_churn(
        self, system, event: ChurnEvent, agent_ids: Sequence[int], t: float
    ) -> None:
        """A churn event was applied to ``agent_ids``."""

    def on_hub_failure(
        self, system, event: HubFailure, orphaned: Sequence[int], t: float
    ) -> None:
        """A hub died; ``orphaned`` are the agents it stranded (they are
        re-homed to surviving hubs when any exist)."""

    def on_availability(self, system, agent_id: int, online: bool, t: float) -> None:
        """An agent's availability changed (population dynamics): offline
        agents finish in-flight rounds but start no new ones and are
        never sampled by gossip."""


class HistoryRecorder(ExperimentHooks):
    """The default metrics hook: collects :class:`RoundRecord` objects
    (what used to be an inline ``self.history.append``)."""

    def __init__(self):
        self.records: list[RoundRecord] = []

    def on_round_end(self, system, record: RoundRecord) -> None:
        self.records.append(record)


class CommLog(ExperimentHooks):
    """Optional bandwidth-accounting hook: one row per push, with the
    link time and bytes the transport charged for it."""

    def __init__(self):
        self.rows: list[dict[str, Any]] = []

    def on_push(self, system, agent_id: int, plane: str, result, t: float) -> None:
        self.rows.append(
            {
                "t": t,
                "agent_id": agent_id,
                "plane": plane,
                "delivered": bool(result),
                "comm_time": getattr(result, "comm_time", 0.0),
                "nbytes": getattr(result, "nbytes", 0),
            }
        )


__all__ = [
    "ChurnEvent",
    "CommLog",
    "EvalPoint",
    "ExperimentHooks",
    "HistoryRecorder",
    "HubFailure",
    "Report",
    "RoundRecord",
]
