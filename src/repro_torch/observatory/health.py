"""Fleet health detection: NaN/Inf params, loss divergence, stragglers.

Three detectors, all reading state the other observatory pillars
already collect (no extra device work):

* **Non-finite params** — the stats chunk's per-slot ``params_finite``
  flag, checked at every flush boundary.  Any hit is an ``alert``.
* **Loss divergence** — a per-agent chunk-mean loss that climbs past
  ``divergence_factor`` x its running minimum (after a warmup of
  ``min_samples`` chunks) is flagged once per agent, as a ``warn``.
* **Stragglers / stalls** — decided at report time against the run's
  makespan: an agent whose last training activity predates
  ``straggler_frac`` of the makespan stalled early, a ``warn``.

Each incident is also emitted as a telemetry instant on the ``health``
track (sim clock), so traces show *when* the fleet went bad.
"""

from __future__ import annotations

import math
from typing import Any

from .learning import LearningDynamics

STATUS_ORDER = {"ok": 0, "warn": 1, "alert": 2}


class HealthMonitor:
    """Incident collection + final verdict over the learning state."""

    def __init__(
        self,
        telemetry,
        learning: LearningDynamics,
        *,
        divergence_factor: float = 10.0,
        min_samples: int = 3,
        straggler_frac: float = 0.5,
        max_incidents: int = 256,
    ):
        self.telemetry = telemetry
        self.learning = learning
        self.divergence_factor = float(divergence_factor)
        self.min_samples = int(min_samples)
        self.straggler_frac = float(straggler_frac)
        self.max_incidents = int(max_incidents)
        self.incidents: list[dict[str, Any]] = []
        self.n_dropped_incidents = 0
        self._nonfinite_agents: set[int] = set()
        self._diverged_agents: set[int] = set()

    def _incident(self, kind: str, severity: str, sim_time: float, **detail) -> None:
        if len(self.incidents) >= self.max_incidents:
            self.n_dropped_incidents += 1
            return
        self.incidents.append(
            {"kind": kind, "severity": severity, "sim_time": float(sim_time), **detail}
        )
        self.telemetry.instant(f"health.{kind}", "health", sim_time, **detail)
        self.telemetry.count("health.incidents", 1, kind=kind)

    def on_flush(
        self, slots: list[int], stats: dict, n_real: int, sim_time: float
    ) -> None:
        """Flush-boundary detectors (after LearningDynamics.on_flush has
        folded the same drain, so running minima are current)."""
        finite = stats["params_finite"]
        loss = stats["loss"]
        for j, slot in enumerate(slots[:n_real]):
            agent_id = self.learning.slot_to_agent.get(slot, slot)
            if not bool(finite[j]) and agent_id not in self._nonfinite_agents:
                self._nonfinite_agents.add(agent_id)
                self._incident("nonfinite_params", "alert", sim_time, agent=agent_id)
            a = self.learning.agents.get(agent_id)
            if a is None or agent_id in self._diverged_agents:
                continue
            mean_loss = float(loss[:, j].mean())
            if not math.isfinite(mean_loss):
                if agent_id not in self._nonfinite_agents:
                    self._nonfinite_agents.add(agent_id)
                    self._incident("nonfinite_loss", "alert", sim_time, agent=agent_id)
                continue
            if (
                a.n_chunks >= self.min_samples
                and math.isfinite(a.min_loss)
                and a.min_loss > 0.0
                and mean_loss > self.divergence_factor * a.min_loss
            ):
                self._diverged_agents.add(agent_id)
                self._incident(
                    "loss_divergence",
                    "warn",
                    sim_time,
                    agent=agent_id,
                    loss=mean_loss,
                    min_loss=a.min_loss,
                )

    def verdict(self, *, makespan: float) -> dict[str, Any]:
        """The ``Report.extra["health"]`` document (straggler detection
        runs here — it needs the final makespan)."""
        stragglers: list[int] = []
        if makespan > 0.0:
            cutoff = self.straggler_frac * makespan
            for aid in sorted(self.learning.agents):
                a = self.learning.agents[aid]
                if a.n_chunks > 0 and a.last_sim_time < cutoff:
                    stragglers.append(aid)
                    self._incident(
                        "straggler",
                        "warn",
                        makespan,
                        agent=aid,
                        last_activity=a.last_sim_time,
                    )
        status = "ok"
        for inc in self.incidents:
            if STATUS_ORDER[inc["severity"]] > STATUS_ORDER[status]:
                status = inc["severity"]
        counts: dict[str, int] = {}
        for inc in self.incidents:
            counts[inc["kind"]] = counts.get(inc["kind"], 0) + 1
        return {
            "status": status,
            "incidents": list(self.incidents),
            "counts": counts,
            "stragglers": stragglers,
            "n_dropped_incidents": self.n_dropped_incidents,
        }


__all__ = ["HealthMonitor"]
