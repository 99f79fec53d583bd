"""Per-agent learning-dynamics metrics drained from fleet flushes.

The fleet engine's stats chunk (``FleetSteps.train_chunk_stats``)
writes per-step per-slot scalars *on the device* through its K steps —
loss, mean |TD error|, max |Q|, gradient global-norm — plus a per-slot
params-finite flag, and the engine drains them at the existing flush
boundary (the same host sync that already carries the losses).  This
module turns that drain into registry series with ``agent=`` labels and
keeps the small per-agent histories the health detectors read.

Everything here is observational: it consumes no randomness and touches
no training state.
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np


class AgentDynamics:
    """Rolling learning-dynamics state of one agent."""

    __slots__ = (
        "agent_id",
        "n_chunks",
        "n_steps",
        "last_loss",
        "min_loss",
        "max_grad_norm",
        "max_q",
        "last_sim_time",
        "nonfinite_flushes",
        "loss_curve",
    )

    def __init__(self, agent_id: int):
        self.agent_id = agent_id
        self.n_chunks = 0
        self.n_steps = 0
        self.last_loss = math.nan
        self.min_loss = math.inf
        self.max_grad_norm = 0.0
        self.max_q = 0.0
        self.last_sim_time = 0.0
        self.nonfinite_flushes = 0
        self.loss_curve: list[tuple[float, float]] = []  # (sim_time, mean loss)


class LearningDynamics:
    """Registry emission + per-agent history for the fleet stats drain.

    ``max_curve_points`` bounds the per-agent loss curve kept for the
    dashboard (the registry histograms are already bounded by series
    cardinality); past the cap every other point is dropped, preserving
    the curve's shape at half resolution.
    """

    def __init__(self, telemetry, *, max_curve_points: int = 512):
        self.telemetry = telemetry
        self.max_curve_points = int(max_curve_points)
        self.slot_to_agent: dict[int, int] = {}
        self.agents: dict[int, AgentDynamics] = {}

    def register_slot(self, slot: int, agent_id: int) -> None:
        self.slot_to_agent[slot] = agent_id

    def _agent(self, agent_id: int) -> AgentDynamics:
        a = self.agents.get(agent_id)
        if a is None:
            a = self.agents[agent_id] = AgentDynamics(agent_id)
        return a

    def on_flush(
        self,
        slots: list[int],
        stats: dict[str, np.ndarray],
        n_real: int,
        sim_time: float,
    ) -> None:
        """Fold one flush's drained stats ([K, N_pad] arrays) into the
        registry and the per-agent histories.  Only the first ``n_real``
        columns are real jobs (the rest are inert pow2 padding)."""
        tel = self.telemetry
        loss = stats["loss"]
        td = stats["td_abs"]
        qm = stats["q_max"]
        gn = stats["grad_norm"]
        finite = stats["params_finite"]
        for j, slot in enumerate(slots[:n_real]):
            agent_id = self.slot_to_agent.get(slot, slot)
            a = self._agent(agent_id)
            col = loss[:, j]
            mean_loss = float(col.mean())
            last_loss = float(col[-1])
            mean_td = float(td[:, j].mean())
            max_q = float(qm[:, j].max())
            mean_gn = float(gn[:, j].mean())
            label = str(agent_id)
            if math.isfinite(mean_loss):
                tel.observe("agent.loss", mean_loss, agent=label)
                # counter *event* too: the trace (and dashboard rendered
                # from it) gets the loss as a per-agent timeline
                tel.counter("agent.loss", f"agent{label}", sim_time, mean_loss)
            if math.isfinite(mean_td):
                tel.observe("agent.td_abs", mean_td, agent=label)
            if math.isfinite(mean_gn):
                tel.observe("agent.grad_norm", mean_gn, agent=label)
            tel.gauge("agent.loss.last", last_loss, agent=label)
            tel.gauge("agent.q_max", max_q, agent=label)
            tel.count("agent.steps_trained", int(col.shape[0]), agent=label)

            a.n_chunks += 1
            a.n_steps += int(col.shape[0])
            a.last_loss = last_loss
            if math.isfinite(mean_loss):
                a.min_loss = min(a.min_loss, mean_loss)
            a.max_grad_norm = max(a.max_grad_norm, float(gn[:, j].max()))
            a.max_q = max(a.max_q, max_q)
            a.last_sim_time = float(sim_time)
            if not bool(finite[j]):
                a.nonfinite_flushes += 1
            a.loss_curve.append((float(sim_time), mean_loss))
            if len(a.loss_curve) > self.max_curve_points:
                a.loss_curve = a.loss_curve[::2]

    def summary(self) -> dict[str, Any]:
        """Per-agent digest for ``Report.extra`` and the dashboard."""
        out: dict[str, Any] = {}
        for aid in sorted(self.agents):
            a = self.agents[aid]
            out[str(aid)] = {
                "n_chunks": a.n_chunks,
                "n_steps": a.n_steps,
                "last_loss": a.last_loss if math.isfinite(a.last_loss) else None,
                "min_loss": a.min_loss if math.isfinite(a.min_loss) else None,
                "max_grad_norm": a.max_grad_norm,
                "max_q": a.max_q,
                "last_sim_time": a.last_sim_time,
                "nonfinite_flushes": a.nonfinite_flushes,
                "loss_curve": [[t, v] for t, v in a.loss_curve],
            }
        return out


__all__ = ["AgentDynamics", "LearningDynamics"]
