"""Fleet observatory: learning dynamics, knowledge propagation, health.

Telemetry observes *mechanics* — spans, bytes, flush counts.  The
observatory observes *what the fleet is learning and how knowledge
spreads*: per-agent loss / TD-error / grad-norm / max-|Q| written on
the device by the fleet's stats chunk (the TD statistics by the
``fused_td`` kernel's own launch), version
vectors and staleness distributions over the sharing planes, gossip
epidemic coverage, and NaN / divergence / straggler health detection.

One :class:`Observatory` bundles the three pillars and is attached by
the owning system (``ADFLLSystem`` auto-creates one whenever its
telemetry bundle is enabled; ``repro_torch.serve`` sessions do the same):

* ``engine.observatory = obs`` switches the fleet engine onto the
  stats-carrying train chunk and routes the flush-boundary drain into
  :meth:`Observatory.on_flush`;
* the federated round path calls the ``propagation`` note-hooks and
  stamps version vectors onto outgoing records;
* ``GossipTopology.on_deliver`` feeds anti-entropy deliveries.

The contract matches telemetry's: **observe-only**.  No randomness is
consumed, no training numbers change, and the only device-side cost is
the stats riding the existing flush's one host transfer (bit-identity
with the observatory disabled *and* enabled is asserted by the
fingerprint tests).
"""

from __future__ import annotations

from typing import Any

import numpy as np

from .health import HealthMonitor
from .learning import AgentDynamics, LearningDynamics
from .propagation import PropagationTracker


class Observatory:
    """The three pillars behind one facade (see module docstring)."""

    def __init__(self, telemetry, *, max_tracked: int = 4096):
        self.telemetry = telemetry
        self.learning = LearningDynamics(telemetry)
        self.propagation = PropagationTracker(telemetry, max_tracked=max_tracked)
        self.health = HealthMonitor(telemetry, self.learning)

    # -- fleet side ----------------------------------------------------------
    def register_slot(self, slot: int, agent_id: int) -> None:
        """Map an engine slot to its agent id for ``agent=`` labels."""
        self.learning.register_slot(slot, agent_id)

    def on_flush(
        self,
        slots: list[int],
        stats: dict[str, np.ndarray],
        n_real: int,
        sim_time: float,
    ) -> None:
        """FleetEngine drain point — called once per flush group with the
        stats pytree already on host (the flush's existing sync)."""
        self.learning.on_flush(slots, stats, n_real, sim_time)
        self.health.on_flush(slots, stats, n_real, sim_time)

    # -- report side ---------------------------------------------------------
    def report_extra(self, *, makespan: float) -> dict[str, Any]:
        """The observatory's contribution to ``Report.extra``."""
        return {
            "learning": self.learning.summary(),
            "propagation": self.propagation.summary(),
            "health": self.health.verdict(makespan=makespan),
        }


__all__ = [
    "AgentDynamics",
    "HealthMonitor",
    "LearningDynamics",
    "Observatory",
    "PropagationTracker",
]
