"""Hub topology: agent/hub routing and link pricing.

The paper's Fig. 2 layout: each agent talks to one hub and hubs sync
pairwise.  Communication is linear in agents; hub-hub sync is the only
n^2 term and n_hubs << n_agents.

The network carries a registry of
:class:`~repro_torch.core.plane.SharePlane` objects (the ERB plane), and
every push/pull names the plane it rides on.  Every hub-link message is
priced by the :class:`~repro_torch.core.gossip.LinkModel` and accounted
on the shared :class:`~repro_torch.core.gossip.BandwidthMeter`.  Each
push/pull returns a :class:`PushResult` / :class:`PullResult` carrying
the records plus the link time and bytes it cost.  The reference's
gossip and hybrid topologies, per-site link rates, wire encodings and
hub-failure injection are later slices of the port.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import numpy as np

from repro_torch.core.gossip import BandwidthMeter, LinkModel
from repro_torch.core.hub import Hub, sync_hubs
from repro_torch.core.plane import ERBPlane, SharePlane


@dataclass(frozen=True)
class PushResult:
    """Outcome of one ``agent_push``: delivery + what the link charged."""

    delivered: bool
    comm_time: float = 0.0
    nbytes: int = 0


@dataclass(frozen=True)
class PullResult:
    """Outcome of one ``agent_pull``: the records + what the link charged."""

    records: tuple[Any, ...] = ()
    comm_time: float = 0.0
    nbytes: int = 0


@dataclass
class Network:
    hubs: list[Hub]
    agent_hub: dict[int, int] = field(default_factory=dict)
    dropout: float = 0.0
    rng: np.random.Generator = field(default_factory=lambda: np.random.default_rng(0))
    planes: dict[str, SharePlane] = field(default_factory=lambda: {"erb": ERBPlane()})
    link: LinkModel = field(default_factory=LinkModel)
    meter: BandwidthMeter = field(default_factory=BandwidthMeter)
    # statistics (aggregate and per plane)
    n_pushed: int = 0
    n_dropped: int = 0
    n_synced: int = 0
    plane_pushed: dict[str, int] = field(default_factory=dict)

    def attach_agent(self, agent_id: int, hub_id: int | None = None):
        """New agents attach to the least-loaded hub by default."""
        if hub_id is None:
            loads = {h.hub_id: 0 for h in self.hubs}
            for hid in self.agent_hub.values():
                loads[hid] += 1
            hub_id = min(loads, key=lambda k: (loads[k], k))
        self.agent_hub[agent_id] = hub_id

    def hub_of(self, agent_id: int) -> Hub:
        return self.hubs[self.agent_hub[agent_id]]

    def agent_push(self, agent_id: int, item: Any, plane: str = "erb") -> PushResult:
        """Agent uploads one record on ``plane`` to its hub (may drop)."""
        if self.dropout > 0.0 and self.rng.random() < self.dropout:
            self.n_dropped += 1
            return PushResult(False)
        pl = self.planes[plane]
        if not self.hub_of(agent_id).push(item, pl):
            return PushResult(False)
        nbytes = pl.payload_nbytes(item)
        self.meter.account(plane, nbytes)
        self.n_pushed += 1
        self.plane_pushed[plane] = self.plane_pushed.get(plane, 0) + 1
        return PushResult(True, self.link.transfer_time(nbytes), nbytes)

    def agent_pull(
        self, agent_id: int, seen: set[str], plane: str = "erb"
    ) -> PullResult:
        """Every unseen record on the agent's hub for ``plane``, with the
        priced link time/bytes of the download."""
        pl = self.planes[plane]
        pulled = self.hub_of(agent_id).pull_unseen(set(seen), plane)
        if self.dropout > 0.0:
            pulled = [e for e in pulled if self.rng.random() >= self.dropout]
        comm, nbytes_total = 0.0, 0
        for e in pulled:
            nbytes = pl.payload_nbytes(e)
            self.meter.account(plane, nbytes)
            comm += self.link.transfer_time(nbytes)
            nbytes_total += nbytes
        return PullResult(tuple(pulled), comm, nbytes_total)

    def sync(self) -> int:
        """Hub-hub backbone sync."""
        n = sync_hubs(
            self.hubs,
            self.rng,
            self.dropout,
            planes=[self.planes[k] for k in sorted(self.planes)],
            meter=self.meter,
        )
        self.n_synced += n
        return n

    def all_known(self, plane: str = "erb") -> set[str]:
        ids: set[str] = set()
        for h in self.hubs:
            ids |= set(h.store(plane))
        return ids


__all__ = ["Network", "PullResult", "PushResult"]
