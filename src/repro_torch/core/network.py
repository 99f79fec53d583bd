"""Pluggable topology: hub/agent routing, hub-less gossip, failure injection.

Three topologies share one transport API (``agent_push`` / ``agent_pull``
/ ``sync``):

* ``"hub"`` — the paper's Fig. 2 layout: each agent talks to one hub,
  hubs sync pairwise.  Communication is linear in agents; hub-hub sync
  is the only n^2 term and n_hubs << n_agents.
* ``"gossip"`` — no hubs at all: agents publish into their own local
  store and :class:`~repro_torch.core.gossip.GossipTopology` replicates
  records peer-to-peer in anti-entropy rounds.
* ``"hybrid"`` — both at once: pushes land on the hub *and* the local
  gossip store; pulls merge the two, deduplicated per plane key.

The network carries a registry of
:class:`~repro_torch.core.plane.SharePlane` objects (the ERB plane by
default, the weight plane when registered), and every push/pull names
the plane it rides on.  Records are wire-encoded once at the ingress
edge (``plane.encode``), and every hub-link message is priced by the
:class:`~repro_torch.core.gossip.LinkModel` of its leg (per site with
:meth:`Network.configure_sites`) and accounted on the shared
:class:`~repro_torch.core.gossip.BandwidthMeter`.  Each push/pull returns
a :class:`PushResult` / :class:`PullResult` carrying the records plus the
link time and bytes it cost.  Dropout, hub liveness, and hub-hub sync
apply to all planes uniformly; :meth:`Network.fail_hub` kills a hub and
re-homes its agents while any hub lives.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import numpy as np

from repro_torch.core.gossip import (
    BandwidthMeter,
    GossipTopology,
    LinkModel,
    PeerSampler,
    SiteLinks,
)
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
    topology: str = "hub"  # hub | gossip | hybrid
    link: LinkModel = field(default_factory=LinkModel)
    meter: BandwidthMeter = field(default_factory=BandwidthMeter)
    gossip: GossipTopology | None = None
    # statistics (aggregate and per plane)
    n_pushed: int = 0
    n_dropped: int = 0
    n_synced: int = 0
    plane_pushed: dict[str, int] = field(default_factory=dict)
    # per-link heterogeneous rates (None = every leg uses `link`)
    site_links: SiteLinks | None = None

    def __post_init__(self):
        if self.topology not in ("hub", "gossip", "hybrid"):
            raise ValueError(f"unknown topology: {self.topology!r}")

    # -- wiring ------------------------------------------------------------
    def enable_gossip(
        self,
        sampler: PeerSampler,
        *,
        rng: np.random.Generator | None = None,
    ) -> GossipTopology:
        """Attach a gossip overlay sharing this network's planes/meter/link."""
        self.gossip = GossipTopology(
            self.planes,
            sampler,
            link=self.link,
            meter=self.meter,
            rng=rng,
            site_links=self.site_links,
        )
        for aid in self.agent_hub:
            self.gossip.add_agent(aid)
        return self.gossip

    def configure_sites(
        self,
        agent_site: dict[int, int],
        *,
        hub_site: dict[int, int] | None = None,
        intra: LinkModel | None = None,
        inter: LinkModel | None = None,
    ) -> SiteLinks:
        """Enable per-link heterogeneous rates (fast intra-site, slow
        cross-site).  Endpoints without a site keep the default link;
        the gossip overlay (if any) shares the same link map."""
        self.site_links = SiteLinks(
            default=self.link,
            agent_site=dict(agent_site),
            hub_site=dict(hub_site or {}),
            intra=intra,
            inter=inter,
        )
        if self.gossip is not None:
            self.gossip.site_links = self.site_links
        return self.site_links

    def link_for(self, agent_id: int) -> LinkModel:
        """The link pricing this agent's hub leg."""
        if self.site_links is None:
            return self.link
        return self.site_links.agent_hub(agent_id, self.agent_hub.get(agent_id))

    def register_plane(self, plane: SharePlane) -> SharePlane:
        self.planes[plane.name] = plane
        return plane

    def attach_agent(self, agent_id: int, hub_id: int | None = None):
        """New agents attach to the least-loaded live hub by default;
        under pure ``gossip`` they join the overlay only (which must
        exist)."""
        if self.gossip is not None:
            self.gossip.add_agent(agent_id)
        if self.topology == "gossip":
            if self.gossip is None:
                raise RuntimeError(
                    "topology='gossip' needs enable_gossip() before agents attach"
                )
            return
        if hub_id is None:
            loads = {h.hub_id: 0 for h in self.hubs if h.alive}
            if not loads:
                # every hub is dead: the joiner stays detached (hub
                # uploads drop, pulls return nothing) — same orphan
                # semantics as re-homing after a total failure
                return
            for hid in self.agent_hub.values():
                if hid in loads:
                    loads[hid] += 1
            hub_id = min(loads, key=lambda k: (loads[k], k))
        self.agent_hub[agent_id] = hub_id

    def detach_agent(self, agent_id: int):
        self.agent_hub.pop(agent_id, None)
        if self.gossip is not None:
            self.gossip.remove_agent(agent_id)
        for plane in self.planes.values():
            plane.forget_agent(agent_id)

    def hub_of(self, agent_id: int) -> Hub:
        return self.hubs[self.agent_hub[agent_id]]

    # -- data planes ---------------------------------------------------------
    def agent_push(self, agent_id: int, item: Any, plane: str = "erb") -> PushResult:
        """Agent publishes one record on ``plane``.

        Hub topologies upload to the agent's hub (may drop); gossip
        topologies insert into the agent's own local store (free — the
        wire cost is paid when anti-entropy replicates it).  The result
        says whether the record was newly kept anywhere and carries the
        link time/bytes the upload cost."""
        if self.topology != "hub" and self.gossip is None:
            raise RuntimeError(f"topology={self.topology!r} needs enable_gossip()")
        pl = self.planes[plane]
        # decide the hub link's fate BEFORE encoding: a dropped upload must
        # not advance sender-side codec state (compressed delta chains stay
        # consistent with what some store actually received)
        hub_up = False
        if self.topology != "gossip":
            if agent_id not in self.agent_hub:
                # orphaned by hub failure with no survivor to re-home to:
                # the upload is lost (hybrid still lands it on gossip)
                self.n_dropped += 1
            elif self.dropout > 0.0 and self.rng.random() < self.dropout:
                self.n_dropped += 1
            elif not self.hub_of(agent_id).alive:
                self.n_dropped += 1
            else:
                hub_up = True
        if self.gossip is None and not hub_up:
            return PushResult(False)  # pure hub: the upload is lost
        item = pl.encode(item)
        delivered = False
        comm, nbytes_out = 0.0, 0
        if self.gossip is not None and self.gossip.insert_local(agent_id, item, pl):
            delivered = True
        if hub_up and self.hub_of(agent_id).push(item, pl):
            nbytes = pl.payload_nbytes(item)
            self.meter.account(plane, nbytes)
            comm = self.link_for(agent_id).transfer_time(nbytes)
            nbytes_out = nbytes
            delivered = True
        if delivered:
            self.n_pushed += 1
            self.plane_pushed[plane] = self.plane_pushed.get(plane, 0) + 1
        return PushResult(delivered, comm, nbytes_out)

    def agent_pull(
        self, agent_id: int, seen: set[str], plane: str = "erb"
    ) -> PullResult:
        """Every unseen record reachable by the agent on ``plane``.

        Local gossip copies are free (their wire cost was paid at
        anti-entropy delivery), so under ``hybrid`` the hub leg only
        downloads — and only prices — records the agent does not already
        hold locally; an orphan (no live hub to re-home to) has no hub
        leg."""
        pl = self.planes[plane]
        local: list[Any] = []
        if self.gossip is not None:
            local = self.gossip.pull_local(agent_id, seen, plane)
        out: list[Any] = []
        comm, nbytes_total = 0.0, 0
        if self.topology != "gossip" and agent_id in self.agent_hub:
            skip = set(seen) | {pl.key(e) for e in local}
            pulled = self.hub_of(agent_id).pull_unseen(skip, plane)
            if self.dropout > 0.0:
                pulled = [e for e in pulled if self.rng.random() >= self.dropout]
            link = self.link_for(agent_id)
            for e in pulled:
                nbytes = pl.payload_nbytes(e)
                self.meter.account(plane, nbytes)
                comm += link.transfer_time(nbytes)
                nbytes_total += nbytes
            out.extend(pulled)
        out.extend(local)
        return PullResult(tuple(out), comm, nbytes_total)

    def sync(self) -> int:
        """Hub-hub backbone sync (no-op under pure gossip)."""
        if self.topology == "gossip":
            return 0
        n = sync_hubs(
            self.hubs,
            self.rng,
            self.dropout,
            planes=[self.planes[k] for k in sorted(self.planes)],
            meter=self.meter,
        )
        self.n_synced += n
        return n

    # -- failures ------------------------------------------------------------
    def fail_hub(self, hub_id: int) -> list[int]:
        """Kill a hub; returns the agents it stranded.

        Orphans re-home to the least-loaded surviving hub when one
        exists.  With every hub dead they stay detached: hub uploads are
        lost and hub pulls return nothing — under ``hybrid`` the gossip
        overlay keeps carrying their records (the Table 2 failover)."""
        self.hubs[hub_id].fail()
        orphaned = sorted(a for a, hid in self.agent_hub.items() if hid == hub_id)
        for a in orphaned:
            del self.agent_hub[a]
            if any(h.alive for h in self.hubs):
                self.attach_agent(a)
        return orphaned

    def all_known(self, plane: str = "erb") -> set[str]:
        ids: set[str] = set()
        for h in self.hubs:
            ids |= set(h.store(plane))
        if self.gossip is not None:
            ids |= self.gossip.all_known(plane)
        return ids


__all__ = ["Network", "PullResult", "PushResult"]
