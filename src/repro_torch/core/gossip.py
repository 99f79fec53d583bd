"""Hub-less gossip topology: peer sampling, link models, bandwidth accounting.

Every agent keeps a local per-plane store and reconciles it with sampled
peers in anti-entropy push-pull rounds driven by the event scheduler —
no hub in the loop (BrainTorrent-style peer-to-peer federation).

Three pieces compose:

* :class:`PeerSampler` policies (static ring, random-k, full mesh, and a
  time-varying exponential graph) pick who talks to whom each round;
* :class:`LinkModel` prices every message (fixed latency plus
  ``bytes / rate``) and drops it with a configurable probability, so
  simulated time reflects payload size; :class:`SiteLinks` prices each
  leg by whether its two ends share a site;
* :class:`BandwidthMeter` accounts bytes-on-wire per plane.  The meter is
  shared with the hub path in :class:`~repro_torch.core.network.Network`,
  so hub and gossip transport costs are directly comparable.

Records ride the same :class:`~repro_torch.core.plane.SharePlane`
registry as the hub topology: dedup/retention (``plane.admit``), wire
encoding (``plane.encode``) and payload sizing (``plane.payload_nbytes``)
apply identically, which is what makes ``topology="hybrid"`` coherent.
Every random draw (the random-k sampler's ``choice``, the link drop)
comes from a seeded ``np.random.Generator`` in the reference's order.
"""

from __future__ import annotations

import math
from collections.abc import Callable, Sequence
from dataclasses import dataclass, field
from typing import Any

import numpy as np

from repro_torch.core.plane import SharePlane
from repro_torch.telemetry import NULL, MetricsRegistry, Telemetry

# ---------------------------------------------------------------------------
# link + bandwidth accounting
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class LinkModel:
    """Per-message cost model: ``latency + nbytes / rate``, p(drop).

    The default link is free and lossless (paper-faithful timing).
    """

    latency: float = 0.0
    rate: float = math.inf  # bytes per unit of simulated time
    drop: float = 0.0  # per-message drop probability

    def transfer_time(self, nbytes: int) -> float:
        if math.isinf(self.rate):
            return self.latency
        return self.latency + float(nbytes) / self.rate


@dataclass
class SiteLinks:
    """Per-link heterogeneous rates: fast intra-site, slow cross-site.

    Agents (and hubs) are assigned to sites; a message between two
    endpoints on the same site is priced by ``intra``, one crossing
    sites by ``inter``, and any endpoint without a site assignment falls
    back to ``default``.  One instance is shared between the network
    (agent-hub legs) and :class:`GossipTopology` (agent-agent legs).
    """

    default: LinkModel
    agent_site: dict[int, int] = field(default_factory=dict)
    hub_site: dict[int, int] = field(default_factory=dict)
    intra: LinkModel | None = None
    inter: LinkModel | None = None

    def _pick(self, same_site: bool | None) -> LinkModel:
        if same_site is None:
            return self.default
        if same_site:
            return self.intra if self.intra is not None else self.default
        return self.inter if self.inter is not None else self.default

    def agent_hub(self, agent_id: int, hub_id: int | None) -> LinkModel:
        sa = self.agent_site.get(agent_id)
        sh = self.hub_site.get(hub_id) if hub_id is not None else None
        if sa is None or sh is None:
            return self._pick(None)
        return self._pick(sa == sh)

    def pair(self, a: int, b: int) -> LinkModel:
        sa, sb = self.agent_site.get(a), self.agent_site.get(b)
        if sa is None or sb is None:
            return self._pick(None)
        return self._pick(sa == sb)


class BandwidthMeter:
    """Bytes/messages that crossed a link, keyed by plane name.

    A view over ``comm.bytes`` / ``comm.msgs`` counter series in a
    private, always-enabled :class:`~repro_torch.telemetry.MetricsRegistry`,
    so the per-plane byte totals in a report never depend on telemetry;
    :meth:`bind` rebases it onto a run's registry so the same totals
    also appear in exported traces.
    """

    def __init__(self, registry: MetricsRegistry | None = None):
        if registry is None or not registry.enabled:
            registry = MetricsRegistry(max_series=64)
        self._registry = registry

    def bind(self, registry: MetricsRegistry) -> None:
        """Account onto ``registry`` from now on (ignored when disabled —
        a NullRegistry would silently drop the run's byte totals)."""
        if registry.enabled:
            self._registry = registry

    def account(self, plane: str, nbytes: int) -> None:
        self._registry.count("comm.bytes", int(nbytes), plane=plane)
        self._registry.count("comm.msgs", 1, plane=plane)

    @property
    def bytes_by_plane(self) -> dict[str, int]:
        by = self._registry.counters_by_label("comm.bytes", "plane")
        return {k: int(v) for k, v in sorted(by.items())}

    @property
    def msgs_by_plane(self) -> dict[str, int]:
        by = self._registry.counters_by_label("comm.msgs", "plane")
        return {k: int(v) for k, v in sorted(by.items())}

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_plane.values())


# ---------------------------------------------------------------------------
# peer-sampling policies
# ---------------------------------------------------------------------------


class PeerSampler:
    """Picks gossip partners for one agent in one anti-entropy round."""

    name = "base"

    def new_round(self, t: float) -> None:
        """Hook called once per anti-entropy round (time-varying policies)."""

    def peers(self, agent_id: int, ids: Sequence[int]) -> list[int]:
        raise NotImplementedError


class RingSampler(PeerSampler):
    """Static directed ring: each agent exchanges with its ``fanout``
    successors in sorted-id order."""

    name = "ring"

    def __init__(self, fanout: int = 1):
        self.fanout = max(1, int(fanout))

    def peers(self, agent_id: int, ids: Sequence[int]) -> list[int]:
        ring = sorted(ids)
        if agent_id not in ring or len(ring) < 2:
            return []
        i = ring.index(agent_id)
        k = min(self.fanout, len(ring) - 1)
        return [ring[(i + s) % len(ring)] for s in range(1, k + 1)]


class RandomKSampler(PeerSampler):
    """``k`` distinct uniform peers per agent per round (seeded)."""

    name = "random"

    def __init__(self, k: int = 2, seed: int = 0):
        self.k = max(1, int(k))
        self.rng = np.random.default_rng(seed)

    def peers(self, agent_id: int, ids: Sequence[int]) -> list[int]:
        others = sorted(x for x in ids if x != agent_id)
        if not others:
            return []
        k = min(self.k, len(others))
        pick = self.rng.choice(len(others), size=k, replace=False)
        return [others[int(j)] for j in sorted(pick)]


class FullMeshSampler(PeerSampler):
    """Every agent exchanges with every other agent (n^2 baseline)."""

    name = "full"

    def peers(self, agent_id: int, ids: Sequence[int]) -> list[int]:
        return [x for x in sorted(ids) if x != agent_id]


class TimeVaryingSampler(PeerSampler):
    """One-peer time-varying exponential graph: at round ``r`` every agent
    talks to the peer ``2**(r mod ceil(log2 n))`` hops ahead on the id
    ring, so a record reaches all ``n`` agents in O(log n) rounds with
    constant per-round degree."""

    name = "timevary"

    def __init__(self):
        self._round = -1

    def new_round(self, t: float) -> None:
        self._round += 1

    def peers(self, agent_id: int, ids: Sequence[int]) -> list[int]:
        ring = sorted(ids)
        n = len(ring)
        if agent_id not in ring or n < 2:
            return []
        n_offsets = max(1, math.ceil(math.log2(n)))
        offset = 2 ** (max(0, self._round) % n_offsets) % n
        offset = offset or 1
        return [ring[(ring.index(agent_id) + offset) % n]]


def make_sampler(name: str, *, fanout: int = 2, seed: int = 0) -> PeerSampler:
    """Factory keyed by ``ADFLLConfig.gossip_sampler``."""
    if name == "ring":
        return RingSampler(fanout=fanout)
    if name == "random":
        return RandomKSampler(k=fanout, seed=seed)
    if name == "full":
        return FullMeshSampler()
    if name == "timevary":
        return TimeVaryingSampler()
    raise ValueError(f"unknown peer sampler: {name!r}")


# ---------------------------------------------------------------------------
# the topology
# ---------------------------------------------------------------------------


@dataclass
class GossipStats:
    n_rounds: int = 0
    n_exchanges: int = 0
    n_sent: int = 0
    n_delivered: int = 0
    n_dropped: int = 0


class GossipTopology:
    """Peer-to-peer record exchange over per-agent local stores.

    Agents publish records into their own store (``insert_local``) and
    consume from it (``pull_local``) — both free, they are node-local.
    Replication happens in :meth:`anti_entropy` rounds: each agent
    reconciles with peers chosen by the sampler, both directions
    (push-pull), one message per missing record.  Every message is
    priced by the pair's :class:`LinkModel` and accounted on the shared
    :class:`BandwidthMeter`; with a scheduler attached, a record lands at
    ``now + latency + nbytes / rate``, so large payloads propagate later
    in simulated time.

    Unlike the hub topology, a departing agent takes its local store
    with it: knowledge survives only if it has already gossiped out.
    """

    def __init__(
        self,
        planes: dict[str, SharePlane],
        sampler: PeerSampler,
        *,
        link: LinkModel | None = None,
        meter: BandwidthMeter | None = None,
        rng: np.random.Generator | None = None,
        site_links: SiteLinks | None = None,
        online: Callable[[int], bool] | None = None,
        telemetry: Telemetry | None = None,
    ):
        self.planes = planes  # shared registry (same dict as Network.planes)
        self.sampler = sampler
        self.link = link if link is not None else LinkModel()
        self.meter = meter if meter is not None else BandwidthMeter()
        self.telemetry = telemetry if telemetry is not None else NULL
        self.site_links = site_links  # shared with Network.configure_sites
        self.rng = rng if rng is not None else np.random.default_rng(0)
        self.stores: dict[int, dict[str, dict[str, Any]]] = {}
        self.stats = GossipStats()
        # availability view (population dynamics): when set, anti-entropy
        # rounds run over online agents only — an offline peer is neither
        # sampled nor initiates an exchange.  Its local store stays put (a
        # mailbox for in-flight deliveries); None = everyone reachable.
        self.online = online
        # observe-only delivery hook (the observatory's coverage curves):
        # called as on_deliver(dst, rec, plane_name, arrival_time) after
        # every *admitted* delivery.  None costs one attribute check.
        self.on_deliver: Callable[[int, Any, str, float], None] | None = None

    # -- membership ---------------------------------------------------------
    def add_agent(self, agent_id: int) -> None:
        self.stores.setdefault(agent_id, {})

    def remove_agent(self, agent_id: int) -> None:
        self.stores.pop(agent_id, None)

    def local_store(self, agent_id: int, plane: str) -> dict[str, Any]:
        """The agent's own store for one plane ({} if the agent has left —
        never re-created, so departed agents stay departed)."""
        agent = self.stores.get(agent_id)
        if agent is None:
            return {}
        return agent.setdefault(plane, {})

    # -- node-local publish/consume ----------------------------------------
    def insert_local(self, agent_id: int, item: Any, plane: SharePlane) -> bool:
        """Publish one (already encoded) record into the agent's own store."""
        if agent_id not in self.stores:
            return False
        return plane.admit(self.local_store(agent_id, plane.name), item)

    def pull_local(self, agent_id: int, seen: set[str], plane: str) -> list[Any]:
        return [
            v
            for k, v in sorted(self.local_store(agent_id, plane).items())
            if k not in seen
        ]

    # -- anti-entropy -------------------------------------------------------
    def anti_entropy(self, sched=None, now: float = 0.0) -> int:
        """One push-pull round over sampled peer pairs.

        With ``sched`` (a :class:`~repro_torch.core.scheduler.Scheduler`),
        each record is delivered by a future event at its link transfer
        time; without one, delivery is immediate.  Returns the number of
        records put on the wire.

        With an ``online`` view attached, the round runs over currently
        online agents only: offline peers are invisible to the sampler.
        """
        t = sched.now if sched is not None else now
        self.sampler.new_round(t)
        self.stats.n_rounds += 1
        ids = sorted(self.stores)
        if self.online is not None:
            ids = [a for a in ids if self.online(a)]
        sent = 0
        done_pairs = set()  # an exchange is push-pull: reconcile a pair once
        for aid in ids:
            for peer in self.sampler.peers(aid, ids):
                if peer not in self.stores:
                    continue
                pair = (min(aid, peer), max(aid, peer))
                if pair in done_pairs:
                    continue
                done_pairs.add(pair)
                self.stats.n_exchanges += 1
                sent += self._exchange(sched, t, aid, peer)
        return sent

    def pair_link(self, a: int, b: int) -> LinkModel:
        """The link pricing one a<->b exchange (site-aware when sites
        are configured, the shared default link otherwise)."""
        if self.site_links is not None:
            return self.site_links.pair(a, b)
        return self.link

    def _exchange(self, sched, t: float, a: int, b: int) -> int:
        """Push-pull reconciliation of one pair, every plane."""
        sent = 0
        pair_bytes = 0
        t_last = t
        link = self.pair_link(a, b)
        for name in sorted(self.planes):
            plane = self.planes[name]
            for src, dst in ((a, b), (b, a)):
                dst_store = self.local_store(dst, name)
                for rid, rec in sorted(self.local_store(src, name).items()):
                    if rid in dst_store:
                        continue
                    self.stats.n_sent += 1
                    sent += 1
                    if link.drop > 0.0 and self.rng.random() < link.drop:
                        self.stats.n_dropped += 1
                        self.telemetry.count("gossip.dropped", 1, plane=name)
                        continue
                    nbytes = plane.payload_nbytes(rec)
                    pair_bytes += nbytes
                    self.meter.account(name, nbytes)
                    if sched is None:
                        self._deliver(dst, rec, name, t)
                    else:
                        arrival = t + link.transfer_time(nbytes)
                        t_last = max(t_last, arrival)
                        sched.at(
                            arrival,
                            lambda s, tt, d=dst, r=rec, p=name: self._deliver(
                                d, r, p, tt
                            ),
                            tag=f"gossip_deliver_{name}",
                        )
        if self.telemetry.enabled and sent:
            # span from initiation to the last in-flight delivery of the
            # pair — a "gossip burst" on the shared gossip track
            self.telemetry.span(
                "gossip.exchange",
                "gossip",
                t,
                t_last,
                pair=f"{a}<->{b}",
                records=sent,
                bytes=pair_bytes,
            )
            self.telemetry.count("gossip.exchange.bytes", pair_bytes)
            self.telemetry.observe("gossip.exchange.records", sent)
        return sent

    def _deliver(self, dst: int, rec: Any, plane_name: str, t: float = 0.0) -> bool:
        if dst not in self.stores:  # agent left while the record was in flight
            return False
        plane = self.planes[plane_name]
        if plane.admit(self.local_store(dst, plane_name), rec):
            self.stats.n_delivered += 1
            if self.on_deliver is not None:
                self.on_deliver(dst, rec, plane_name, t)
            return True
        return False

    # -- introspection ------------------------------------------------------
    def all_known(self, plane: str) -> set[str]:
        ids: set[str] = set()
        for aid in self.stores:
            ids |= set(self.local_store(aid, plane))
        return ids

    def converged(self, plane: str) -> bool:
        """True iff every agent holds the identical record set."""
        stores = [set(self.local_store(a, plane)) for a in sorted(self.stores)]
        return all(s == stores[0] for s in stores[1:]) if stores else True


__all__ = [
    "BandwidthMeter",
    "FullMeshSampler",
    "GossipStats",
    "GossipTopology",
    "LinkModel",
    "PeerSampler",
    "RandomKSampler",
    "RingSampler",
    "SiteLinks",
    "TimeVaryingSampler",
    "make_sampler",
]
