"""Knowledge-propagation tracking: version vectors, staleness, coverage.

BrainTorrent-style bookkeeping over the two sharing planes:

* **Version vectors** — the tracker maintains every agent's last known
  round (updated on each push) and exposes the sorted
  ``(agent_id, round_idx)`` tuple the system stamps onto outgoing
  :class:`~repro_torch.core.plane.WeightSnapshot` and
  :class:`~repro_torch.core.erb.ERBMeta` records when the observatory is on.
* **Staleness / influence** — every ``mix_params`` records the staleness
  distribution of the folded snapshots (on the run's configured clock)
  and accumulates per-source mixing influence from the
  ``staleness_alphas`` the mix actually used.
* **Propagation latency** — ERB records are timed from creation (push)
  to first remote consumption on the *sim* clock; gossip deliveries are
  timed per record, yielding epidemic coverage curves (fraction of
  deliveries landed within t seconds of the record's birth).

All tables are bounded (``max_tracked`` records per kind); overflow is
counted, never fatal.  Purely observational — no randomness, no
training-state access.
"""

from __future__ import annotations

from typing import Any

import numpy as np


def _dist_summary(values: list[float]) -> dict[str, Any] | None:
    if not values:
        return None
    x = np.asarray(values, np.float64)
    return {
        "n": int(x.size),
        "mean": float(x.mean()),
        "p50": float(np.percentile(x, 50)),
        "p90": float(np.percentile(x, 90)),
        "max": float(x.max()),
    }


def _ecdf_points(values: list[float], max_points: int = 32) -> list[list[float]]:
    """Downsampled ECDF of latency samples: [[t, fraction <= t], ...]."""
    if not values:
        return []
    x = np.sort(np.asarray(values, np.float64))
    n = x.size
    take = min(max_points, n)
    pick = np.unique(np.linspace(0, n - 1, take).round().astype(int))
    return [[float(x[i]), float((i + 1) / n)] for i in pick]


class PropagationTracker:
    """One run's propagation bookkeeping (see module docstring)."""

    def __init__(self, telemetry, *, max_tracked: int = 4096):
        self.telemetry = telemetry
        self.max_tracked = int(max_tracked)
        self.n_dropped_tracked = 0
        #: agent_id -> last known round (the global version vector)
        self.progress: dict[int, int] = {}
        #: erb_id -> (source_agent, push sim_time)
        self._erb_born: dict[str, tuple[int, float]] = {}
        self._erb_consumed: set[str] = set()
        #: snap_id -> (source_agent, push sim_time)
        self._snap_born: dict[str, tuple[int, float]] = {}
        self.erb_latencies: list[float] = []
        self.staleness_samples: list[float] = []
        self.gossip_latencies: list[float] = []
        self.influence_by_source: dict[int, float] = {}
        self.n_erb_pushes = 0
        self.n_snap_pushes = 0
        self.n_mixes = 0
        self.n_mixed_snaps = 0
        self.n_gossip_deliveries = 0

    # -- version vector ------------------------------------------------------
    def note_round(self, agent_id: int, round_idx: int) -> None:
        prev = self.progress.get(agent_id, -1)
        if round_idx > prev:
            self.progress[agent_id] = round_idx

    def version_vector(self) -> tuple:
        """Sorted (agent_id, round_idx) pairs — the stamp for outgoing
        records."""
        return tuple(sorted(self.progress.items()))

    # -- bounded tables ------------------------------------------------------
    def _track(self, table: dict, key: str, value) -> None:
        if len(table) >= self.max_tracked:
            self.n_dropped_tracked += 1
            return
        table[key] = value

    def _sample(self, samples: list[float], value: float) -> None:
        if len(samples) >= self.max_tracked:
            self.n_dropped_tracked += 1
            return
        samples.append(value)

    # -- pushes --------------------------------------------------------------
    def note_erb_push(self, agent_id: int, erb, t: float) -> None:
        self.n_erb_pushes += 1
        self.note_round(agent_id, erb.meta.round_idx)
        if erb.meta.erb_id not in self._erb_born:
            self._track(self._erb_born, erb.meta.erb_id, (agent_id, float(t)))

    def note_snapshot_push(self, agent_id: int, snap, t: float) -> None:
        self.n_snap_pushes += 1
        self.note_round(agent_id, snap.round_idx)
        if snap.snap_id not in self._snap_born:
            self._track(self._snap_born, snap.snap_id, (agent_id, float(t)))

    # -- consumption ---------------------------------------------------------
    def note_erb_consumed(self, agent_id: int, records, t: float) -> None:
        """Incoming ERBs at round start: first *remote* consumption of a
        tracked record yields one creation->consumption latency sample."""
        tel = self.telemetry
        for erb in records:
            born = self._erb_born.get(erb.meta.erb_id)
            if born is None or erb.meta.erb_id in self._erb_consumed:
                continue
            src, t0 = born
            if src == agent_id:
                continue
            self._erb_consumed.add(erb.meta.erb_id)
            lat = max(0.0, float(t) - t0)
            self._sample(self.erb_latencies, lat)
            tel.observe("propagation.erb_latency_s", lat)

    def note_mix(
        self, agent_id: int, snaps, alphas, now: float, clock: str
    ) -> None:
        """One ``mix_params`` call: staleness distribution + per-source
        influence, exactly as the mix weighted them."""
        if not snaps:
            return
        tel = self.telemetry
        self.n_mixes += 1
        label = str(agent_id)
        for snap, alpha in zip(snaps, alphas, strict=True):
            self.n_mixed_snaps += 1
            tau = snap.round_idx if clock == "round" else snap.sim_time
            stale = max(0.0, float(now) - float(tau))
            self._sample(self.staleness_samples, stale)
            tel.observe("mix.staleness", stale, agent=label)
            src = int(snap.agent_id)
            self.influence_by_source[src] = self.influence_by_source.get(
                src, 0.0
            ) + float(alpha)

    # -- gossip --------------------------------------------------------------
    def on_gossip_deliver(self, dst: int, rec, plane_name: str, t: float) -> None:
        """Hook for ``GossipTopology.on_deliver`` — one successful
        anti-entropy delivery; tracked records yield a coverage sample."""
        tel = self.telemetry
        self.n_gossip_deliveries += 1
        tel.count("propagation.gossip_deliveries", 1, plane=plane_name)
        rid = getattr(rec, "record_id", None)
        if rid is None:
            rid = rec.meta.erb_id
        born = self._snap_born.get(rid) or self._erb_born.get(rid)
        if born is not None:
            lat = max(0.0, float(t) - born[1])
            self._sample(self.gossip_latencies, lat)
            tel.observe("propagation.gossip_latency_s", lat)

    # -- report --------------------------------------------------------------
    def summary(self) -> dict[str, Any]:
        """The ``Report.extra["propagation"]`` document."""
        return {
            "version_vector": {str(a): r for a, r in sorted(self.progress.items())},
            "erb": {
                "n_pushed": self.n_erb_pushes,
                "n_tracked": len(self._erb_born),
                "n_consumed_remote": len(self._erb_consumed),
                "latency": _dist_summary(self.erb_latencies),
                "latency_ecdf": _ecdf_points(self.erb_latencies),
            },
            "mix": {
                "n_mixes": self.n_mixes,
                "n_snapshots": self.n_mixed_snaps,
                "staleness": _dist_summary(self.staleness_samples),
                "influence_by_source": {
                    str(a): v for a, v in sorted(self.influence_by_source.items())
                },
            },
            "gossip": {
                "n_deliveries": self.n_gossip_deliveries,
                "coverage": _dist_summary(self.gossip_latencies),
                "coverage_ecdf": _ecdf_points(self.gossip_latencies),
            },
            "n_dropped_tracked": self.n_dropped_tracked,
        }


__all__ = ["PropagationTracker"]
