"""Hub nodes: the homogeneous distributed shared database (Fig. 6/7).

Every agent talks only to its hub (bidirectional push/pull); hubs sync
their databases with each other periodically.  A hub carries one store
per :class:`~repro_torch.core.plane.SharePlane`, mapping record_id ->
record: the paper's ERB plane, and the weight plane when the system
shares weights.  Hub-hub sync accounts bytes-on-wire on the shared
:class:`~repro_torch.core.gossip.BandwidthMeter`; backbone transfer
*time* is not modeled (hubs are assumed to sit on fast interconnect).

Hub failure loses only records no other hub holds; agent failure loses
only that agent's untrained round (the paper's robustness claims, Table
2).  A dead hub admits nothing, serves nothing and takes no part in the
sync.
"""

from __future__ import annotations

from collections.abc import Sequence
from dataclasses import dataclass, field
from typing import Any

import numpy as np

from repro_torch.core.gossip import BandwidthMeter
from repro_torch.core.plane import SharePlane


@dataclass
class Hub:
    hub_id: int
    stores: dict[str, dict[str, Any]] = field(default_factory=dict)
    alive: bool = True

    def store(self, plane: str = "erb") -> dict[str, Any]:
        """The record_id -> record map for one plane (created on demand)."""
        return self.stores.setdefault(plane, {})

    @property
    def database(self) -> dict[str, Any]:
        """The ERB-plane store (the paper's 'distributed database')."""
        return self.store("erb")

    def push(self, item: Any, plane: SharePlane) -> bool:
        """Agent -> hub transfer of one record."""
        if not self.alive:
            return False
        return plane.admit(self.store(plane.name), item)

    def pull_unseen(self, seen: set[str], plane: str = "erb") -> list[Any]:
        """Hub -> agent: every record the agent has not yet consumed."""
        if not self.alive:
            return []
        return [v for k, v in sorted(self.store(plane).items()) if k not in seen]

    def snapshot(self) -> list[dict]:
        """Fig. 7 table: one row per ERB in the shared database."""
        return [
            {
                "erb_id": e.meta.erb_id,
                "modality": e.meta.task.modality,
                "landmark": e.meta.task.landmark,
                "pathology": e.meta.task.pathology,
                "source_agent": e.meta.source_agent,
                "size": e.meta.size,
            }
            for _, e in sorted(self.database.items())
        ]

    def fail(self) -> None:
        """The hub dies: every record it held is lost."""
        self.alive = False
        self.stores.clear()


def sync_hubs(
    hubs: Sequence[Hub],
    rng: np.random.Generator,
    dropout: float,
    planes: Sequence[SharePlane],
    meter: BandwidthMeter,
) -> int:
    """Periodic pairwise database sync over every registered plane.

    Each (record, dest-hub) transfer independently drops with probability
    ``dropout`` (the 75% ablation).  Delivered transfers are accounted on
    ``meter``.  Only live hubs take part.  Returns the number of records
    transferred."""
    live = [h for h in hubs if h.alive]
    transferred = 0
    for plane in planes:
        for src in live:
            for dst in live:
                if src is dst:
                    continue
                dst_store = dst.store(plane.name)
                for rid, rec in sorted(src.store(plane.name).items()):
                    if rid in dst_store:
                        continue
                    if dropout > 0.0 and rng.random() < dropout:
                        continue
                    if plane.admit(dst_store, rec):
                        transferred += 1
                        meter.account(plane.name, plane.payload_nbytes(rec))
    return transferred


__all__ = ["Hub", "sync_hubs"]
