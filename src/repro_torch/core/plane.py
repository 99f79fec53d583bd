"""Sharing planes — the data planes federated through the hubs.

The paper federates exactly one artifact: experience replay buffers
(:class:`~repro_torch.core.erb.ERB`).  A :class:`SharePlane` gives a
record type its identity, hub-side admission and wire size;
:class:`ERBPlane` is the paper's plane.  The weight planes of the
reference (FedAsync-style mixing, compressed snapshots, with their
retention and wire encoding) are a later slice of the port.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from repro_torch.core.erb import ERB


class SharePlane:
    """One federated data plane: record identity + hub-side admission.

    A plane never talks to the network itself; the network and
    ``sync_hubs`` consult it when inserting records into a per-plane
    store (``dict[record_id, record]``) and when pricing them for
    bandwidth accounting.
    """

    name: str = "base"

    def key(self, item: Any) -> str:
        raise NotImplementedError

    def admit(self, store: dict[str, Any], item: Any) -> bool:
        """Insert ``item`` into a hub store. Returns True iff newly kept."""
        k = self.key(item)
        if k in store:
            return False
        store[k] = item
        return True

    def payload_nbytes(self, item: Any) -> int:
        """Approximate bytes-on-wire of one record (bandwidth accounting)."""
        raise NotImplementedError


class ERBPlane(SharePlane):
    """The paper's plane: experience replay buffers, kept forever."""

    name = "erb"

    def key(self, item: ERB) -> str:
        return item.meta.erb_id

    def payload_nbytes(self, item: ERB) -> int:
        return 64 + sum(np.asarray(v).nbytes for v in item.data.values())


__all__ = ["ERBPlane", "SharePlane"]
