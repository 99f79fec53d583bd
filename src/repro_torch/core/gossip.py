"""Link pricing and bandwidth accounting for the hub topology.

Two pieces of the reference's transport layer ride this slice:

* :class:`LinkModel` prices every message (fixed latency plus
  ``bytes / rate``), so simulated time reflects payload size;
* :class:`BandwidthMeter` accounts bytes-on-wire per plane.

The hub-less gossip overlay (peer samplers, anti-entropy, per-site
links) is a later slice of the port.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from repro_torch.telemetry import MetricsRegistry


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


class BandwidthMeter:
    """Bytes/messages that crossed a link, keyed by plane name.

    A view over ``comm.bytes`` / ``comm.msgs`` counter series in a
    private, always-enabled :class:`~repro_torch.telemetry.MetricsRegistry`,
    so the per-plane byte totals in a report never depend on telemetry.
    """

    def __init__(self):
        self._registry = MetricsRegistry()

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


__all__ = ["BandwidthMeter", "LinkModel"]
