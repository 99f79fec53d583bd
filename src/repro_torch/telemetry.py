"""The disabled telemetry bundle and the counter registry behind it.

The reference threads one telemetry bundle through the scheduler, the
system and the fleet engine; telemetry off (``NULL``) is the default
everywhere and never touches run state.  This slice carries only that
disabled bundle, with the calls the scheduler makes on it, plus the
counter registry that :class:`~repro_torch.core.gossip.BandwidthMeter`
reads.  Spans, exporters and dashboards are a later slice of the port.
"""

from __future__ import annotations

from typing import Any

SeriesKey = tuple[str, tuple[tuple[str, str], ...]]


def _series_key(name: str, labels: dict[str, Any]) -> SeriesKey:
    return name, tuple(sorted((k, str(v)) for k, v in labels.items()))


class MetricsRegistry:
    """Counter series keyed by name + label set."""

    def __init__(self):
        self._counters: dict[SeriesKey, float] = {}

    def count(self, name: str, value: float = 1.0, **labels) -> None:
        """Increment the counter series ``name{labels}`` by ``value``."""
        key = _series_key(name, labels)
        self._counters[key] = self._counters.get(key, 0.0) + value

    def counters_by_label(self, name: str, label: str) -> dict[str, float]:
        """``label value -> counter total`` over every series of ``name``."""
        out: dict[str, float] = {}
        for (n, labels), v in self._counters.items():
            if n != name:
                continue
            for k, lv in labels:
                if k == label:
                    out[lv] = out.get(lv, 0.0) + v
        return out


class Telemetry:
    """A telemetry bundle; only the disabled one exists in this slice.

    Every record method is a no-op, so call sites pay one method call.
    """

    enabled = False

    def instant(self, name, track, t, *, clock="sim", **args) -> None:
        pass

    def count(self, name: str, value: float = 1.0, **labels) -> None:
        pass


NULL = Telemetry()

__all__ = ["NULL", "MetricsRegistry", "Telemetry"]
