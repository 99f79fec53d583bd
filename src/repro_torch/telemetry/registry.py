"""Metrics registry: counters, gauges, and histograms with label sets.

One :class:`MetricsRegistry` per run.  Instruments are identified by
``(name, sorted(labels))`` series keys, so the same metric name carries
any number of label combinations (``comm.bytes{plane=erb}`` next to
``comm.bytes{plane=weights}``) — bounded by ``max_series`` per metric:
telemetry is observe-only and must never take down a run, so a series
past the bound is *dropped and counted* (``n_dropped_series``), never
raised on.

The registry is deliberately dependency-free (stdlib only) and cheap:
one dict lookup and a float add per counter increment.  The disabled
path is :class:`NullRegistry`, whose methods are empty — call sites pay
one no-op method call, nothing else, which is what keeps the
telemetry-off contract (<2% overhead, bit-identical results) trivially
true: a disabled registry touches no state at all.
"""

from __future__ import annotations

from collections.abc import Iterator
from typing import Any

SeriesKey = tuple[str, tuple[tuple[str, str], ...]]

#: histogram bucket upper bounds double from 1; the last bucket is +inf
DEFAULT_BUCKETS = tuple(float(2**i) for i in range(0, 21)) + (float("inf"),)


def _series_key(name: str, labels: dict[str, Any]) -> SeriesKey:
    return name, tuple(sorted((k, str(v)) for k, v in labels.items()))


class _Histogram:
    """Fixed-boundary histogram: counts per bucket + sum + count."""

    __slots__ = ("bounds", "counts", "total", "n")

    def __init__(self, bounds: tuple[float, ...]):
        self.bounds = bounds
        self.counts = [0] * len(bounds)
        self.total = 0.0
        self.n = 0

    def observe(self, value: float) -> None:
        self.n += 1
        self.total += value
        for i, b in enumerate(self.bounds):
            if value <= b:
                self.counts[i] += 1
                return
        self.counts[-1] += 1  # defensive: last bound is +inf

    def summary(self) -> dict[str, Any]:
        return {
            "count": self.n,
            "sum": self.total,
            "mean": self.total / self.n if self.n else None,
            "buckets": {
                ("inf" if b == float("inf") else f"{b:g}"): c
                for b, c in zip(self.bounds, self.counts)
                if c
            },
        }


class MetricsRegistry:
    """Counters / gauges / histograms, keyed by name + label set."""

    enabled = True

    def __init__(
        self,
        *,
        max_series: int = 1024,
        buckets: tuple[float, ...] = DEFAULT_BUCKETS,
    ):
        self.max_series = int(max_series)
        self.buckets = buckets
        self._counters: dict[SeriesKey, float] = {}
        self._gauges: dict[SeriesKey, float] = {}
        self._hists: dict[SeriesKey, _Histogram] = {}
        self._per_metric: dict[str, int] = {}  # live series per metric name
        self.n_dropped_series = 0

    # -- series admission ----------------------------------------------------
    def _admit(self, key: SeriesKey, table: dict[SeriesKey, Any]) -> bool:
        if key in table:
            return True
        name = key[0]
        if self._per_metric.get(name, 0) >= self.max_series:
            self.n_dropped_series += 1
            return False
        self._per_metric[name] = self._per_metric.get(name, 0) + 1
        return True

    # -- instruments ---------------------------------------------------------
    def count(self, name: str, value: float = 1.0, **labels) -> None:
        """Increment the counter series ``name{labels}`` by ``value``."""
        key = _series_key(name, labels)
        cur = self._counters.get(key)
        if cur is not None:
            self._counters[key] = cur + value
        elif self._admit(key, self._counters):
            self._counters[key] = value

    def gauge(self, name: str, value: float, **labels) -> None:
        """Set the gauge series ``name{labels}`` to ``value``."""
        key = _series_key(name, labels)
        if key in self._gauges or self._admit(key, self._gauges):
            self._gauges[key] = value

    def observe(self, name: str, value: float, **labels) -> None:
        """Record one sample into the histogram series ``name{labels}``."""
        key = _series_key(name, labels)
        h = self._hists.get(key)
        if h is None:
            if not self._admit(key, self._hists):
                return
            h = self._hists[key] = _Histogram(self.buckets)
        h.observe(value)

    # -- reads ---------------------------------------------------------------
    def counter_value(self, name: str, **labels) -> float:
        return self._counters.get(_series_key(name, labels), 0.0)

    def gauge_value(self, name: str, **labels) -> float | None:
        return self._gauges.get(_series_key(name, labels))

    def histogram(self, name: str, **labels) -> dict[str, Any] | None:
        h = self._hists.get(_series_key(name, labels))
        return h.summary() if h is not None else None

    def counters_by_label(self, name: str, label: str) -> dict[str, float]:
        """``label value -> counter total`` over every series of ``name``
        (the view :class:`~repro_torch.core.gossip.BandwidthMeter` reads)."""
        out: dict[str, float] = {}
        for (n, labels), v in self._counters.items():
            if n != name:
                continue
            for k, lv in labels:
                if k == label:
                    out[lv] = out.get(lv, 0.0) + v
        return out

    @property
    def n_series(self) -> int:
        return len(self._counters) + len(self._gauges) + len(self._hists)

    # -- export --------------------------------------------------------------
    def rows(self) -> Iterator[dict[str, Any]]:
        """Flat JSON-able rows, one per series (the JSONL export shape)."""
        for (name, labels), v in sorted(self._counters.items()):
            yield {"kind": "counter", "name": name, "labels": dict(labels), "value": v}
        for (name, labels), v in sorted(self._gauges.items()):
            yield {"kind": "gauge", "name": name, "labels": dict(labels), "value": v}
        for (name, labels), h in sorted(self._hists.items()):
            yield {
                "kind": "histogram",
                "name": name,
                "labels": dict(labels),
                "value": h.summary(),
            }

    def summary(self) -> list[dict[str, Any]]:
        return list(self.rows())


class NullRegistry(MetricsRegistry):
    """The disabled registry: every write is a no-op, every read empty."""

    enabled = False

    def __init__(self):
        super().__init__(max_series=0)

    def count(self, name: str, value: float = 1.0, **labels) -> None:
        pass

    def gauge(self, name: str, value: float, **labels) -> None:
        pass

    def observe(self, name: str, value: float, **labels) -> None:
        pass


__all__ = [
    "DEFAULT_BUCKETS",
    "MetricsRegistry",
    "NullRegistry",
]
