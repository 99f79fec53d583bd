"""Serving-side run accounting: per-request latencies, queue depth,
ticks, swaps (a copy of the reference's ``repro/serve/report.py``).

A :class:`ServeReport` is the inference-plane sibling of the training
:class:`~repro_torch.core.experiment.Report`: the service appends one
:class:`RequestRecord` per completed request and samples queue depth
every tick; ``summary()`` flattens everything into the reference's
flat metric dict.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import numpy as np


@dataclass
class RequestRecord:
    """One completed localization request."""

    request_id: int
    agent_id: int
    version: int  # param version the whole rollout ran on
    n_ticks: int  # service ticks spent in a batch slot
    latency_s: float  # submit -> completion wall time
    queued_s: float  # submit -> admission wall time
    final_loc: Any = None  # [3] int voxel location
    dist_err: float | None = None  # vs known landmark (synthetic only)


@dataclass
class ServeReport:
    """What ``LocalizationService.drain()`` returns."""

    requests: list[RequestRecord] = field(default_factory=list)
    n_ticks: int = 0
    wall_time_s: float = 0.0
    queue_depth: list[int] = field(default_factory=list)  # sampled per tick
    batch_sizes: list[int] = field(default_factory=list)  # bucket per tick
    n_swaps: int = 0  # param versions hot-swapped in
    n_deferred_swaps: int = 0  # installs blocked by in-flight requests
    n_stall_ticks: int = 0  # admission paused by the staleness bound
    versions_served: dict[int, int] = field(default_factory=dict)
    act_traces_start: int = 0  # act program's new-shape counter before serving
    act_traces_end: int = 0  # ... and after (equal => no recompiles)

    @property
    def n_requests(self) -> int:
        return len(self.requests)

    @property
    def recompiles(self) -> int:
        """New act shapes dispatched while serving (0 after warmup)."""
        return self.act_traces_end - self.act_traces_start

    def _latencies_ms(self) -> np.ndarray:
        return np.array([r.latency_s * 1e3 for r in self.requests], np.float64)

    def percentile_ms(self, q: float) -> float:
        lat = self._latencies_ms()
        return float(np.percentile(lat, q)) if len(lat) else float("nan")

    def summary(self) -> dict[str, Any]:
        """Flat JSON-able metrics (the ``--json`` payload's ``fleet`` entry)."""
        lat = self._latencies_ms()
        ticks = np.array([r.n_ticks for r in self.requests], np.float64)
        errs = [r.dist_err for r in self.requests if r.dist_err is not None]
        rps = self.n_requests / self.wall_time_s if self.wall_time_s else 0.0
        return {
            "n_requests": self.n_requests,
            "requests_per_sec": rps,
            "p50_latency_ms": float(np.percentile(lat, 50)) if len(lat) else None,
            "p99_latency_ms": float(np.percentile(lat, 99)) if len(lat) else None,
            "mean_latency_ms": float(lat.mean()) if len(lat) else None,
            "ticks_per_request": float(ticks.mean()) if len(ticks) else None,
            "n_ticks": self.n_ticks,
            "mean_queue_depth": (
                float(np.mean(self.queue_depth)) if self.queue_depth else 0.0
            ),
            "max_queue_depth": max(self.queue_depth, default=0),
            "n_swaps": self.n_swaps,
            "n_deferred_swaps": self.n_deferred_swaps,
            "n_stall_ticks": self.n_stall_ticks,
            "versions_served": {str(k): v for k, v in self.versions_served.items()},
            "recompiles": self.recompiles,
            "mean_dist_err": float(np.mean(errs)) if errs else None,
            "wall_time_s": self.wall_time_s,
        }


__all__ = ["RequestRecord", "ServeReport"]
