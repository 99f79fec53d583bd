"""Train-while-serve publish path: snapshot fleet params as versions.

A :class:`ParamPublisher` sits between a *training*
:class:`~repro_torch.rl.fleet.FleetEngine` and a serving
:class:`~repro_torch.serve.service.LocalizationService`. ``publish()``
forces the engine's flush-on-read path (pending jobs train first, so a
snapshot never observes a half-applied round) and stamps the stacked
``[N, ...]`` parameter tree with a monotonically increasing version.  On
a sharded engine the snapshot is the shards' rows gathered onto the
mesh's first device, once a publish, and the service serves from there.
The service pulls ``latest`` between ticks and hot-swaps it into a free
slot of its version ring; in-flight requests keep the version they were
admitted on (FedAsync-style bounded staleness, applied to the inference
plane).  The engine updates its state functionally, so a published
version's tensors never change when the engine trains on.
"""

from __future__ import annotations

import time
from collections.abc import Callable
from dataclasses import dataclass

from repro_torch.optim.adamw import leaves
from repro_torch.rl.fleet import FleetEngine


@dataclass(frozen=True)
class ParamVersion:
    """One published snapshot of the fleet's stacked params."""

    version: int  # monotonic, starts at 0
    params: dict  # [N, ...] stacked parameter tree
    n_agents: int
    published_at: float  # wall clock (time.perf_counter)
    train_steps: int = 0  # engine steps trained when snapshotted


class ParamPublisher:
    """Versioned snapshots out of a live training engine.

    ``source`` is a :class:`FleetEngine` (the normal train-while-serve
    wiring) or any zero-argument callable returning a stacked
    ``[N, ...]`` dict of tensors (tests publish hand-built trees this
    way); ``n_agents`` is then read from the first leaf.
    """

    def __init__(self, source: FleetEngine | Callable[[], dict]):
        self._engine = source if isinstance(source, FleetEngine) else None
        self._fn = None if self._engine is not None else source
        self._latest: ParamVersion | None = None
        self._next_version = 0

    @property
    def latest(self) -> ParamVersion | None:
        """Most recently published version (None before first publish)."""
        return self._latest

    @property
    def version(self) -> int:
        """Version number of ``latest`` (-1 before first publish)."""
        return -1 if self._latest is None else self._latest.version

    def publish(self) -> ParamVersion:
        """Snapshot the source now and advance the version counter."""
        if self._engine is not None:
            params = self._engine.stacked_params()
            n_agents = self._engine.n_slots
            steps = self._engine.n_steps_trained
        else:
            params = self._fn()
            n_agents = int(leaves(params)[0].shape[0])
            steps = 0
        pv = ParamVersion(
            version=self._next_version,
            params=params,
            n_agents=n_agents,
            published_at=time.perf_counter(),
            train_steps=steps,
        )
        self._next_version += 1
        self._latest = pv
        return pv


__all__ = ["ParamPublisher", "ParamVersion"]
