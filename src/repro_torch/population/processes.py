"""Availability processes: pure segment generators plus the scheduler
process that toggles one agent online/offline.

The split keeps determinism testable without a system: given the same
availability spec, rng stream, and member index,
:func:`availability_segments` yields a bit-identical timeline — the
scheduler-side walker (:class:`AvailabilityProcess`) only walks it.
"""

from __future__ import annotations

import math
from collections.abc import Callable, Iterator

import numpy as np

from repro_torch.core.scheduler import Handle, Scheduler
from repro_torch.population.spec import Availability, Diurnal, Sessions, Trace

Segment = tuple[float, float]  # (duration, online) with online in {0.0, 1.0}


def availability_segments(
    avail: Availability,
    rng: np.random.Generator,
    member_idx: int = 0,
) -> Iterator[tuple[float, bool]]:
    """Yield ``(duration, online)`` segments from the agent's join time.

    The generator is infinite for cyclic processes; a *finite* generator
    means the agent is online forever afterwards (a finite trace is the
    disturbed prefix of a run — a permanently-offline tail would
    deadlock the round policy).
    """
    if isinstance(avail, Diurnal):
        yield from _diurnal_segments(avail, rng)
    elif isinstance(avail, Sessions):
        yield from _session_segments(avail, rng)
    elif isinstance(avail, Trace):
        yield from _trace_segments(avail, member_idx)
    else:  # pragma: no cover - spec.Availability is a closed union
        raise TypeError(f"unknown availability process: {avail!r}")


def _diurnal_segments(avail: Diurnal, rng: np.random.Generator):
    period = avail.period
    on_len = avail.on_fraction * period
    off_len = period - on_len
    if off_len <= 0.0:
        return  # on_fraction == 1: always online
    p = (avail.phase + avail.jitter * period * float(rng.uniform())) % period
    if p < on_len:
        # p into the on-window: finish it, then the off-window, then cycle
        yield on_len - p, True
        yield off_len, False
    else:
        yield period - p, False
    while True:
        yield on_len, True
        yield off_len, False


def _session_segments(avail: Sessions, rng: np.random.Generator):
    if avail.distribution == "lognormal":
        # parameterize so the draw's *mean* is the configured mean
        def draw(mean: float) -> float:
            mu = math.log(mean) - 0.5 * avail.sigma**2
            return float(rng.lognormal(mu, avail.sigma))

    elif avail.distribution == "exp":

        def draw(mean: float) -> float:
            return float(rng.exponential(mean))

    else:  # fixed

        def draw(mean: float) -> float:
            return mean

    while True:
        yield draw(avail.mean_on), True
        yield draw(avail.mean_off), False


def _trace_segments(avail: Trace, member_idx: int):
    if not avail.windows:
        return  # empty trace: always online
    shift = member_idx * avail.stagger
    t = 0.0
    tile = 0
    while True:
        base = shift + (0.0 if avail.repeat is None else tile * avail.repeat)
        for on, off in avail.windows:
            on_t, off_t = on + base, off + base
            if on_t > t:
                yield on_t - t, False
            yield off_t - max(on_t, t), True
            t = off_t
        if avail.repeat is None:
            return  # online after the last window, forever
        tile += 1


class AvailabilityProcess:
    """Walks one agent's segment stream on the scheduler.

    Each state change is one scheduled event (cheap even for long runs);
    ``stop()`` — called when the agent departs — cancels the pending
    toggle through its :class:`~repro_torch.core.scheduler.Handle`, which is
    safe even from inside the toggle's own callback.
    """

    def __init__(
        self,
        sched: Scheduler,
        agent_id: int,
        segments: Iterator[tuple[float, bool]],
        set_online: Callable[[int, bool], None],
        tag: str = "",
    ):
        self.sched = sched
        self.agent_id = agent_id
        self._segments = segments
        self._set_online = set_online
        self._tag = tag or f"A{agent_id}_avail"
        self._handle: Handle | None = None
        self.stopped = False

    def start(self) -> None:
        """Apply the first segment's state now and arm the next toggle."""
        self._advance(self.sched, self.sched.now)

    def stop(self) -> None:
        self.stopped = True
        if self._handle is not None:
            self._handle.cancel()

    def _advance(self, sched: Scheduler, t: float) -> None:
        if self.stopped:
            return
        seg = next(self._segments, None)
        if seg is None:
            # finite stream exhausted: online for good
            self._set_online(self.agent_id, True)
            return
        duration, online = seg
        self._set_online(self.agent_id, bool(online))
        self._handle = sched.at(t + duration, self._advance, tag=self._tag)


__all__ = ["AvailabilityProcess", "availability_segments"]
