"""Asynchronous event-driven scheduler.

Device programs are bulk-synchronous, so ADFLL's *asynchrony* lives here, at
the host control plane: a discrete-event simulator with heterogeneous
agent speeds (the paper's V100-vs-T4 deployment), hub sync timers,
gossip anti-entropy timers, agent churn (addition/deletion ablations),
population availability processes, and the paper's round policy — "when
an agent finishes training on a task, as long as there are new ERBs it
has not learned from, it starts a new round".

The *content* of a round (DQN training on real tensors) executes eagerly
when its event fires; only simulated time is virtual.

Every registration (``at`` / ``after`` / ``every``) returns a
:class:`Handle` whose ``cancel()`` works from *any* context — including
inside the event's own callback, which tag-based :meth:`Scheduler.cancel`
cannot reach (the periodic re-arm happens after the callback returns).
Availability processes lean on this to self-terminate.
"""

from __future__ import annotations

import heapq
import itertools
from collections import deque
from collections.abc import Callable
from dataclasses import dataclass, field

from repro_torch.telemetry import NULL, Telemetry

EventFn = Callable[["Scheduler", float], None]


class Handle:
    """Cancellation token for one scheduled event or periodic timer.

    ``cancel()`` is safe from any context: a cancelled event is skipped
    (not fired, not logged) when it reaches the head of the heap, and a
    periodic timer checks the flag both before firing and before
    re-arming — so a timer *can* cancel itself from inside its own
    callback, which tag-based cancellation cannot do.
    """

    __slots__ = ("cancelled",)

    def __init__(self):
        self.cancelled = False

    def cancel(self) -> None:
        self.cancelled = True

    @property
    def active(self) -> bool:
        return not self.cancelled


@dataclass(order=True)
class _Event:
    time: float
    seq: int
    fn: EventFn = field(compare=False)
    tag: str = field(compare=False, default="")
    handle: Handle | None = field(compare=False, default=None)


class Scheduler:
    """Deterministic discrete-event loop (ties broken by insertion order).

    ``log_max`` bounds the tagged-event log to a ring buffer keeping the
    *newest* entries (``log_dropped`` counts evictions) — opt in for
    long population runs, where logging every tagged event forever would
    grow host memory linearly with simulated time.

    With a :class:`~repro_torch.telemetry.Telemetry` bundle attached, every
    tagged event additionally lands as an instant on the ``scheduler``
    sim-clock track and increments the ``sched.events{tag=...}``
    counter; the ``log``/``log_dropped`` ring stays as-is, so existing
    consumers keep working unchanged.
    """

    def __init__(
        self,
        log_max: int | None = None,
        *,
        telemetry: Telemetry | None = None,
    ):
        self._heap: list[_Event] = []
        self._seq = itertools.count()
        self.now = 0.0
        self.log_max = log_max
        self.log = deque(maxlen=log_max) if log_max is not None else []
        self.log_dropped = 0
        self.telemetry = telemetry if telemetry is not None else NULL

    def at(self, time: float, fn: EventFn, tag: str = "") -> Handle:
        handle = Handle()
        heapq.heappush(self._heap, _Event(time, next(self._seq), fn, tag, handle))
        return handle

    def after(self, delay: float, fn: EventFn, tag: str = "") -> Handle:
        return self.at(self.now + delay, fn, tag)

    def every(
        self,
        period: float,
        fn: EventFn,
        tag: str = "",
        until: float | None = None,
        phase: float | None = None,
    ) -> Handle:
        """Periodic event; first firing after ``phase`` (default: one
        period), so co-periodic timers can be offset from each other.
        Every tick shares the returned :class:`Handle`: cancelling it —
        even from inside ``fn`` itself — stops the timer for good."""

        handle = Handle()

        def tick(sched: "Scheduler", t: float):
            fn(sched, t)
            if handle.cancelled:
                return
            if until is None or t + period <= until:
                sched._push(t + period, tick, tag, handle)

        first = period if phase is None else phase
        self._push(self.now + first, tick, tag, handle)
        return handle

    def _push(self, time: float, fn: EventFn, tag: str, handle: Handle) -> None:
        heapq.heappush(self._heap, _Event(time, next(self._seq), fn, tag, handle))

    def cancel(self, tag: str) -> None:
        """Drop every *pending* event carrying ``tag`` (shim over the
        handle machinery for call sites that did not keep a handle).

        Periodic timers stop because their next tick is removed before
        it can re-arm; the tag itself stays usable — re-registering an
        event under it later works.  A timer cannot cancel itself by tag
        from inside its own callback (the re-arm happens after the
        callback returns); use the :class:`Handle` returned by
        :meth:`every` for that."""
        if not tag:
            return
        self._heap = [e for e in self._heap if e.tag != tag]
        heapq.heapify(self._heap)

    def _log(self, tag: str) -> None:
        if self.log_max is not None and len(self.log) >= self.log_max:
            self.log_dropped += 1
        self.log.append((self.now, tag))
        if self.telemetry.enabled:
            self.telemetry.instant(tag, "scheduler", self.now)
            self.telemetry.count("sched.events", 1, tag=tag)

    def run(
        self,
        until: float = float("inf"),
        stop: Callable[[], bool] | None = None,
    ) -> float:
        while self._heap:
            ev = heapq.heappop(self._heap)
            if ev.handle is not None and ev.handle.cancelled:
                continue
            if ev.time > until:
                heapq.heappush(self._heap, ev)
                break
            self.now = ev.time
            if ev.tag:
                self._log(ev.tag)
            ev.fn(self, self.now)
            if stop is not None and stop():
                break
        return self.now


__all__ = ["EventFn", "Handle", "Scheduler"]
