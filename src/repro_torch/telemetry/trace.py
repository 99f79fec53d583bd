"""Structured span tracing over simulated and host clocks.

A :class:`Tracer` records a flat list of events.  Every event carries a
``clock`` field naming which timeline it lives on:

- ``"sim"``   — simulated scheduler seconds (:class:`repro_torch.core.scheduler.
  Scheduler` time).  Round phases, gossip exchanges, availability windows.
- ``"wall"``  — host ``perf_counter`` seconds from the tracer's zero.
  Fleet collection, replay planning, flushes and blocking copies, serve
  ticks — things that cost real time regardless of the simulated clock.

Every wall span carries an ``id`` and the ``id`` of its ``parent``: the
innermost wall span still open on the same thread when it started (None
at the top).  :meth:`Tracer.wall_span` opens its span where its body
starts, so spans recorded inside it nest under it; a span recorded
whole (``span(..., clock="wall")``) nests under the span open when it is
recorded.  A layer's self time is its span less the children it covers.

The tracer's ``anchor`` pairs its wall zero with the same instant on the
clock ``torch.profiler`` stamps its events with (Unix-epoch nanoseconds:
``time.time_ns()``, the domain of ``kineto_results.trace_start_ns()``),
so :meth:`Tracer.to_profiler_us` lays any wall span on a profiler's
event timeline.

Event kinds mirror the Chrome ``trace_event`` phases they export to:

- ``span``    — a complete event (``ph: "X"``): name, track, t0, t1.
- ``instant`` — a point event (``ph: "i"``).
- ``counter`` — a sampled counter value (``ph: "C"``).

``track`` is a free-form string ("agent3", "gossip", "fleet", "serve")
that becomes a Perfetto thread row; sim-clock and wall-clock tracks are
grouped into separate Perfetto processes so the two timelines never
visually interleave.

The :class:`Telemetry` bundle ties one tracer to one
:class:`~repro_torch.telemetry.registry.MetricsRegistry` and is the single
object threaded through the system ctors.  ``NULL`` is the shared
disabled bundle: every record method is a no-op and ``enabled`` is
False, so instrumented call sites can guard hot paths with one
attribute check and pay nothing when telemetry is off.
"""

from __future__ import annotations

import itertools
import json
import threading
import time
from collections.abc import Iterator
from contextlib import contextmanager, nullcontext
from pathlib import Path
from typing import Any

from .registry import MetricsRegistry, NullRegistry

#: default byte cap for streaming JSONL sinks (64 MiB)
DEFAULT_STREAM_MAX_BYTES = 64 * 1024 * 1024

#: what an instrumented call site enters when telemetry is off:
#: ``with tel.wall_span(...) if tel.enabled else NO_SPAN:``
NO_SPAN = nullcontext()


_ANCHOR_TRIES = 5  # clock brackets clock_anchor reads, keeping the tightest


def clock_anchor() -> dict[str, float | int]:
    """One instant on the host's ``perf_counter`` (seconds) and on the
    torch profiler's event clock (``time.time_ns()``, Unix-epoch ns):
    the profiler clock is read between two ``perf_counter`` reads and
    paired with their midpoint, from the tightest of ``_ANCHOR_TRIES``
    brackets (a thread preempted inside one would skew it)."""
    best = None
    for _ in range(_ANCHOR_TRIES):
        p0 = time.perf_counter()
        unix_ns = time.time_ns()
        p1 = time.perf_counter()
        if best is None or p1 - p0 < best[0]:
            best = (p1 - p0, 0.5 * (p0 + p1), unix_ns)
    return {"perf_counter_s": best[1], "unix_ns": best[2]}


class JsonlTraceSink:
    """Size-capped streaming JSONL writer for long soaks.

    Events are written through to disk as they are emitted instead of
    accumulating in the tracer's in-memory list, so a multi-hour soak
    has O(1) memory for tracing.  The file is the same
    ``repro.telemetry/v1`` JSONL layout ``load_trace`` reads back:
    header row first (with ``anchor``, the tracer's
    :func:`clock_anchor`), one event per line, metric rows appended at
    :meth:`close`.

    ``max_bytes`` caps the event portion of the file; past the cap,
    events are dropped and tallied (``n_dropped``) — the registry rows
    at close are small (bounded series cardinality) and always written,
    so the capped file still carries the final ``trace.dropped``
    counter.
    """

    def __init__(
        self,
        path: str | Path,
        *,
        anchor: dict,
        max_bytes: int = DEFAULT_STREAM_MAX_BYTES,
    ):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.max_bytes = int(max_bytes)
        self.n_written = 0
        self.n_dropped = 0
        self._f = self.path.open("w")
        header = {
            "kind": "header",
            "format": "repro.telemetry/v1",
            "streaming": True,
            "clock_anchor": anchor,
        }
        line = json.dumps(header) + "\n"
        self._f.write(line)
        self._nbytes = len(line)

    def write(self, ev: dict[str, Any]) -> bool:
        """Stream one event row; False once closed or past the byte cap."""
        if self._f.closed:
            return False
        line = json.dumps(ev) + "\n"
        if self._nbytes + len(line) > self.max_bytes:
            self.n_dropped += 1
            return False
        self._f.write(line)
        self._nbytes += len(line)
        self.n_written += 1
        return True

    def write_metric_row(self, row: dict[str, Any]) -> None:
        """Append a registry row (exempt from the event byte cap)."""
        if self._f.closed:
            return
        self._f.write(json.dumps({**row, "kind": f"metric.{row['kind']}"}) + "\n")

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()


class Tracer:
    """Append-only event buffer with a bounded size.

    ``max_events`` bounds memory: once full, new events are dropped and
    tallied in ``n_dropped`` (telemetry never takes down a run).

    With a ``sink`` (see :class:`JsonlTraceSink`), events stream to disk
    instead of accumulating in ``events`` — memory stays O(1) and the
    sink's byte cap replaces ``max_events`` as the bound; sink-refused
    events are tallied in the same ``n_dropped``.

    ``anchor`` (:func:`clock_anchor`, taken at creation) holds the wall
    clock's zero on both clocks.
    """

    enabled = True

    def __init__(
        self, *, max_events: int = 200_000, sink: JsonlTraceSink | None = None
    ):
        self.max_events = int(max_events)
        self.events: list[dict[str, Any]] = []
        self.n_dropped = 0
        self.sink = sink
        self.anchor = clock_anchor()
        self._wall0 = self.anchor["perf_counter_s"]
        self._ids = itertools.count(1)  # next() is atomic across threads
        self._local = threading.local()  # .open: ids of open wall spans

    # -- clocks --------------------------------------------------------------
    def wall(self) -> float:
        """Host seconds since tracer creation (zero-based wall clock)."""
        return time.perf_counter() - self._wall0

    def to_wall(self, perf_t: float) -> float:
        """Rebase an absolute ``time.perf_counter()`` stamp onto the
        tracer's zero-based wall clock (for call sites that already hold
        perf_counter timestamps, e.g. the serve request plane)."""
        return perf_t - self._wall0

    def to_profiler_us(self, t_wall: float, trace_start_ns: int) -> float:
        """A wall-clock time in the microseconds of a torch profiler's
        event timeline (``FunctionEvent.time_range``), whose zero is the
        profiler's ``kineto_results.trace_start_ns()``."""
        return (self.anchor["unix_ns"] - trace_start_ns) / 1e3 + t_wall * 1e6

    # -- wall-span nesting ---------------------------------------------------
    def _open_spans(self) -> list[int]:
        """This thread's open wall spans' ids, innermost last."""
        stack = getattr(self._local, "open", None)
        if stack is None:
            stack = self._local.open = []
        return stack

    # -- record --------------------------------------------------------------
    def _emit(self, ev: dict[str, Any]) -> None:
        if self.sink is not None:
            if not self.sink.write(ev):
                self.n_dropped += 1
            return
        if len(self.events) >= self.max_events:
            self.n_dropped += 1
            return
        self.events.append(ev)

    def span(
        self,
        name: str,
        track: str,
        t0: float,
        t1: float,
        *,
        clock: str = "sim",
        **args,
    ) -> None:
        """Record a complete span ``[t0, t1]`` on ``track``; on the wall
        clock it nests under the innermost wall span open now."""
        ev = {
            "kind": "span",
            "name": name,
            "track": track,
            "clock": clock,
            "t0": float(t0),
            "t1": float(t1),
            "args": args,
        }
        if clock == "wall":
            stack = self._open_spans()
            ev["id"] = next(self._ids)
            ev["parent"] = stack[-1] if stack else None
        self._emit(ev)

    def instant(
        self, name: str, track: str, t: float, *, clock: str = "sim", **args
    ) -> None:
        """Record a point event at ``t`` on ``track``."""
        self._emit(
            {
                "kind": "instant",
                "name": name,
                "track": track,
                "clock": clock,
                "t0": float(t),
                "t1": float(t),
                "args": args,
            }
        )

    def counter(
        self, name: str, track: str, t: float, value: float, *, clock: str = "sim"
    ) -> None:
        """Record a sampled counter value at ``t`` (Perfetto ``ph: "C"``)."""
        self._emit(
            {
                "kind": "counter",
                "name": name,
                "track": track,
                "clock": clock,
                "t0": float(t),
                "t1": float(t),
                "args": {"value": float(value)},
            }
        )

    @contextmanager
    def wall_span(self, name: str, track: str, **args) -> Iterator[dict[str, Any]]:
        """Context manager recording a wall-clock span around its body.

        The span is open while the body runs, so wall spans started in
        it take it as their parent.  It yields the span's event: the body
        may add to its ``args``, and reads ``t0`` and ``t1`` once the
        block has closed."""
        stack = self._open_spans()
        ev = {
            "kind": "span",
            "name": name,
            "track": track,
            "clock": "wall",
            "t0": self.wall(),
            "t1": 0.0,
            "args": args,
            "id": next(self._ids),
            "parent": stack[-1] if stack else None,
        }
        stack.append(ev["id"])
        try:
            yield ev
        finally:
            ev["t1"] = self.wall()
            stack.pop()
            self._emit(ev)

    # -- reads ---------------------------------------------------------------
    def spans(self, name: str | None = None) -> list[dict[str, Any]]:
        return [
            e
            for e in self.events
            if e["kind"] == "span" and (name is None or e["name"] == name)
        ]

    def __len__(self) -> int:
        return len(self.events)


class NullTracer(Tracer):
    """Disabled tracer: records nothing, yields immediately."""

    enabled = False

    def __init__(self):
        super().__init__(max_events=0)

    def _emit(self, ev: dict[str, Any]) -> None:
        pass

    def span(self, name, track, t0, t1, *, clock="sim", **args) -> None:
        pass

    def instant(self, name, track, t, *, clock="sim", **args) -> None:
        pass

    def counter(self, name, track, t, value, *, clock="sim") -> None:
        pass

    @contextmanager
    def wall_span(self, name: str, track: str, **args) -> Iterator[None]:
        yield


class Telemetry:
    """One tracer + one metrics registry, threaded through system ctors.

    ``Telemetry(enabled=False)`` (or the shared ``NULL`` singleton) is
    the no-op bundle; call sites may check ``tel.enabled`` to skip even
    argument construction on hot paths.
    """

    def __init__(
        self,
        *,
        enabled: bool = True,
        max_events: int = 200_000,
        max_series: int = 1024,
        stream_path: str | Path | None = None,
        stream_max_bytes: int = DEFAULT_STREAM_MAX_BYTES,
    ):
        self.enabled = bool(enabled)
        self.sink: JsonlTraceSink | None = None
        if self.enabled:
            self.tracer: Tracer = Tracer(max_events=max_events)
            if stream_path is not None:
                self.sink = self.tracer.sink = JsonlTraceSink(
                    stream_path, max_bytes=stream_max_bytes, anchor=self.tracer.anchor
                )
            self.registry: MetricsRegistry = MetricsRegistry(max_series=max_series)
        else:
            self.tracer = NullTracer()
            self.registry = NullRegistry()

    # convenience passthroughs so call sites read `tel.span(...)`
    def span(self, name, track, t0, t1, *, clock="sim", **args) -> None:
        self.tracer.span(name, track, t0, t1, clock=clock, **args)

    def instant(self, name, track, t, *, clock="sim", **args) -> None:
        self.tracer.instant(name, track, t, clock=clock, **args)

    def counter(self, name, track, t, value, *, clock="sim") -> None:
        self.tracer.counter(name, track, t, value, clock=clock)

    def count(self, name: str, value: float = 1.0, **labels) -> None:
        self.registry.count(name, value, **labels)

    def observe(self, name: str, value: float, **labels) -> None:
        self.registry.observe(name, value, **labels)

    def gauge(self, name: str, value: float, **labels) -> None:
        self.registry.gauge(name, value, **labels)

    def wall_span(self, name: str, track: str, **args):
        return self.tracer.wall_span(name, track, **args)

    def wall(self) -> float:
        return self.tracer.wall()

    def to_wall(self, perf_t: float) -> float:
        return self.tracer.to_wall(perf_t)

    def summary(self) -> dict[str, Any]:
        """Compact digest: event counts by name plus metric rows."""
        by_name: dict[str, int] = {}
        for e in self.tracer.events:
            key = f"{e['kind']}:{e['name']}"
            by_name[key] = by_name.get(key, 0) + 1
        out = {
            "n_events": len(self.tracer.events),
            "n_dropped_events": self.tracer.n_dropped,
            "events_by_name": dict(sorted(by_name.items())),
            "metrics": self.registry.summary(),
        }
        if self.sink is not None:
            out["n_streamed_events"] = self.sink.n_written
            out["stream_path"] = str(self.sink.path)
        return out

    def close(self) -> None:
        """Finalize the streaming sink (no-op without one).

        Records the final ``trace.dropped`` counter, appends every
        registry row to the JSONL file (so the on-disk trace is a
        complete ``load_trace``-compatible document), and closes the
        file.  Safe to call more than once.
        """
        if self.sink is None or self.sink._f.closed:
            return
        self.registry.count("trace.dropped", float(self.tracer.n_dropped))
        for row in self.registry.rows():
            self.sink.write_metric_row(row)
        self.sink.close()


#: shared disabled bundle — the default at every instrumented call site
NULL = Telemetry(enabled=False)


__all__ = [
    "DEFAULT_STREAM_MAX_BYTES",
    "NO_SPAN",
    "NULL",
    "JsonlTraceSink",
    "NullTracer",
    "Telemetry",
    "Tracer",
]
