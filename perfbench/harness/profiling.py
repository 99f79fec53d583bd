"""The traced run: ``torch.profiler`` over a short steady part of the
window, reduced in memory to the device's busy time, its idle share,
device operations by name, and the idle gaps by what the host did.

The idle share is the arithmetic of ``device_summary`` in
``src/repro_torch/experiments/profile.py`` (commit 9a6aff9): one minus
the device's busy seconds over the profiled wall seconds.  Here the busy
seconds are the union of the intervals in which an operation ran on the
device (kernels, copies and sets), so two overlapping operations count
once; where the trace holds no device intervals, it falls back to that
file's sum of self device time from ``key_averages``.

The profiler starts and stops only at the boundaries of whole units of
work (a flush, a train step, a decode step, a serving tick), each time
after a device synchronisation, so what it saw is whole units and the
device work they launched.  No trace file is written.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict
from dataclasses import dataclass, field

import torch

GAP_MIN_US = 5.0  # idle gaps shorter than this are launch jitter, not named


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


@dataclass
class Profile:
    """The reduction of one profiled span."""

    window_s: float
    busy_s: float
    units: float
    ops: dict[str, list[float]]  # device op name -> [count, seconds]
    idle_gaps: dict[str, float] = field(default_factory=dict)  # host op -> s
    t0: float = 0.0  # perf_counter at the start and the stop
    t1: float = 0.0

    @property
    def idle_share(self) -> float:
        return 1.0 - self.busy_s / self.window_s

    @property
    def n_ops(self) -> int:
        return int(sum(c for c, _ in self.ops.values()))

    def kernel(self, fragment: str) -> tuple[int, float]:
        """Launches and device seconds of the operations whose name holds
        ``fragment``."""
        n, s = 0, 0.0
        for name, (c, sec) in self.ops.items():
            if fragment in name:
                n, s = n + int(c), s + sec
        return n, s

    def breakdown(self) -> dict:
        top_ops = sorted(self.ops.items(), key=lambda kv: kv[1][1], reverse=True)
        gaps = sorted(self.idle_gaps.items(), key=lambda kv: kv[1], reverse=True)
        return {
            "device_ops": [[name[:120], sec] for name, (_, sec) in top_ops[:10]],
            "idle_gaps": [[name[:120], sec] for name, sec in gaps[:10]],
        }


def _is_device(e) -> bool:
    return getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA


def reduce_events(events, window_s: float, units: float) -> Profile:
    """``events``: the profiler's ``FunctionEvent`` list (times in us)."""
    dev = [e for e in events if _is_device(e)]
    host = [e for e in events if not _is_device(e)]
    ops: dict[str, list[float]] = defaultdict(lambda: [0, 0.0])
    spans = []
    for e in dev:
        t0, t1 = e.time_range.start, e.time_range.end
        ops[e.name][0] += 1
        ops[e.name][1] += (t1 - t0) / 1e6
        spans.append((t0, t1))
    spans.sort()
    merged: list[list[float]] = []
    for t0, t1 in spans:
        if merged and t0 <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t1)
        else:
            merged.append([t0, t1])
    busy_s = sum(t1 - t0 for t0, t1 in merged) / 1e6
    # idle gaps between device intervals, named by the innermost host
    # operation open at the gap's middle
    host.sort(key=lambda e: e.time_range.start)
    starts = [e.time_range.start for e in host]
    gaps: dict[str, float] = defaultdict(float)
    for (_, a1), (b0, _) in zip(merged, merged[1:]):
        if b0 - a1 < GAP_MIN_US:
            continue
        mid = 0.5 * (a1 + b0)
        name = "host (no operation)"
        i = bisect.bisect_right(starts, mid) - 1
        for j in range(i, max(-1, i - 5000), -1):
            if host[j].time_range.end >= mid:
                name = host[j].name
                break
        gaps[name] += (b0 - a1) / 1e6
    return Profile(window_s, busy_s, units, dict(ops), dict(gaps))


def _fallback(prof, window_s: float, units: float) -> Profile:
    """``device_summary``'s sum over ``key_averages`` (no intervals)."""
    ops = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total:
            ops[e.key] = [e.count, e.self_device_time_total / 1e6]
    busy = sum(s for _, s in ops.values())
    return Profile(window_s, busy, units, ops)


class WindowProfiler:
    """Profiles the last part of the window: it starts at the first unit
    boundary ``after_s`` seconds into the window and stops at the
    window's end, or earlier at the first boundary after ``max_units``
    units.  The trace is reduced only when it is read, after the window."""

    def __init__(self, enabled: bool, after_s: float, max_units: float):
        self.enabled = enabled
        self.after_s = after_s
        self.max_units = max_units
        self._prof = None
        self._raw = None
        self._t0 = self._u0 = None
        self._profile: Profile | None = None

    @property
    def started_at(self) -> float | None:
        """perf_counter at the profiler's start (None: not started)."""
        return self._t0

    @property
    def started_units(self) -> float | None:
        """The window's units done when the profiler started."""
        return self._u0

    def tick(self, elapsed_s: float, units: float, can_start: bool = True) -> None:
        """Called by the driver at each unit boundary with the window's
        elapsed seconds and the units done so far; ``can_start`` False
        where a span starting here would not hold ``max_units`` units."""
        if not self.enabled or self._raw is not None:
            return
        if self._prof is None:
            if elapsed_s >= self.after_s and can_start:
                _sync()
                self._prof = torch.profiler.profile(
                    activities=[
                        torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA,
                    ]
                )
                self._prof.__enter__()
                self._t0, self._u0 = time.perf_counter(), units
            return
        if units - self._u0 >= self.max_units:
            self.stop(units)

    def stop(self, units: float) -> None:
        if self._prof is None or self._raw is not None:
            return
        _sync()
        window_s = time.perf_counter() - self._t0
        self._prof.__exit__(None, None, None)
        self._raw = (self._prof, window_s, units - self._u0)
        self._prof = None

    @property
    def profile(self) -> Profile | None:
        if self._profile is None and self._raw is not None:
            prof, window_s, units = self._raw
            profile = reduce_events(prof.events(), window_s, units)
            if not profile.ops:
                profile = _fallback(prof, window_s, units)
            profile.t0, profile.t1 = self._t0, self._t0 + window_s
            self._profile = profile
            self._raw = (None, window_s, units)
        return self._profile
