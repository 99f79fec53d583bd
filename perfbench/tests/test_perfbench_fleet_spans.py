"""The fleet engine's host-loop spans as the fleet cell's traced run
reads them.  On the small fleet, with the program's ``Telemetry`` on the
engine as a traced run attaches it, the four readers give finite
numbers, the three shares of the window sum to at most 100, and
``syncs_per_step.fleet`` is the window's copies counted here (its
``fleet.sync`` spans and three an environment step of collection) over
its steps.  On a hand-made trace: self time less the nested flushes,
collection's own copies and the union of the others, a traced window
read to the flush boundary where the profiler was asked to start, and
nothing read from a program without the spans or a tracer that dropped
events."""

from __future__ import annotations

import math
from types import SimpleNamespace

import pytest
import torch
from conftest import SMALL

from perfbench.harness import bench, runner

CELL = "adfll-dqn.fleet_paper"
READERS = (
    "collect_share.fleet",
    "plan_share.fleet",
    "sync_wait_share.fleet",
    "syncs_per_step.fleet",
)


def _read(run, name):
    return bench.load_cell(CELL).metric_reader(name).read(run)


def test_readers_on_a_traced_small_fleet():
    cell = bench.load_cell(CELL)
    cell.config.update(SMALL[CELL]["config"])
    cell.traffic.update(SMALL[CELL]["traffic"])
    run = runner.Run(cell, 3000000123, 0.5, True, torch.device("cpu"))
    driver = cell.driver().Driver(run)
    driver.setup()
    driver.window(0.5)
    assert run.telemetry is driver.engine.telemetry
    assert run.telemetry.tracer.n_dropped == 0
    got = {name: _read(run, name) for name in (*READERS, "flush_share.fleet")}
    assert all(v is not None and math.isfinite(v) and v > 0 for v in got.values()), got
    shares = ("collect_share.fleet", "plan_share.fleet", "flush_share.fleet")
    assert sum(got[name] for name in shares) <= 100.0
    w = run.window
    lo, hi = w["tel_t0"], w["tel_t0"] + w["unprofiled_s"]
    ended = [
        e
        for e in run.telemetry.tracer.events
        if e["kind"] == "span" and lo < e["t1"] <= hi
    ]
    collects = [e for e in ended if e["name"] == "fleet.collect"]
    n_syncs = sum(1 for e in ended if e["name"] == "fleet.sync")
    # a collection of one part: obs and loc up, q-values down, a step
    n_syncs += sum(3 * c["args"]["env_steps"] for c in collects)
    assert got["syncs_per_step.fleet"] == n_syncs / w["units"]


def _span(name, i, t0, t1, parent=None, **args):
    return {"kind": "span", "name": name, "track": "fleet", "clock": "wall",
            "t0": t0, "t1": t1, "args": args, "id": i, "parent": parent}  # fmt: skip


def _fake_run(events, dropped=0, profiled=False):
    tracer = SimpleNamespace(
        events=events,
        n_dropped=dropped,
        spans=lambda name: [e for e in events if e["name"] == name],
    )
    # the window starts at perf_counter 100, wall 0; flush boundaries at
    # 4.5 and 8.5 s (4 agent steps), the profiler asked to start at the
    # second and started at 9 s, after its start-up
    log = [(104.5, 2, 0, [1]), (108.5, 4, 0, [1]), (110.0, 5, 0, [1])]
    window = {"tel_t0": 0.0, "unprofiled_s": 10.0, "units": 5, "t0": 100.0, "log": log}
    return SimpleNamespace(
        telemetry=SimpleNamespace(tracer=tracer),
        window=window,
        profile=SimpleNamespace(t0=109.0) if profiled else None,
    )


HAND_MADE = [
    _span("fleet.sync", 3, 2.2, 2.4, parent=2),
    _span("fleet.flush", 2, 2.0, 3.0, parent=1),  # forced inside collection
    _span("fleet.sync", 4, 4.0, 4.5, parent=1),
    _span("fleet.collect", 1, 1.0, 5.0, env_steps=2, syncs=6, sync_s=0.3),
    _span("fleet.flush", 6, 7.0, 7.5, parent=5),  # forced inside planning
    _span("fleet.plan", 5, 6.0, 8.0),
    _span("fleet.flush", 7, 9.0, 11.0),  # runs past the window's end
    _span("fleet.sync", 8, 10.5, 10.8, parent=7),  # ends past it
]


def test_readers_on_a_hand_made_trace():
    run = _fake_run(HAND_MADE)
    assert _read(run, "collect_share.fleet") == pytest.approx(30.0)  # (4 - 1) / 10
    assert _read(run, "plan_share.fleet") == pytest.approx(15.0)  # (2 - 0.5) / 10
    # collection's own 0.3 s, then 0.2 + 0.5 of spans
    assert _read(run, "sync_wait_share.fleet") == pytest.approx(10.0)
    assert _read(run, "syncs_per_step.fleet") == pytest.approx((6 + 2) / 5)
    assert _read(run, "flush_share.fleet") == pytest.approx(25.0)  # 1 + 0.5 + 1


def test_span_readers_stop_where_the_profiler_was_asked_to_start():
    """A traced window: the four read to the flush boundary at 8.5 s and
    its 4 agent steps, not the profiler's start-up after it."""
    run = _fake_run(HAND_MADE, profiled=True)
    assert _read(run, "collect_share.fleet") == pytest.approx(300 / 8.5)
    assert _read(run, "plan_share.fleet") == pytest.approx(150 / 8.5)
    assert _read(run, "sync_wait_share.fleet") == pytest.approx(100 / 8.5)
    assert _read(run, "syncs_per_step.fleet") == pytest.approx((6 + 2) / 4)
    # flush_share.fleet reads on to the profiler's start: 1 + 0.5 of 9 s
    run.window["unprofiled_s"] = 9.0
    assert _read(run, "flush_share.fleet") == pytest.approx(150 / 9)


@pytest.mark.parametrize("name", READERS)
def test_readers_read_nothing_without_the_spans(name):
    # the program before the spans: a flush span with no nesting fields
    old = [{k: v for k, v in HAND_MADE[6].items() if k not in ("id", "parent")}]
    assert _read(_fake_run(old), name) is None
    assert _read(_fake_run(HAND_MADE, dropped=1), name) is None
    untraced = SimpleNamespace(telemetry=None, window={"tel_t0": None}, profile=None)
    assert _read(untraced, name) is None
