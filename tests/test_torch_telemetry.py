"""The port's telemetry package against the reference's tests of it
(``tests/test_telemetry.py``): registry semantics and cardinality
bounds, the observe-only contract on the port's runner (disabled =
bit-identical runs, enabled = the same numbers plus a trace),
Perfetto/JSONL export round-trips and the ``python -m
repro_torch.telemetry`` CLI.  Added: the two packages' trace files are
one format, so a trace written by either loads in the other and both
CLIs summarize it.  Added too: the wall spans' nesting (``id``,
``parent``) and the clock anchor that lays them on a torch profiler's
timeline, the fleet engine's host-loop spans (``fleet.collect``,
``fleet.plan``, ``fleet.flush``, ``fleet.sync``), and
``experiments/profile.py``'s ``idle_by_span``.
"""

import json
import threading
import types

import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: these sizes gain nothing from more, and spinning
# OpenMP threads in parallel test workers would starve the other tests
torch.set_num_threads(1)
pytest.importorskip("jax")

import repro.core  # noqa: E402, F401  (the reference's own import order)
import repro.telemetry as jax_telemetry  # noqa: E402
from repro.telemetry.__main__ import main as jax_tel_main  # noqa: E402
from repro_torch.configs.adfll_dqn import ADFLLConfig, DQNConfig  # noqa: E402
from repro_torch.core.erb import erb_init  # noqa: E402
from repro_torch.core.federated import env_for  # noqa: E402
from repro_torch.experiments import ScenarioSpec  # noqa: E402
from repro_torch.experiments.profile import idle_by_span  # noqa: E402
from repro_torch.experiments.runner import build, run  # noqa: E402
from repro_torch.rl.fleet import collect_fleet  # noqa: E402
from repro_torch.telemetry import (  # noqa: E402
    NO_SPAN,
    NULL,
    MetricsRegistry,
    Telemetry,
    load_trace,
    to_perfetto,
    write_trace,
)
from repro_torch.telemetry.__main__ import main as tel_main  # noqa: E402

# tests/test_telemetry.py's tiny widths
TINY_DQN = DQNConfig(
    volume_shape=(12, 12, 12),
    box_size=(4, 4, 4),
    conv_features=(2,),
    hidden=(8,),
    batch_size=4,
    max_episode_steps=4,
    eps_decay_steps=20,
)
TINY_SYS = ADFLLConfig(
    n_agents=2,
    n_hubs=1,
    agent_hub=(0, 0),
    agent_speed=(1.0, 2.0),
    rounds=2,
    erb_capacity=128,
    erb_share_size=16,
    train_steps_per_round=2,
    hub_sync_period=0.5,
)


def _tiny_spec(**kw):
    base = dict(
        name="tiny",
        system="adfll",
        task_set="paper8",
        n_tasks=2,
        n_patients=8,
        dqn=TINY_DQN,
        sys=TINY_SYS,
        eval_patients=2,
        eval_episodes=2,
    )
    base.update(kw)
    return ScenarioSpec(**base)


# ---------------------------------------------------------------------------
# registry semantics
# ---------------------------------------------------------------------------
def test_counters_accumulate_per_label_set():
    reg = MetricsRegistry()
    reg.count("comm.bytes", 10, plane="erb")
    reg.count("comm.bytes", 5, plane="erb")
    reg.count("comm.bytes", 7, plane="weights")
    assert reg.counter_value("comm.bytes", plane="erb") == 15
    assert reg.counter_value("comm.bytes", plane="weights") == 7
    assert reg.counters_by_label("comm.bytes", "plane") == {
        "erb": 15,
        "weights": 7,
    }


def test_gauges_overwrite_and_histograms_aggregate():
    reg = MetricsRegistry()
    reg.gauge("queue.depth", 3)
    reg.gauge("queue.depth", 9)
    assert reg.gauge_value("queue.depth") == 9
    for v in (0.5, 1.5, 200.0):
        reg.observe("round.duration", v)
    h = reg.histogram("round.duration")
    assert h["count"] == 3
    assert h["sum"] == pytest.approx(202.0)
    assert sum(h["buckets"].values()) == 3


def test_label_cardinality_is_bounded_not_fatal():
    reg = MetricsRegistry(max_series=4)
    for i in range(20):
        reg.count("requests", 1, user=f"u{i}")
    # per-metric admission: at most max_series live series, the rest
    # counted as dropped — never an exception on the hot path
    assert reg.n_series == 4
    assert reg.n_dropped_series == 16
    assert reg.counter_value("requests", user="u0") == 1
    assert reg.counter_value("requests", user="u19") == 0


def test_null_bundle_is_inert():
    assert NULL.enabled is False
    NULL.count("x", 1)
    NULL.observe("y", 2.0)
    NULL.span("s", "track", 0.0, 1.0)
    NULL.instant("i", "track", 0.0)
    assert len(NULL.tracer) == 0
    assert NULL.summary()["n_events"] == 0
    assert list(NULL.registry.rows()) == []


def test_tracer_event_cap_drops_and_counts():
    tel = Telemetry(enabled=True, max_events=8)
    for i in range(20):
        tel.instant("tick", "t", float(i))
    assert len(tel.tracer) == 8
    assert tel.tracer.n_dropped == 12


# ---------------------------------------------------------------------------
# observe-only contract (the port's runner, on the CPU)
# ---------------------------------------------------------------------------
def _fingerprint(report):
    s = dict(report.summary())
    s.pop("extra", None)
    curve = [
        (p.t, p.mean_err, tuple(sorted(p.per_agent.items())))
        for p in report.eval_curve
    ]
    hist = [
        (r.agent_id, r.task, r.start, r.end, r.n_incoming, r.loss)
        for r in report.history
    ]
    return json.dumps(s, sort_keys=True, default=str), curve, hist


def test_disabled_telemetry_is_bit_identical():
    base = run(_tiny_spec(), device="cpu")
    off = run(_tiny_spec(), telemetry=Telemetry(enabled=False), device="cpu")
    assert _fingerprint(base) == _fingerprint(off)


def test_enabled_telemetry_is_observe_only_and_captures_spans():
    base = run(_tiny_spec(), device="cpu")
    tel = Telemetry(enabled=True)
    traced = run(_tiny_spec(), telemetry=tel, device="cpu")
    assert _fingerprint(base) == _fingerprint(traced)
    names = {e["name"] for e in tel.tracer.events}
    assert "round" in names
    assert traced.extra["telemetry"]["n_events"] == len(tel.tracer)
    # registry carries the same byte totals the report already reports
    erb = tel.registry.counter_value("comm.bytes", plane="erb")
    assert erb == traced.summary()["bytes_by_plane"].get("erb", 0)


# ---------------------------------------------------------------------------
# export round-trips
# ---------------------------------------------------------------------------
def _sample_bundle(telemetry=Telemetry):
    tel = telemetry(enabled=True)
    tel.span("round", "agent0", 0.0, 1.5, task="t1", round_idx=0)
    tel.span("round", "agent1", 0.5, 2.0, task="t2", round_idx=0)
    tel.span("fleet.flush", "fleet", 0.01, 0.02, clock="wall", jobs=2)
    tel.instant("hub_sync", "scheduler", 1.0)
    tel.count("comm.bytes", 1234, plane="erb")
    tel.observe("round.duration", 1.5)
    return tel


@pytest.mark.parametrize("suffix", [".json", ".jsonl"])
def test_trace_roundtrip(tmp_path, suffix):
    tel = _sample_bundle()
    path = tmp_path / f"trace{suffix}"
    write_trace(tel, path)
    doc = load_trace(path)
    spans = [e for e in doc["events"] if e["kind"] == "span"]
    instants = [e for e in doc["events"] if e["kind"] == "instant"]
    assert sorted(e["name"] for e in spans) == ["fleet.flush", "round", "round"]
    assert [e["name"] for e in instants] == ["hub_sync"]
    tracks = {e["track"] for e in doc["events"]}
    assert tracks == {"agent0", "agent1", "fleet", "scheduler"}
    counters = [m for m in doc["metrics"] if m["kind"] == "counter"]
    assert any(
        m["name"] == "comm.bytes" and m["value"] == 1234 for m in counters
    )


def test_perfetto_document_shape():
    doc = to_perfetto(_sample_bundle())
    events = doc["traceEvents"]
    # one metadata pair (process_name, thread_name) per track + the data
    assert {e["ph"] for e in events} <= {"X", "i", "M", "C"}
    complete = [e for e in events if e["ph"] == "X"]
    assert all(e["dur"] >= 0 and e["ts"] >= 0 for e in complete)
    # sim and wall clocks land in different synthetic processes
    pids = {e["pid"] for e in complete}
    assert len(pids) == 2


def test_sim_and_wall_spans_do_not_share_a_track():
    doc = to_perfetto(_sample_bundle())
    by_key = {}
    for e in doc["traceEvents"]:
        if e["ph"] == "X":
            by_key.setdefault((e["pid"], e["tid"]), set()).add(e["name"])
    for names in by_key.values():
        assert not ({"round", "fleet.flush"} <= names)


# ---------------------------------------------------------------------------
# one format on both sides
# ---------------------------------------------------------------------------
def _without_port_additions(doc: dict) -> dict:
    """A Perfetto document or one JSONL row less what the port's format
    adds to the reference's: the clock anchor, a wall span's nesting."""
    def strip(d: dict, keys: tuple[str, ...]) -> dict:
        return {k: v for k, v in d.items() if k not in keys}

    doc = strip(doc, ("clock_anchor", "id", "parent"))
    if "otherData" in doc:
        doc["otherData"] = strip(doc["otherData"], ("repro.clock_anchor",))
    if "traceEvents" in doc:
        doc["traceEvents"] = [
            {**e, "args": strip(e["args"], ("id", "parent"))} if e["ph"] == "X" else e
            for e in doc["traceEvents"]
        ]
    return doc


@pytest.mark.parametrize("suffix", [".json", ".jsonl"])
@pytest.mark.parametrize("writer", ["port", "reference"])
def test_trace_files_cross_load(tmp_path, suffix, writer, capsys):
    """A trace written by either package loads in both into the same
    events and metrics, the two Perfetto documents are byte for byte
    one file, and both CLIs summarize it."""
    port_path, ref_path = tmp_path / f"port{suffix}", tmp_path / f"ref{suffix}"
    write_trace(_sample_bundle(), port_path)
    jax_telemetry.write_trace(_sample_bundle(jax_telemetry.Telemetry), ref_path)
    path = port_path if writer == "port" else ref_path
    assert load_trace(path) == jax_telemetry.load_trace(path)
    # the wall-clock span's stamps are the writers' own numbers, so the
    # two files are identical (JSONL) and one document (Perfetto) once
    # the port's additions are taken out: the clock anchor and the wall
    # span's id and parent
    if suffix == ".json":
        port_doc = _without_port_additions(json.loads(port_path.read_text()))
        assert port_doc == json.loads(ref_path.read_text())
    else:
        rows = [json.loads(line) for line in port_path.read_text().splitlines()]
        port = "".join(json.dumps(_without_port_additions(r)) + "\n" for r in rows)
        assert port == ref_path.read_text()
    assert tel_main(["summarize", str(path)]) == 0
    ours = capsys.readouterr().out
    assert jax_tel_main(["summarize", str(path)]) == 0
    assert capsys.readouterr().out == ours
    assert "round" in ours and "comm.bytes" in ours


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------
def test_cli_summarize_export_diff(tmp_path, capsys):
    a = tmp_path / "a.json"
    b = tmp_path / "b.jsonl"
    write_trace(_sample_bundle(), a)
    assert tel_main(["summarize", str(a)]) == 0
    out = capsys.readouterr().out
    assert "round" in out and "comm.bytes" in out
    assert tel_main(["export", str(a), str(b)]) == 0
    assert b.exists()
    assert len(load_trace(b)["events"]) == len(load_trace(a)["events"])
    assert tel_main(["diff", str(a), str(b)]) == 0
    assert tel_main(["summarize", str(tmp_path / "missing.json")]) == 2


# ---------------------------------------------------------------------------
# nested wall spans and the profiler's clock
# ---------------------------------------------------------------------------
def _wall(tel, name=None):
    return [
        e
        for e in tel.tracer.events
        if e["kind"] == "span" and e["clock"] == "wall" and name in (None, e["name"])
    ]


def test_wall_spans_record_the_innermost_open_span_as_parent():
    tel = Telemetry()
    with tel.wall_span("outer", "fleet") as outer:
        with tel.wall_span("inner", "fleet", k=1) as inner:
            tel.span("whole", "fleet", tel.wall(), tel.wall(), clock="wall")
            inner["args"]["n"] = 2
        tel.span("round", "agent0", 0.0, 1.0)  # sim clock: no nesting fields
        seen = []
        worker = threading.Thread(
            target=lambda: seen.append(_open_elsewhere(tel)), daemon=True
        )
        worker.start()
        worker.join(timeout=10)
        assert not worker.is_alive()
    tel.span("after", "fleet", 0.0, 0.0, clock="wall")
    ev = {e["name"]: e for e in tel.tracer.events}
    assert ev["outer"]["parent"] is None
    assert ev["inner"]["parent"] == ev["outer"]["id"] == outer["id"]
    assert ev["whole"]["parent"] == ev["inner"]["id"]
    assert ev["after"]["parent"] is None
    assert seen == [None]  # another thread's spans nest on their own
    assert ev["inner"]["args"] == {"k": 1, "n": 2}
    assert "id" not in ev["round"] and "parent" not in ev["round"]
    assert len({e["id"] for e in _wall(tel)}) == len(_wall(tel)) == 5
    # a child's interval lies inside its parent's
    assert ev["outer"]["t0"] <= ev["inner"]["t0"] <= ev["whole"]["t0"]
    assert ev["whole"]["t1"] <= ev["inner"]["t1"] <= ev["outer"]["t1"]


def _open_elsewhere(tel):
    with tel.wall_span("thread", "worker"):
        pass
    return _wall(tel, "thread")[0]["parent"]


def test_wall_span_nesting_survives_export(tmp_path):
    tel = Telemetry()
    with tel.wall_span("fleet.collect", "fleet", agents=1):
        with tel.wall_span("fleet.sync", "fleet", dir="h2d", bytes=8):
            pass
    collect, sync = _wall(tel, "fleet.collect")[0], _wall(tel, "fleet.sync")[0]
    write_trace(tel, tmp_path / "t.jsonl")
    lines = (tmp_path / "t.jsonl").read_text().splitlines()
    assert json.loads(lines[0])["clock_anchor"] == tel.tracer.anchor
    back = {e["name"]: e for e in load_trace(tmp_path / "t.jsonl")["events"]}
    assert back["fleet.sync"]["parent"] == back["fleet.collect"]["id"] == collect["id"]
    doc = to_perfetto(tel)
    assert doc["otherData"]["repro.clock_anchor"] == tel.tracer.anchor
    args = {e["name"]: e["args"] for e in doc["traceEvents"] if e["ph"] == "X"}
    assert args["fleet.sync"] == {"dir": "h2d", "bytes": 8, **_ids(sync)}
    # the streaming sink's header carries the anchor too
    streamed = Telemetry(stream_path=tmp_path / "s.jsonl")
    streamed.close()
    header = json.loads((tmp_path / "s.jsonl").read_text().splitlines()[0])
    assert header["clock_anchor"] == streamed.tracer.anchor


def _ids(e):
    return {"id": e["id"], "parent": e["parent"]}


def test_disabled_bundle_records_no_span_and_holds_no_stack():
    with NULL.wall_span("fleet.collect", "fleet") as span:
        assert span is None
        NULL.span("fleet.flush", "fleet", 0.0, 1.0, clock="wall")
    with NO_SPAN as nothing:
        assert nothing is None
    assert len(NULL.tracer) == 0
    assert not vars(NULL.tracer._local)


def test_to_profiler_us_places_a_span_around_the_ops_it_ran():
    """The CPU profiler's events (its clock is the card's too) fall
    inside the wall span that ran them on the profiler's timeline."""
    tel = Telemetry()
    x = torch.ones(256, 256)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as p:
        with tel.wall_span("matmul", "test") as span:
            for _ in range(4):
                x = x @ x / 256.0
    start_ns = p.profiler.kineto_results.trace_start_ns()
    ops = [e for e in p.events() if e.name == "aten::mm"]
    assert len(ops) == 4
    lo = tel.tracer.to_profiler_us(span["t0"], start_ns)
    hi = tel.tracer.to_profiler_us(span["t1"], start_ns)
    assert lo - 50.0 <= min(e.time_range.start for e in ops)
    assert max(e.time_range.end for e in ops) <= hi + 50.0


# ---------------------------------------------------------------------------
# the fleet engine's host loop
# ---------------------------------------------------------------------------
def _traced_system():
    system = build(_tiny_spec(), device="cpu")
    tel = system.engine.telemetry = Telemetry()
    return system, tel


def test_flush_forced_inside_collection_nests_under_it():
    system, tel = _traced_system()
    agent, engine = system.agents[0], system.engine
    task = system.tasks[0]
    env = env_for(task, 0, TINY_DQN)
    first = erb_init(128, TINY_DQN.box_size, task=task, source_agent=0)
    collect_fleet([agent], [env], [first], 4)
    agent._submit_steps(2, first, ())  # pending: the next read flushes
    second = erb_init(128, TINY_DQN.box_size, task=task, source_agent=0)
    collect_fleet([agent], [env], [second], 4)
    assert engine.n_flushes == 1
    collects, plan = _wall(tel, "fleet.collect"), _wall(tel, "fleet.plan")
    flush = _wall(tel, "fleet.flush")
    assert [c["args"]["rows"] for c in collects] == [first.size, second.size]
    assert all(c["args"]["agents"] == 1 and c["args"]["env_steps"] for c in collects)
    assert plan[0]["parent"] is None and plan[0]["args"] == {"steps": 2}
    assert flush[0]["parent"] == collects[1]["id"]
    # the CPU never captures a chunk: every flush runs it eagerly
    assert flush[0]["args"] == {"jobs": 1, "k_steps": 2, "devices": 1, "graph": "eager"}
    # the flush's own copies nest under it, not under the collection
    under = [e for e in _wall(tel, "fleet.sync") if e["parent"] == flush[0]["id"]]
    assert [e["args"]["dir"] for e in under][-1] == "d2h"
    c = collects[1]
    assert c["t0"] <= flush[0]["t0"] and flush[0]["t1"] <= c["t1"]


def test_every_blocking_copy_of_the_fleet_is_a_sync_span():
    """On the tiny fleet: a collection counts its three copies an
    environment step (obs and loc up, q-values down) in its own args,
    and the cohort's gather index is a span under it; in a flush, spans
    of its index upload, its gather index where its jobs do not cover
    the rows in order, its ERB uploads (the cache's misses) and its one
    loss copy."""
    system, tel = _traced_system()
    engine = system.engine
    gathers = []
    flush_group = engine._flush_group

    def watched(jobs):
        gathers.append([j.slot for j in jobs] != list(range(engine.capacity)))
        return flush_group(jobs)

    engine._flush_group = watched
    system.run()
    syncs = _wall(tel, "fleet.sync")
    collects, flushes = _wall(tel, "fleet.collect"), _wall(tel, "fleet.flush")
    assert collects and flushes and len(flushes) == len(gathers)
    env_steps = sum(c["args"]["env_steps"] for c in collects)
    by_parent: dict = {}
    for e in syncs:
        by_parent.setdefault(e["parent"], []).append(e["args"]["dir"])
    for c in collects:  # a cohort of one agent of two slots gathers its row
        assert by_parent.get(c["id"]) == ["h2d"]
        assert c["args"]["syncs"] == 3 * c["args"]["env_steps"]
        assert 0.0 < c["args"]["sync_s"] < c["t1"] - c["t0"]
    for f in flushes:
        assert by_parent[f["id"]].count("d2h") == 1
    misses = tel.registry.counter_value("fleet.erb_cache.misses")
    flush_copies = 2 * len(flushes) + sum(gathers) + misses
    assert len(syncs) == len(collects) + flush_copies
    assert sum(c["args"]["syncs"] for c in collects) == 3 * env_steps
    assert all(e["args"]["bytes"] > 0 for e in syncs)


def test_idle_by_span_names_each_gap_by_the_innermost_span():
    """Synthetic profile: device intervals (one a user annotation, which
    is no device work), a host op, and program spans; each gap of 5 us
    or more goes to the innermost span open at its middle."""
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU

    def ev(t0, t1, device=cuda, annotation=False):
        return types.SimpleNamespace(
            device_type=device,
            time_range=types.SimpleNamespace(start=t0, end=t1),
            is_user_annotation=annotation,
        )

    events = [
        ev(0.0, 10.0),
        ev(5.0, 12.0),  # overlaps: merged with the first
        ev(40.0, 50.0),  # gap 12-40 (mid 26): inside fleet.sync
        ev(53.0, 60.0),  # gap 50-53: under 5 us, not named
        ev(100.0, 110.0),  # gap 60-100 (mid 80): fleet.collect only
        ev(200.0, 210.0),  # gap 110-200 (mid 155): no span
        ev(150.0, 160.0, annotation=True),  # not device work
        ev(120.0, 190.0, device=cpu),  # a host op: not device work
    ]
    tel = Telemetry()
    tracer = tel.tracer
    tracer.anchor = {"perf_counter_s": tracer.anchor["perf_counter_s"], "unix_ns": 0}
    trace_start_ns = 0  # profiler us == wall seconds * 1e6 here
    us = 1e-6
    tracer.span("fleet.collect", "fleet", 0.0, 95 * us, clock="wall")
    tracer.span("fleet.sync", "fleet", 20 * us, 30 * us, clock="wall")
    tracer.span("fleet.flush", "fleet", 140 * us, 150 * us, clock="wall")
    tracer.span("round", "agent0", 0.0, 1.0)  # sim clock: not a wall span
    got = idle_by_span(events, tracer, trace_start_ns)
    assert got.keys() == {"fleet.sync", "fleet.collect", "(no span)"}
    assert got["fleet.sync"] == pytest.approx(28 * us)
    assert got["fleet.collect"] == pytest.approx(40 * us)
    assert got["(no span)"] == pytest.approx(90 * us)
    assert list(got) == ["(no span)", "fleet.collect", "fleet.sync"]
