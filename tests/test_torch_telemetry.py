"""The port's telemetry package against the reference's tests of it
(``tests/test_telemetry.py``): registry semantics and cardinality
bounds, the observe-only contract on the port's runner (disabled =
bit-identical runs, enabled = the same numbers plus a trace),
Perfetto/JSONL export round-trips and the ``python -m
repro_torch.telemetry`` CLI.  Added: the two packages' trace files are
one format, so a trace written by either loads in the other and both
CLIs summarize it.
"""

import json

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
from repro_torch.experiments import ScenarioSpec  # noqa: E402
from repro_torch.experiments.runner import run  # noqa: E402
from repro_torch.telemetry import (  # noqa: E402
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
    # two files are identical (JSONL) and one document (Perfetto)
    if suffix == ".json":
        assert json.loads(port_path.read_text()) == json.loads(ref_path.read_text())
    else:
        assert port_path.read_text() == ref_path.read_text()
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
