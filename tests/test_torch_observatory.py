"""The port's fleet observatory against the reference's.

The cases of ``tests/test_observatory.py`` run on the port (the
observe-only contract, the learning / propagation / health documents,
version-vector stamping, the detectors, Holm–Bonferroni, the streaming
trace writer, the dashboard), then the observed tiny spec runs on both
sides from the reference's init (the port's fleet slots seeded as
``tests/test_torch_baselines.py`` does), on the hub topology and on
hub-less gossip:

* the fingerprint (summary, eval curve, round records) is identical
  with telemetry on and off, and equal to the reference's: everything
  exact but the round losses, within 1e-4 (two frameworks' float32
  sum orders);
* every counter, every sim-clock event's kind, name, track, ``t0`` and
  ``t1``, the propagation summary and the health verdict are exactly
  the reference's.  One counter is not compared: ``fleet.compiles``
  counts XLA traces of the reference's process-wide jit cache; the
  port compiles nothing and has no such counter;
* the learning summaries and their registry series within 1e-4 (loss,
  ``td_abs``, ``grad_norm``) and 1e-5 (``q_max``).  Wall-clock values
  are exempt.

Below them, the pieces the statistics come from: ``fused_td_plain``'s
``td_abs`` and ``q_max`` against the reference's ``loss_fn_stats``
arithmetic (out-of-range actions included, 1e-6, NaN where it gives
NaN); ``FleetSteps.train_chunk_stats`` against the reference's (params
1e-5, stats at the tolerances above, ``params_finite`` equal) and
against the port's own ``train_chunk`` (bit for bit); one host copy a
flush with the observatory on as off; and an observed serving session
request by request against the unobserved one, with the reference's
counters.
"""

import dataclasses
import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: these sizes gain nothing from more, and spinning
# OpenMP threads in parallel test workers would starve the other tests
torch.set_num_threads(1)
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import repro.core  # noqa: E402, F401  (the reference's own import order)
from repro import serve as jax_serve  # noqa: E402
from repro.configs.adfll_dqn import ADFLLConfig as JaxADFLLConfig  # noqa: E402
from repro.configs.adfll_dqn import DQNConfig as JaxDQNConfig  # noqa: E402
from repro.experiments import ScenarioSpec as JaxScenarioSpec  # noqa: E402
from repro.experiments.runner import run as jax_run  # noqa: E402
from repro.rl.fleet import make_fleet_steps  # noqa: E402
from repro.telemetry import Telemetry as JaxTelemetry  # noqa: E402
from repro_torch import serve as port_serve  # noqa: E402
from repro_torch.configs.adfll_dqn import ADFLLConfig, DQNConfig  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    fleet_state_from_numpy,
    fleet_state_to_numpy,
)
from repro_torch.core.erb import flat_columns  # noqa: E402
from repro_torch.experiments import ScenarioSpec  # noqa: E402
from repro_torch.experiments.runner import run  # noqa: E402
from repro_torch.kernels.fused_td import fused_td, fused_td_plain, td_loss  # noqa: E402
from repro_torch.observatory import Observatory  # noqa: E402
from repro_torch.rl.fleet import FleetEngine, FleetSteps, unpack_stats  # noqa: E402
from repro_torch.sweeps.stats import holm_bonferroni  # noqa: E402
from repro_torch.telemetry import (  # noqa: E402
    JsonlTraceSink,
    Telemetry,
    load_trace,
    render_dashboard,
    write_dashboard,
)
from repro_torch.telemetry.__main__ import main as tel_main  # noqa: E402
from repro_torch.telemetry.trace import clock_anchor  # noqa: E402
from test_torch_baselines import reference_init  # noqa: E402
from test_torch_fleet import _pool  # noqa: E402

# tests/test_observatory.py's tiny widths
DQN_KW = dict(
    volume_shape=(12, 12, 12),
    box_size=(4, 4, 4),
    conv_features=(2,),
    hidden=(8,),
    batch_size=4,
    max_episode_steps=4,
    eps_decay_steps=20,
)
SYS_KW = dict(
    n_agents=2,
    n_hubs=1,
    agent_hub=(0, 0),
    agent_speed=(1.0, 2.0),
    rounds=2,
    erb_capacity=128,
    erb_share_size=16,
    train_steps_per_round=2,
    hub_sync_period=0.5,
    share_planes=("erb", "weights"),  # exercise mixes + snapshot stamping
)
TINY_DQN, TINY_SYS = DQNConfig(**DQN_KW), ADFLLConfig(**SYS_KW)
SPEC_KW = dict(
    name="tiny",
    system="adfll",
    task_set="paper8",
    n_tasks=2,
    n_patients=8,
    eval_patients=2,
    eval_episodes=2,
)
# float32 learning statistics of two frameworks: the loss, td_abs and
# grad_norm sum in other orders (1e-4); q_max is one |q| (1e-5)
TOL = {"loss": 1e-4, "td_abs": 1e-4, "grad_norm": 1e-4, "q_max": 1e-5}
# counts XLA traces of the reference's process-wide jit cache: no port
# counterpart
NOT_COMPARED = {"fleet.compiles"}


def _tiny_spec(**sys_kw):
    return ScenarioSpec(
        **SPEC_KW, dqn=TINY_DQN, sys=dataclasses.replace(TINY_SYS, **sys_kw)
    )


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


@pytest.fixture(scope="module", params=["hub", "gossip"])
def runs(request):
    """The observed tiny spec on both sides from the reference's init,
    and the port's unobserved run from the same init."""
    topology = request.param
    with pytest.MonkeyPatch.context() as mp:
        reference_init(mp)
        ref_tel = JaxTelemetry(enabled=True)
        ref = jax_run(
            JaxScenarioSpec(
                **SPEC_KW,
                dqn=JaxDQNConfig(**DQN_KW),
                sys=JaxADFLLConfig(**SYS_KW, topology=topology),
            ),
            telemetry=ref_tel,
        )
        tel = Telemetry(enabled=True)
        port = run(_tiny_spec(topology=topology), telemetry=tel, device="cpu")
        base = run(_tiny_spec(topology=topology), device="cpu")
    return dict(
        topology=topology, ref=ref, ref_tel=ref_tel, port=port, tel=tel, base=base
    )


@pytest.fixture(scope="module")
def observed(runs):
    return runs["tel"], runs["port"]


# ---------------------------------------------------------------------------
# observe-only contract: enabled observatory changes nothing
# ---------------------------------------------------------------------------
def test_enabled_observatory_is_bit_identical(runs):
    assert _fingerprint(runs["base"]) == _fingerprint(runs["port"])
    # and the reference's: exact but the round losses (1e-4)
    s_ref, curve_ref, hist_ref = _fingerprint(runs["ref"])
    s, curve, hist = _fingerprint(runs["port"])
    assert s == s_ref and curve == curve_ref
    assert len(hist) == len(hist_ref)
    for a, b in zip(hist, hist_ref, strict=True):
        assert a[:5] == b[:5] and abs(a[5] - b[5]) <= 1e-4


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------
def _series(tel, kind):
    return {
        (m["name"], tuple(sorted(m["labels"].items()))): m["value"]
        for m in tel.registry.rows()
        if m["kind"] == kind and m["name"] not in NOT_COMPARED
    }


def _stat_tol(name: str) -> float | None:
    """The tolerance of a learning-statistic series, None for the exact
    (host-side, sim-clock) ones."""
    for stat, tol in TOL.items():
        if name in (f"agent.{stat}", f"agent.{stat}.last"):
            return tol
    return None


def test_counters_and_sim_clock_events_match_reference(runs):
    tel, ref_tel = runs["tel"], runs["ref_tel"]
    assert _series(tel, "counter") == _series(ref_tel, "counter")

    def sim(t):
        return [e for e in t.tracer.events if e["clock"] == "sim"]

    ours, theirs = sim(tel), sim(ref_tel)
    assert [(e["kind"], e["name"], e["track"], e["t0"], e["t1"]) for e in ours] == [
        (e["kind"], e["name"], e["track"], e["t0"], e["t1"]) for e in theirs
    ]
    for a, b in zip(ours, theirs, strict=True):
        if a["kind"] == "counter":  # agent.loss timelines: a loss (1e-4)
            assert abs(a["args"]["value"] - b["args"]["value"]) <= 1e-4
        else:
            assert a["args"] == b["args"]
    kinds = {e["name"] for e in ours}
    assert {"round", "fleet.flush", "agent.loss"} <= kinds
    if runs["topology"] == "gossip":
        assert "gossip.exchange" in kinds

    # histograms: counts exact; sums exact for the sim-clock series, at
    # the statistics' tolerances for the learning ones; wall exempt
    hists, ref_hists = _series(tel, "histogram"), _series(ref_tel, "histogram")
    assert hists.keys() == ref_hists.keys()
    for key, h in hists.items():
        name, want = key[0], ref_hists[key]
        assert h["count"] == want["count"], key
        if name == "fleet.flush.wall_s":
            continue
        tol = _stat_tol(name)
        if tol is None:
            assert h == want, key
        else:
            assert abs(h["sum"] - want["sum"]) <= tol * h["count"], key
    gauges, ref_gauges = _series(tel, "gauge"), _series(ref_tel, "gauge")
    assert gauges.keys() == ref_gauges.keys()
    for key, v in gauges.items():
        assert abs(v - ref_gauges[key]) <= _stat_tol(key[0]), key


def test_propagation_and_health_match_reference(runs):
    port, ref = runs["port"].extra, runs["ref"].extra
    assert port["propagation"] == ref["propagation"]
    assert port["health"] == ref["health"]
    if runs["topology"] == "gossip":
        assert port["propagation"]["gossip"]["n_deliveries"] > 0


def test_learning_summaries_match_reference(runs):
    port, ref = runs["port"].extra["learning"], runs["ref"].extra["learning"]
    assert port.keys() == ref.keys()
    for label, doc in port.items():
        want = ref[label]
        for f in ("n_chunks", "n_steps", "last_sim_time", "nonfinite_flushes"):
            assert doc[f] == want[f], (label, f)
        for f, tol in (
            ("last_loss", TOL["loss"]),
            ("min_loss", TOL["loss"]),
            ("max_grad_norm", TOL["grad_norm"]),
            ("max_q", TOL["q_max"]),
        ):
            assert abs(doc[f] - want[f]) <= tol, (label, f)
        assert [t for t, _ in doc["loss_curve"]] == [t for t, _ in want["loss_curve"]]
        for (_, a), (_, b) in zip(doc["loss_curve"], want["loss_curve"], strict=True):
            assert abs(a - b) <= TOL["loss"]


# ---------------------------------------------------------------------------
# learning dynamics
# ---------------------------------------------------------------------------
def test_per_agent_learning_series_and_summary(observed):
    tel, report = observed
    learning = report.extra["learning"]
    assert sorted(learning) == ["0", "1"]
    for label, doc in learning.items():
        assert doc["n_chunks"] >= 1
        assert doc["n_steps"] == doc["n_chunks"] * TINY_SYS.train_steps_per_round
        assert doc["last_loss"] is not None and math.isfinite(doc["last_loss"])
        assert doc["min_loss"] is not None and math.isfinite(doc["min_loss"])
        assert len(doc["loss_curve"]) == doc["n_chunks"]
        # the registry carries the same series, labeled by agent
        h = tel.registry.histogram("agent.loss", agent=label)
        assert h is not None and h["count"] == doc["n_chunks"]
        steps = tel.registry.counter_value("agent.steps_trained", agent=label)
        assert steps == doc["n_steps"]
    # loss is also a per-agent counter *event* timeline for the dashboard
    tracks = {
        e["track"]
        for e in tel.tracer.events
        if e["kind"] == "counter" and e["name"] == "agent.loss"
    }
    assert tracks == {"agent0", "agent1"}


# ---------------------------------------------------------------------------
# knowledge propagation
# ---------------------------------------------------------------------------
def test_propagation_document(observed):
    _, report = observed
    prop = report.extra["propagation"]
    # both agents pushed at least one round -> full version vector
    assert sorted(prop["version_vector"]) == ["0", "1"]
    assert all(r >= 1 for r in prop["version_vector"].values())
    assert prop["erb"]["n_pushed"] == 4  # 2 agents x 2 rounds
    assert prop["mix"]["n_mixes"] >= 1
    assert prop["mix"]["staleness"] is not None
    assert prop["mix"]["staleness"]["n"] == prop["mix"]["n_snapshots"]
    # influence re-weights sum over sources, one weight per folded snap
    assert all(v > 0 for v in prop["mix"]["influence_by_source"].values())
    assert prop["n_dropped_tracked"] == 0


def test_version_vectors_stamped_on_outgoing_records():
    from repro_torch.core.federated import ADFLLSystem
    from repro_torch.rl.synth import paper_eight_tasks, patient_split

    tasks = list(paper_eight_tasks())[:2]
    train_p, _ = patient_split(8)
    tel = Telemetry(enabled=True)
    system = ADFLLSystem(
        TINY_SYS, TINY_DQN, tasks, train_p, telemetry=tel, device="cpu"
    )
    system.run()
    hub = system.network.hubs[0]
    erbs = list(hub.store("erb").values())
    snaps = list(hub.store("weights").values())
    assert erbs and snaps
    assert all(isinstance(e.meta.version_vector, tuple) for e in erbs)
    # at least the later records carry a non-empty vector
    assert any(e.meta.version_vector for e in erbs)
    assert any(s.version_vector for s in snaps)
    for s in snaps:
        for aid, rnd in s.version_vector:
            assert 0 <= aid < TINY_SYS.n_agents
            assert 0 <= rnd <= TINY_SYS.rounds


def test_default_records_carry_empty_version_vector():
    from repro_torch.core.erb import TaskTag, erb_init
    from repro_torch.core.plane import CompressedWeightPlane, WeightSnapshot

    erb = erb_init(8, (4, 4, 4), task=TaskTag("t", "axial", "HGG"))
    assert erb.meta.version_vector == ()
    snap = WeightSnapshot(
        snap_id="s0", agent_id=0, round_idx=0, sim_time=0.0, params={}
    )
    assert snap.version_vector == ()
    # the wire encoding carries a stamped vector verbatim
    params = {"fc0": {"w": torch.ones(3, 2), "b": torch.zeros(2)}}
    stamped = dataclasses.replace(snap, params=params, version_vector=((0, 1),))
    wire = CompressedWeightPlane(compression="int8").encode(stamped)
    assert wire.version_vector == ((0, 1),)


# ---------------------------------------------------------------------------
# health
# ---------------------------------------------------------------------------
def test_health_verdict_shape(observed):
    _, report = observed
    health = report.extra["health"]
    assert health["status"] in ("ok", "warn", "alert")
    assert set(health["counts"]) == {i["kind"] for i in health["incidents"]}
    # a healthy tiny run never alerts
    kinds = set(health["counts"])
    assert not kinds & {"nonfinite_params", "nonfinite_loss", "loss_divergence"}


def test_health_detectors_fire_on_bad_stats():
    tel = Telemetry(enabled=True)
    obs = Observatory(tel)
    obs.register_slot(0, 0)
    good = {
        "loss": np.full((2, 1), 1.0),
        "td_abs": np.zeros((2, 1)),
        "q_max": np.zeros((2, 1)),
        "grad_norm": np.zeros((2, 1)),
        "params_finite": np.array([True]),
    }
    for t in range(3):
        obs.on_flush([0], good, 1, float(t))
    diverged = dict(good, loss=np.full((2, 1), 100.0))
    obs.on_flush([0], diverged, 1, 3.0)
    nan = dict(good, loss=np.full((2, 1), np.nan), params_finite=np.array([False]))
    obs.on_flush([0], nan, 1, 4.0)
    verdict = obs.health.verdict(makespan=5.0)
    assert verdict["status"] == "alert"
    assert verdict["counts"]["loss_divergence"] == 1
    assert verdict["counts"]["nonfinite_params"] == 1
    # detectors fire once per agent, and each incident is a trace instant
    obs.on_flush([0], nan, 1, 5.0)
    assert obs.health.verdict(makespan=5.0)["counts"]["nonfinite_params"] == 1
    names = {e["name"] for e in tel.tracer.events if e["kind"] == "instant"}
    assert {"health.loss_divergence", "health.nonfinite_params"} <= names


def test_straggler_detection():
    obs = Observatory(Telemetry(enabled=True))
    stats = {
        "loss": np.full((1, 2), 1.0),
        "td_abs": np.zeros((1, 2)),
        "q_max": np.zeros((1, 2)),
        "grad_norm": np.zeros((1, 2)),
        "params_finite": np.array([True, True]),
    }
    obs.register_slot(0, 0)
    obs.register_slot(1, 1)
    obs.on_flush([0, 1], stats, 2, 1.0)  # both active early
    only0 = {k: (v[:, :1] if v.ndim == 2 else v[:1]) for k, v in stats.items()}
    obs.on_flush([0], only0, 1, 99.0)  # agent 0 keeps training
    verdict = obs.health.verdict(makespan=100.0)
    assert verdict["stragglers"] == [1]
    assert verdict["status"] == "warn"


# ---------------------------------------------------------------------------
# Holm–Bonferroni
# ---------------------------------------------------------------------------
def test_holm_bonferroni_adjustment():
    assert holm_bonferroni([]) == []
    assert holm_bonferroni([None]) == [None]
    # classic step-down: sorted p x (m - rank), running max, clipped
    adj = holm_bonferroni([0.01, 0.04, 0.03])
    assert adj == pytest.approx([0.03, 0.06, 0.06])
    # None / NaN positions pass through and do not count toward m
    adj = holm_bonferroni([0.01, None, float("nan"), 0.04])
    assert adj[1] is None and math.isnan(adj[2])
    assert adj[0] == pytest.approx(0.02)
    assert adj[3] == pytest.approx(0.04)
    # monotone in the input order of the sorted p's, never above 1
    assert holm_bonferroni([0.9, 0.8]) == [1.0, 1.0]


def test_compare_gates_on_adjusted_p():
    from repro_torch.sweeps.aggregate import compare

    def _summary(vals_by_variant):
        return {
            "variants": {
                label: {
                    "metrics": {
                        m: {"values": {str(i): x for i, x in enumerate(vals)}}
                        for m, vals in ms.items()
                    }
                }
                for label, ms in vals_by_variant.items()
            }
        }

    a = _summary({"x": {"mean_dist_err": [1.0, 1.01, 0.99, 1.0, 1.02]}})
    b = _summary({"x": {"mean_dist_err": [1.5, 1.53, 1.47, 1.51, 1.54]}})
    rows, regressions = compare(a, b, alpha=0.05)
    (row,) = rows
    assert row["p_ttest_adj"] is not None
    assert row["p_ttest_adj"] >= row["p_ttest"]
    assert row["significant"] and row["regression"]
    assert regressions == [row]


# ---------------------------------------------------------------------------
# streaming trace writer
# ---------------------------------------------------------------------------
def test_streaming_sink_roundtrip(tmp_path):
    path = tmp_path / "stream.jsonl"
    tel = Telemetry(enabled=True, stream_path=path)
    for i in range(10):
        tel.instant("tick", "t", float(i))
    tel.count("comm.bytes", 42, plane="erb")
    assert len(tel.tracer.events) == 0  # streamed, not buffered
    tel.close()
    tel.close()  # idempotent
    doc = load_trace(path)
    assert len(doc["events"]) == 10
    counters = {m["name"]: m["value"] for m in doc["metrics"]}
    assert counters["comm.bytes"] == 42
    assert counters["trace.dropped"] == 0


def test_streaming_sink_byte_cap_drops_and_counts(tmp_path):
    path = tmp_path / "capped.jsonl"
    tel = Telemetry(enabled=True, stream_path=path, stream_max_bytes=600)
    for i in range(100):
        tel.instant("tick", "t", float(i))
    assert tel.sink.n_written < 100
    assert tel.tracer.n_dropped == 100 - tel.sink.n_written
    tel.close()
    doc = load_trace(path)
    assert len(doc["events"]) == tel.sink.n_written
    # metric rows are exempt from the cap: the dropped tally survives
    dropped = {m["value"] for m in doc["metrics"] if m["name"] == "trace.dropped"}
    assert dropped == {float(tel.tracer.n_dropped)}


def test_sink_refuses_after_close(tmp_path):
    sink = JsonlTraceSink(tmp_path / "s.jsonl", anchor=clock_anchor())
    assert sink.write({"kind": "instant", "name": "a"})
    sink.close()
    assert not sink.write({"kind": "instant", "name": "b"})


# ---------------------------------------------------------------------------
# dashboard
# ---------------------------------------------------------------------------
def test_dashboard_from_live_run(tmp_path, observed):
    tel, _ = observed
    trace = {"events": list(tel.tracer.events), "metrics": tel.registry.summary()}
    out = write_dashboard(tmp_path / "dash.html", trace)
    html = out.read_text()
    assert html.startswith("<!doctype html>")
    for panel in (
        "Learning dynamics",
        "Staleness heatmap",
        "Health",
        "Span aggregates",
        "<svg",
        "<polyline",
    ):
        assert panel in html
    # self-contained: no external fetches (the SVG xmlns URI is a
    # namespace identifier, never dereferenced)
    for needle in ("src=", "href=", "<link", "@import", "url("):
        assert needle not in html


def test_dashboard_cli_from_saved_trace(tmp_path, capsys):
    trace_path = tmp_path / "t.jsonl"
    tel = Telemetry(enabled=True, stream_path=trace_path)
    tel.span("round", "agent0", 0.0, 1.0)
    tel.counter("agent.loss", "agent0", 0.5, 1.25)
    tel.close()
    out = tmp_path / "d.html"
    assert tel_main(["dashboard", str(trace_path), "-o", str(out)]) == 0
    assert "wrote" in capsys.readouterr().out
    html = out.read_text()
    assert "Learning dynamics" in html and "Span aggregates" in html


def test_dashboard_tolerates_empty_trace_and_embeds_sweep():
    html = render_dashboard(
        {"events": [], "metrics": []},
        sweep_summary={
            "comparisons": [
                {"arm": "x", "metric": "m", "p_ttest": 0.2, "p_ttest_adj": 0.4}
            ]
        },
        title="empty",
    )
    assert "Sweep comparison" in html
    assert "0.4" in html


def test_cli_writes_trace_and_dashboard(tmp_path, capsys):
    """``--trace`` and ``--dashboard`` on the port's CLI, on the CPU; the
    trace loads in both packages."""
    from repro.telemetry import load_trace as jax_load_trace
    from repro_torch.experiments.__main__ import main

    trace, dash = tmp_path / "t.jsonl", tmp_path / "d.html"
    args = ["--scenario", "fedavg_sync", "--fast", "--device", "cpu"]
    assert main([*args, "--trace", str(trace), "--dashboard", str(dash)]) == 0
    out = capsys.readouterr().out
    assert f"wrote trace {trace}" in out and f"wrote dashboard {dash}" in out
    assert load_trace(trace) == jax_load_trace(trace)
    assert dash.read_text().startswith("<!doctype html>")


@pytest.mark.parametrize(
    "name", ["paper_fig2", "topo_gossip", "fedavg_sync", "serve_localization"]
)
def test_scenarios_run_observed_and_unchanged(name):
    """Enabled telemetry on the CPU through the runner, at the tiny widths:
    the same fingerprint as the unobserved run; the ADFLL and serving
    systems report the telemetry digest (and the ADFLL ones the
    observatory's documents)."""
    from repro_torch.experiments.registry import get_scenario

    spec = dataclasses.replace(get_scenario(name), dqn=TINY_DQN).fast()
    base = run(spec, device="cpu")
    tel = Telemetry(enabled=True)
    observed = run(spec, telemetry=tel, device="cpu")
    assert _fingerprint(base) == _fingerprint(observed)
    if spec.system == "fedavg":  # runs without telemetry, as the reference's
        assert len(tel.tracer) == 0
        return
    # the digest is taken before the health verdict, which may still add
    # straggler instants (the reference's order)
    assert 0 < observed.extra["telemetry"]["n_events"] <= len(tel.tracer)
    assert tel.registry.counter_value("fleet.flushes") >= 1
    if spec.system == "adfll":
        assert {"learning", "propagation", "health"} <= observed.extra.keys()
        assert observed.extra["health"]["status"] != "alert"
    else:
        served, want = (
            {k: v for k, v in r.extra["serve"].items() if k not in _SERVE_WALL}
            for r in (observed, base)
        )
        assert served == want
        # evaluation serves through the same service after run()'s
        # snapshot of the summary: the counter counts both
        assert tel.registry.counter_value("serve.ticks") >= want["n_ticks"] > 0


# the serve summary's wall-clock fields (exempt from the comparison)
_SERVE_WALL = (
    "requests_per_sec",
    "p50_latency_ms",
    "p99_latency_ms",
    "mean_latency_ms",
    "wall_time_s",
)


# ---------------------------------------------------------------------------
# the statistics' sources
# ---------------------------------------------------------------------------
def _stats_inputs(rng, n: int, b: int, a: int, out_of_range: bool):
    box = (4, 4, 4)
    cols = flat_columns(box)
    td_cols = tuple(cols[k].start for k in ("action", "reward", "done"))
    feat = cols["done"].stop
    q = rng.standard_normal((n, b, a)).astype(np.float32)
    q_next = rng.standard_normal((n, b, a)).astype(np.float32)
    rows = rng.standard_normal((n, b, feat)).astype(np.float32)
    rows[..., td_cols[0]] = rng.integers(0, a, (n, b))
    rows[..., td_cols[2]] = rng.random((n, b)) < 0.3
    if out_of_range:
        edge = [2.7, -0.5, np.nan, -1, -6, 6, 7, -7, -100, 1e10, 5.9, 0]
        rows[0, : len(edge), td_cols[0]] = edge[:b]
        q[n - 1, 0, 0] = np.nan  # a NaN q makes that agent's q_max NaN
    return q, q_next, rows, td_cols


def _reference_stats(q, q_next, rows, td_cols, gamma):
    """``repro/rl/fleet.py::loss_fn_stats``' aux outputs, per agent."""
    col_a, col_r, col_d = td_cols

    def one(q, q_next, rows):
        action = rows[:, col_a].astype(jnp.int32)
        q_sel = jnp.take_along_axis(q, action[:, None], 1)
        td_target = rows[:, col_r][:, None] + gamma * (
            1.0 - rows[:, col_d][:, None]
        ) * jnp.max(q_next, axis=-1, keepdims=True)
        td_abs = jnp.mean(jnp.abs(q_sel - td_target))
        q_max = jnp.max(jnp.abs(q))
        return td_abs, q_max

    td_abs, q_max = jax.vmap(one)(*map(jnp.asarray, (q, q_next, rows)))
    return np.asarray(td_abs), np.asarray(q_max)


@pytest.mark.parametrize(
    "n,b,a,out_of_range", [(4, 32, 6, False), (3, 50, 6, False), (2, 12, 6, True)]
)
def test_fused_td_plain_stats_match_reference(n, b, a, out_of_range):
    rng = np.random.default_rng(n * 100 + b)
    q, q_next, rows, td_cols = _stats_inputs(rng, n, b, a, out_of_range)
    want_td, want_qm = _reference_stats(q, q_next, rows, td_cols, 0.9)
    ins = [torch.from_numpy(x) for x in (q, q_next, rows)]
    plain = fused_td_plain(*ins, td_cols, 0.9)
    np.testing.assert_allclose(plain.td_abs.numpy(), want_td, atol=1e-6, rtol=0)
    np.testing.assert_allclose(plain.q_max.numpy(), want_qm, atol=1e-6, rtol=0)
    if out_of_range:
        # a NaN-selected row makes agent 0's td_abs NaN, a NaN q agent 1's q_max
        assert np.isnan(want_td[0]) and torch.isnan(plain.td_abs[0])
        assert np.isnan(want_qm[-1]) and torch.isnan(plain.q_max[-1])
    # the wrapper on the CPU: the plain version, written where asked
    stats = (torch.full((n,), -1.0), torch.full((n,), -1.0))
    out = fused_td(*ins, td_cols, 0.9, stats)
    assert out.td_abs is stats[0] and out.q_max is stats[1]
    torch.testing.assert_close(stats[0], plain.td_abs, equal_nan=True, atol=0, rtol=0)
    torch.testing.assert_close(stats[1], plain.q_max, equal_nan=True, atol=0, rtol=0)
    bare = fused_td(*ins, td_cols, 0.9)
    assert bare.td_abs is None and bare.q_max is None
    for x, y in zip(bare[:4], plain[:4], strict=True):
        torch.testing.assert_close(x, y, equal_nan=True, atol=0, rtol=0)


def test_td_loss_stats_are_outputs_without_gradient():
    rng = np.random.default_rng(5)
    q, q_next, rows, td_cols = _stats_inputs(rng, 2, 8, 6, False)
    leaf = torch.from_numpy(q).requires_grad_(True)
    ins = [torch.from_numpy(x) for x in (q_next, rows)]
    stats = (torch.empty(2), torch.empty(2))
    loss, td_abs, q_max = td_loss(leaf, *ins, td_cols, 0.9, stats)
    assert not td_abs.requires_grad and not q_max.requires_grad
    (grad,) = torch.autograd.grad(loss.sum(), leaf)
    (want,) = torch.autograd.grad(td_loss(leaf, *ins, td_cols, 0.9).sum(), leaf)
    assert torch.equal(grad, want)


def _stacked_state(jcfg, seeds):
    ref_steps = make_fleet_steps(jcfg)
    slots = [ref_steps.init_slot(seed) for seed in seeds]
    ref_state = jax.tree_util.tree_map(lambda *xs: jnp.concatenate(xs), *slots)
    state = fleet_state_from_numpy(
        {
            k: jax.tree_util.tree_map(np.asarray, getattr(ref_state, k))
            for k in ("params", "target", "opt", "count")
        }
    )
    return ref_steps, ref_state, state


def test_train_chunk_stats_matches_reference_and_plain_chunk():
    """tests/test_torch_fleet.py's config (a target sync inside the nine
    steps) through both stats chunks."""
    kw = dict(
        volume_shape=(16, 16, 16),
        box_size=(6, 6, 6),
        conv_features=(4,),
        hidden=(32,),
        max_episode_steps=12,
        batch_size=16,
        eps_decay_steps=100,
        target_update=8,
    )
    cfg = DQNConfig(**kw)
    ref_steps, ref_state, state = _stacked_state(JaxDQNConfig(**kw), (3, 4))
    rng = np.random.default_rng(0)
    pool = _pool(rng, 256, cfg)
    idx = rng.integers(0, 256, (9, 2, cfg.batch_size)).astype(np.int32)
    pool_t, idx_t = torch.from_numpy(pool), torch.from_numpy(idx)

    steps = FleetSteps(cfg, "cpu")
    new, packed = steps.train_chunk_stats(state, pool_t, idx_t)
    plain, losses = steps.train_chunk(state, pool_t, idx_t)
    assert packed.shape == (4 * 9 + 1, 2)
    stats = unpack_stats(packed.numpy(), 9)
    # the stats chunk is the plain chunk, bit for bit
    assert torch.equal(torch.from_numpy(stats["loss"]), losses)
    got, want_plain = fleet_state_to_numpy(new), fleet_state_to_numpy(plain)
    for field in ("params", "target", "opt"):
        for a, b in zip(
            jax.tree_util.tree_leaves(got[field]),
            jax.tree_util.tree_leaves(want_plain[field]),
            strict=True,
        ):
            assert np.array_equal(a, b)

    ref_new, ref_stats = ref_steps.train_chunk_stats(
        ref_state, jnp.asarray(pool), jnp.asarray(idx)
    )
    for name, tol in TOL.items():
        np.testing.assert_allclose(
            stats[name], np.asarray(ref_stats[name]), atol=tol, rtol=0, err_msg=name
        )
    assert stats["params_finite"].tolist() == np.asarray(
        ref_stats["params_finite"]
    ).tolist() == [True, True]
    want = jax.tree_util.tree_map(np.asarray, ref_new.params)
    for a, b in zip(
        jax.tree_util.tree_leaves(got["params"]),
        jax.tree_util.tree_leaves(want),
        strict=True,
    ):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)


def test_params_finite_flags_the_nonfinite_slot():
    cfg = TINY_DQN
    steps = FleetSteps(cfg, "cpu")
    slots = [steps.init_slot(seed) for seed in (0, 1)]
    state = slots[0].map(lambda *xs: torch.cat(xs), *slots[1:])
    state.params["fc0"]["b"][1, 0] = float("inf")
    rng = np.random.default_rng(1)
    pool = torch.from_numpy(_pool(rng, 64, cfg))
    idx = torch.from_numpy(rng.integers(0, 64, (2, 2, cfg.batch_size)).astype(np.int32))
    _, packed = steps.train_chunk_stats(state, pool, idx)
    assert unpack_stats(packed.numpy(), 2)["params_finite"].tolist() == [True, False]


@pytest.mark.parametrize("observatory", [False, True])
def test_flush_makes_one_host_copy(monkeypatch, observatory):
    """A flush of two jobs copies to the host once, with the observatory on
    as off, and launches no more kernels with it."""
    from repro_torch.core.erb import TaskTag, erb_add, erb_init
    from repro_torch.core.replay import SelectiveReplaySampler
    from repro_torch.kernels.replay_gather import replay_gather

    cfg = TINY_DQN
    engine = FleetEngine(cfg, device="cpu")
    if observatory:
        engine.telemetry = Telemetry(enabled=True)
        engine.observatory = Observatory(engine.telemetry)
    rng = np.random.default_rng(0)
    sampler = SelectiveReplaySampler()
    for slot in (engine.add_slot(0), engine.add_slot(1)):
        erb = erb_init(64, cfg.box_size, task=TaskTag("t", "axial", "HGG"))
        n = 64
        erb_add(
            erb,
            {
                "obs": rng.random((n, *cfg.box_size), dtype=np.float32),
                "loc": rng.random((n, 3), dtype=np.float32),
                "action": rng.integers(0, cfg.n_actions, n).astype(np.int32),
                "reward": rng.standard_normal(n).astype(np.float32),
                "next_obs": rng.random((n, *cfg.box_size), dtype=np.float32),
                "next_loc": rng.random((n, 3), dtype=np.float32),
                "done": np.zeros(n, np.float32),
            },
        )
        plans = [sampler.plan(rng, cfg.batch_size, erb) for _ in range(3)]
        engine.submit(slot, plans)
    copies = []
    cpu = torch.Tensor.cpu

    def counting(self, *args, **kw):
        copies.append(tuple(self.shape))
        return cpu(self, *args, **kw)

    monkeypatch.setattr(torch.Tensor, "cpu", counting)
    engine.flush()
    assert copies == ([(4 * 3 + 1, 2)] if observatory else [(3, 2)])
    assert engine.n_chunk_steps == 3
    if observatory:
        learning = engine.observatory.learning.summary()
        assert sorted(learning) == ["0", "1"]
        assert engine.telemetry.registry.counter_value("fleet.flushes") == 1


def test_observed_session_matches_unobserved_and_reference():
    """One serving session (2 agents, 16 requests, a hot swap) with
    enabled telemetry against the same session without it, request by
    request, and its counters against the reference's observed session
    from the same init."""
    kw = dict(
        volume_shape=(16, 16, 16),
        box_size=(6, 6, 6),
        conv_features=(4,),
        hidden=(32,),
        max_episode_steps=12,
        batch_size=16,
        eps_decay_steps=100,
    )
    traffic = port_serve.TrafficSpec(n_requests=16, max_batch=4, seed=3)
    jtraffic = jax_serve.TrafficSpec(n_requests=16, max_batch=4, seed=3)

    def session(tel):
        s = port_serve.build_session(
            DQNConfig(**kw), n_agents=2, traffic=traffic, seed=3, telemetry=tel,
            device="cpu",
        )
        port_serve.run_session(s, traffic, n_waves=2, train_steps=4)
        return [
            (r.request_id, r.final_loc.tolist(), r.n_ticks, r.version)
            for r in s.service.report.requests
        ]

    with pytest.MonkeyPatch.context() as mp:
        reference_init(mp)
        base = session(None)
        tel = Telemetry(enabled=True)
        observed = session(tel)
    assert observed == base
    ref_tel = JaxTelemetry(enabled=True)
    ref = jax_serve.build_session(
        JaxDQNConfig(**kw), n_agents=2, traffic=jtraffic, seed=3, telemetry=ref_tel
    )
    jax_serve.run_session(ref, jtraffic, n_waves=2, train_steps=4)
    want = [
        (r.request_id, r.final_loc.tolist(), r.n_ticks, r.version)
        for r in ref.service.report.requests
    ]
    assert observed == want
    assert _series(tel, "counter") == _series(ref_tel, "counter")
    assert tel.registry.counter_value("serve.ticks") > 0
    assert tel.registry.counter_value("serve.swaps") == 1
