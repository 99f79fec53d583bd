"""The experiments CLI's several ``--scenario`` flags and ``--json``
against the reference's CLI on the CPU.

Both CLIs run ``plane_erb_only`` and ``gossip_hetero`` (``--fast``, the
registry's widths, evaluation cut to one patient and one episode on both
sides) from the reference's init (``test_torch_baselines.reference_init``):

* with ``--json`` alone the two payloads are equal key for key and value
  for value, and so are the files;
* with ``--json``, ``--trace`` and ``--dashboard`` (the reference CI's
  call) both CLIs write the per-scenario traces and dashboards under the
  same names, and the payloads are equal outside what enabled telemetry
  adds: the observatory's learning statistics and the telemetry summary's
  values agree within 1e-5 (float32 losses from two frameworks), the
  summary less its host-clock histograms (``*wall_s``), the
  reference's jit-compile counter and instants (JAX compiles, eager
  PyTorch does not) and the port's host-loop wall spans
  (``fleet.collect``, ``fleet.plan``, ``fleet.sync``).
"""

import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: these sizes gain nothing from more, and spinning
# OpenMP threads in parallel test workers would starve the other tests
torch.set_num_threads(1)
jax = pytest.importorskip("jax")

import repro.core  # noqa: E402,F401  (the reference's own import order)
from repro.experiments import __main__ as ref_cli  # noqa: E402
from repro.experiments import registry as ref_registry  # noqa: E402
from repro_torch.experiments import __main__ as cli  # noqa: E402
from repro_torch.experiments import registry  # noqa: E402
from test_torch_baselines import reference_init  # noqa: E402

SCENARIOS = ("plane_erb_only", "gossip_hetero")


def _cut_evaluation(monkeypatch, reg) -> None:
    """One patient and one episode in each scenario's evaluation."""
    for name in SCENARIOS:
        spec = reg._REGISTRY[name]
        cut = dataclasses.replace(spec, eval_patients=1, eval_episodes=1)
        monkeypatch.setitem(reg._REGISTRY, name, cut)


def _argv(out, observed: bool) -> list[str]:
    argv = [a for name in SCENARIOS for a in ("--scenario", name)]
    argv += ["--fast", "--json", str(out / "bench.json")]
    if observed:
        argv += ["--trace", str(out / "trace.jsonl")]
        argv += ["--dashboard", str(out / "dash.html")]
    return argv


def _run_both(tmp_path, monkeypatch, capsys, observed: bool):
    """Both CLIs on the same argv; returns ``(port dir, ref dir, port out,
    ref out)``."""
    reference_init(monkeypatch)
    _cut_evaluation(monkeypatch, registry)
    _cut_evaluation(monkeypatch, ref_registry)
    ours, theirs = tmp_path / "port", tmp_path / "ref"
    ours.mkdir()
    theirs.mkdir()
    assert cli.main([*_argv(ours, observed), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert ref_cli.main(_argv(theirs, observed)) == 0
    ref_out = capsys.readouterr().out
    # the summary lines and the files written, in order
    assert out.replace(str(ours), "DIR") == ref_out.replace(str(theirs), "DIR")
    return ours, theirs


# what one side traces and the other has not: the reference's jit
# compiles, and the port's host-loop wall spans (collection, replay
# planning, blocking copies; the reference's jitted loop has no such
# boundaries on the host)
ONE_SIDED = ("instant:fleet.compile", "span:fleet.collect", "span:fleet.plan",
             "span:fleet.sync")  # fmt: skip


def _comparable(telemetry: dict) -> dict:
    """A telemetry summary less its host-clock histograms and the
    entries only one side traces (``ONE_SIDED``)."""
    events = dict(telemetry["events_by_name"])
    dropped = sum(events.pop(name, 0) for name in ONE_SIDED)
    metrics = [
        m
        for m in telemetry["metrics"]
        if m["name"] != "fleet.compiles" and not m["name"].endswith("wall_s")
    ]
    return dict(
        telemetry,
        events_by_name=events,
        metrics=metrics,
        n_events=telemetry["n_events"] - dropped,
    )


def _assert_close(got, want, rtol: float, path: str = "") -> None:
    if isinstance(want, dict):
        assert got.keys() == want.keys(), path
        for k in want:
            _assert_close(got[k], want[k], rtol, f"{path}/{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_close(g, w, rtol, f"{path}[{i}]")
    elif isinstance(want, float):
        assert got == pytest.approx(want, rel=rtol, abs=rtol), path
    else:
        assert got == want, path


def test_per_scenario_names_are_the_reference_rule():
    cases = (("a/t.jsonl", "s", 2), ("t", "s", 2), ("t.json", "s", 1), (None, "s", 2))
    for args in cases:
        assert cli._per_scenario(*args) == ref_cli._per_scenario(*args)
    assert cli._per_scenario("out/t.jsonl", "gossip_hetero", 2) == (
        "out/t.gossip_hetero.jsonl"
    )


def test_two_scenarios_json_equals_the_reference_cli(tmp_path, monkeypatch, capsys):
    ours, theirs = _run_both(tmp_path, monkeypatch, capsys, observed=False)
    got = json.loads((ours / "bench.json").read_text())
    want = json.loads((theirs / "bench.json").read_text())
    assert list(got) == ["benchmark", "configs", "fast"]
    assert got["benchmark"] == "experiments" and got["fast"] is True
    assert list(got["configs"]) == sorted(SCENARIOS)
    assert got == want
    # sorted keys, two-space indent: the file itself is the reference's
    assert (ours / "bench.json").read_text() == (theirs / "bench.json").read_text()


def test_traced_two_scenarios_name_their_files_as_the_reference(
    tmp_path, monkeypatch, capsys
):
    ours, theirs = _run_both(tmp_path, monkeypatch, capsys, observed=True)
    names = sorted(p.name for p in ours.iterdir())
    assert names == sorted(p.name for p in theirs.iterdir())
    assert names == [
        "bench.json",
        "dash.gossip_hetero.html",
        "dash.plane_erb_only.html",
        "trace.gossip_hetero.jsonl",
        "trace.plane_erb_only.jsonl",
    ]
    got = json.loads((ours / "bench.json").read_text())
    want = json.loads((theirs / "bench.json").read_text())
    for name in SCENARIOS:
        g, w = got["configs"][name], want["configs"][name]
        g_extra, w_extra = g.pop("extra"), w.pop("extra")
        assert g == w
        assert g_extra.keys() == w_extra.keys() >= {"learning", "telemetry"}
        _assert_close(g_extra.pop("learning"), w_extra.pop("learning"), 1e-5)
        g_tel, w_tel = g_extra.pop("telemetry"), w_extra.pop("telemetry")
        _assert_close(_comparable(g_tel), _comparable(w_tel), 1e-5)
        assert g_extra == w_extra
