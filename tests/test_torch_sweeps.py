"""The port's sweep subsystem: deterministic grid expansion (within and
across processes), the JSONL report store and resume semantics, the
stats against the reference's on the same seeded inputs, significance-
aware aggregation, report diffing, the CLI, and a shrunk one-seed
``paper_table1_sweep`` against the reference's on the CPU.

Cell keys are not the reference's: the port's ``ScenarioSpec`` has
fewer fields, so the spec hash differs.  They must be stable across
processes all the same."""

import dataclasses
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: these sizes gain nothing from more, and spinning
# OpenMP threads in parallel test workers would starve the other tests
torch.set_num_threads(1)
pytest.importorskip("jax")

import repro.core  # noqa: E402, F401  (the reference's own import order)
from repro import sweeps as jax_sweeps  # noqa: E402
from repro.configs.adfll_dqn import DQNConfig as JaxDQNConfig  # noqa: E402
from repro.sweeps import stats as jax_stats  # noqa: E402
from repro_torch.configs.adfll_dqn import DQNConfig  # noqa: E402
from repro_torch.core.experiment import EvalPoint, Report  # noqa: E402
from repro_torch.experiments import runner  # noqa: E402
from repro_torch.sweeps import (  # noqa: E402
    ReportStore,
    SweepSpec,
    SweepVariant,
    apply_overrides,
    compare,
    default_workers,
    failed_cells,
    forgetting_of,
    get_sweep,
    list_sweeps,
    register_sweep,
    run_sweep,
    stats,
    summarize,
)
from repro_torch.sweeps.__main__ import main as sweeps_cli_main  # noqa: E402
from repro_torch.sweeps.store import (  # noqa: E402
    STATUS_BUDGET,
    STATUS_ERROR,
    STATUS_OK,
)
from test_torch_baselines import DQN_KW, reference_init  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


# ---------------------------------------------------------------------------
# grid expansion determinism
# ---------------------------------------------------------------------------
def test_expansion_is_deterministic_and_fast_variant_is_distinct():
    sw = get_sweep("paper_table1_sweep")
    g1, g2 = sw.expand(fast=True), sw.expand(fast=True)
    assert [c.key for c in g1] == [c.key for c in g2]
    # variants outer, seeds inner
    assert [(c.label, c.seed) for c in g1] == [
        (v.label, s) for v in sw.variants for s in sw.seeds
    ]
    # the fast grid must never collide with the full grid in the store
    full = {c.key for c in sw.expand(fast=False)}
    assert full.isdisjoint({c.key for c in g1})
    # every cell spec carries its own seed (spec and sys in lockstep)
    for c in g1:
        assert c.spec.seed == c.seed and c.spec.sys.seed == c.seed
        assert c.spec.sys.train_steps_per_round == 20


def test_expansion_keys_are_stable_across_processes():
    """The store key must not depend on PYTHONHASHSEED or process state —
    resuming an interrupted sweep from another process hinges on it."""
    sw = get_sweep("paper_table1_sweep")
    here = [c.key for c in sw.expand(fast=True)]
    code = (
        "from repro_torch.sweeps import get_sweep;"
        "print('\\n'.join(c.key for c in "
        "get_sweep('paper_table1_sweep').expand(fast=True)))"
    )
    out = subprocess.run(
        [sys.executable, "-c", code],
        capture_output=True,
        text=True,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"), PYTHONHASHSEED="271828"),
        stdin=subprocess.DEVNULL,
        timeout=300,
        check=True,
    )
    assert out.stdout.split() == here


def test_apply_overrides_nested_and_unknown_paths():
    base = get_sweep("paper_table1_sweep").expand()[0].spec
    over = apply_overrides(base, (("dqn.batch_size", 4), ("n_patients", 8)))
    assert over.dqn.batch_size == 4 and over.n_patients == 8
    with pytest.raises(ValueError, match="no field"):
        apply_overrides(base, (("sys.bogus_field", 1),))
    with pytest.raises(ValueError, match="no field"):
        apply_overrides(base, (("bogus", 1),))


def test_sweep_spec_validation():
    v = SweepVariant("a", "paper_fig2")
    with pytest.raises(ValueError, match="duplicate"):
        SweepSpec(name="x", variants=(v, SweepVariant("a", "baseline_partial")))
    with pytest.raises(ValueError, match="seed"):
        SweepSpec(name="x", variants=(v,), seeds=())
    with pytest.raises(ValueError, match="baseline"):
        SweepSpec(name="x", variants=(v,), baseline="nope")
    with pytest.raises(ValueError, match="no variants"):
        SweepSpec(name="x")
    with pytest.raises(ValueError, match="already registered"):
        register_sweep(get_sweep("paper_table1_sweep"))


def test_table1_sweep_is_the_references():
    assert [s.name for s in list_sweeps()] == [
        "ci_smoke",
        "paper_table1_sweep",
        "paper_table2_hub_failure",
    ]
    ours, ref = get_sweep("paper_table1_sweep"), jax_sweeps.get_sweep(
        "paper_table1_sweep"
    )
    assert [dataclasses.astuple(v) for v in ours.variants] == [
        dataclasses.astuple(v) for v in ref.variants
    ]
    assert (ours.seeds, ours.baseline, ours.metrics, ours.cell_budget_s) == (
        ref.seeds,
        ref.baseline,
        ref.metrics,
        ref.cell_budget_s,
    )


# ---------------------------------------------------------------------------
# stats: identical to the reference's on the same seeded inputs
# ---------------------------------------------------------------------------
def _same(a, b):
    if isinstance(a, tuple | list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif a is None or b is None:
        assert a is b
    else:
        assert a == b or (math.isnan(a) and math.isnan(b))


@pytest.mark.parametrize("n", [0, 1, 2, 5, 9, 20])
def test_stats_match_the_reference_bit_for_bit(n):
    rng = np.random.default_rng(n)
    a = list(rng.normal(7.0, 1.0, n))
    b = list(np.array(a) + rng.normal(0.5, 0.4, n))
    p = [None, *rng.random(n).tolist()]
    calls = [
        ("mean_ci", (a,), {}),
        ("mean_ci", (a,), {"confidence": 0.9}),
        ("paired_ttest", (a, b), {}),
        ("paired_ttest", (a, a), {}),
        ("paired_permutation_test", (a, b), {}),
        ("paired_permutation_test", (a, b), {"n_resamples": 64, "seed": 3}),
        ("cohens_d", (a, b), {}),
        ("bootstrap_ci", ([x - y for x, y in zip(a, b)],), {"seed": 1}),
        ("holm_bonferroni", (p,), {}),
        ("t_sf", (float(n) - 2.5, max(n, 1)), {}),
        ("t_crit", (0.05, n), {}),
    ]
    for name, args, kw in calls:
        _same(getattr(stats, name)(*args, **kw), getattr(jax_stats, name)(*args, **kw))


# ---------------------------------------------------------------------------
# report store
# ---------------------------------------------------------------------------
def _row(key, status=STATUS_OK, err=7.0, seed=0, label="v"):
    return {
        "key": key,
        "label": label,
        "scenario": "s",
        "seed": seed,
        "status": status,
        "elapsed_s": 0.1,
        "summary": {"mean_dist_err": err},
    }


def test_store_roundtrip_last_row_wins_and_torn_tail(tmp_path):
    store = ReportStore(tmp_path / "s.jsonl")
    assert store.load() == {}
    store.append(_row("k1", status=STATUS_ERROR))
    store.append(_row("k2"))
    store.append(_row("k1"))  # retry superseded the failure
    with open(store.path, "a") as f:
        f.write('{"key": "k3", "status"')  # crash mid-append
    rows = store.load()
    assert set(rows) == {"k1", "k2"}
    assert rows["k1"]["status"] == STATUS_OK
    assert set(store.completed()) == {"k1", "k2"}
    with pytest.raises(ValueError):
        store.append({"status": "ok"})
    assert store.prune(["k2"]) == 1
    assert set(store.load()) == {"k2"}


# ---------------------------------------------------------------------------
# executor: resume, budgets, failures (runner stubbed; workers=1 inline)
# ---------------------------------------------------------------------------
def _tiny_sweep(**kw):
    base = dict(
        name="t",
        variants=(
            SweepVariant("a", "paper_fig2"),
            SweepVariant("b", "baseline_partial"),
        ),
        seeds=(0, 1),
        baseline="a",
    )
    base.update(kw)
    return SweepSpec(**base)


def _fake_report(spec):
    rep = Report(scenario=spec.name, system=spec.system, seed=spec.seed)
    rep.mean_dist_err = 5.0 + spec.seed + (0.5 if "partial" in spec.name else 0.0)
    rep.best_agent_err = rep.mean_dist_err
    rep.makespan = 2.0
    rep.eval_curve = [EvalPoint(t=2.0, n_agents=1, mean_err=rep.mean_dist_err)]
    return rep


def test_run_sweep_executes_resumes_and_aggregates(tmp_path, monkeypatch):
    calls = []

    def fake_run(spec, **kw):
        calls.append((spec.name, kw))
        return _fake_report(spec)

    monkeypatch.setattr(runner, "run", fake_run)
    sw = _tiny_sweep()
    store = ReportStore(tmp_path / "t.jsonl")
    summary = run_sweep(sw, workers=1, store=store, device="cpu")
    assert len(calls) == 4 and not failed_cells(summary)
    assert all(kw == {"device": "cpu"} for _, kw in calls)  # the cell's device
    assert summary["variants"]["a"]["n_ok"] == 2
    st = summary["variants"]["a"]["metrics"]["mean_dist_err"]
    assert st["mean"] == pytest.approx(5.5) and st["n"] == 2
    assert st["values"] == {"0": 5.0, "1": 6.0}
    comps = {(c["variant"], c["metric"]): c for c in summary["comparisons"]}
    assert comps[("b", "mean_dist_err")]["delta"] == pytest.approx(0.5)

    assert summary["device"] == "cpu"
    assert {c["device"] for c in summary["cells"]} == {"cpu"}

    # resume: all four cells cached, nothing re-executed
    calls.clear()
    summary2 = run_sweep(sw, workers=1, store=store, device="cpu")
    assert calls == []
    assert all(c["cached"] for c in summary2["cells"])
    assert summary2["variants"] == summary["variants"]

    # the card's cells are not the CPU's: every one runs, on the card
    summary_card = run_sweep(sw, workers=1, store=store)
    assert [kw for _, kw in calls] == [{"device": None}] * 4  # None = the card
    assert not any(c["cached"] for c in summary_card["cells"])
    assert summary_card["device"] == "cuda"
    assert {c["device"] for c in summary_card["cells"]} == {"cuda"}
    cpu_keys = {c.key for c in sw.expand(device="cpu")}
    card_keys = {c.key for c in sw.expand()}
    assert cpu_keys.isdisjoint(card_keys)
    assert set(store.completed()) == cpu_keys | card_keys  # both kept apart

    # partial resume: drop one card cell from the store -> exactly one re-runs
    calls.clear()
    keys = [c.key for c in sw.expand()]
    store.prune([*keys[1:], *cpu_keys])
    summary3 = run_sweep(sw, workers=1, store=store)
    assert [name for name, _ in calls] == ["paper_fig2"]
    assert calls[0][1] == {"device": None}
    assert sum(not c["cached"] for c in summary3["cells"]) == 1
    calls.clear()
    run_sweep(sw, workers=1, store=store, device="cpu")
    assert calls == []  # the CPU rows survived the card's runs


def test_default_workers_is_a_pool_of_up_to_four():
    # four workers on one card beat inline on the full-depth sweep (PERF.md)
    assert default_workers(20) == max(1, min(4, os.cpu_count() or 1))
    assert default_workers(1) == 1
    assert default_workers(0) == 1


def test_budget_exceeded_marks_the_cell_failed(monkeypatch):
    def slow_run(spec, **kw):
        time.sleep(5.0)  # far past the budget: the alarm must interrupt
        return _fake_report(spec)

    monkeypatch.setattr(runner, "run", slow_run)
    sw = _tiny_sweep(seeds=(0,), cell_budget_s=0.05)
    t0 = time.monotonic()
    summary = run_sweep(sw, workers=1)
    bad = failed_cells(summary)
    assert len(bad) == 2
    assert all(c["status"] == STATUS_BUDGET for c in bad)
    # enforcement is real: the cells were interrupted, not slept to completion
    assert time.monotonic() - t0 < 4.0
    assert summary["variants"]["a"]["n_ok"] == 0
    assert summary["variants"]["a"]["metrics"]["mean_dist_err"]["mean"] is None


def test_worker_exception_records_an_error_cell(tmp_path, monkeypatch):
    def boom(spec, **kw):
        raise RuntimeError("kaboom")

    monkeypatch.setattr(runner, "run", boom)
    sw = _tiny_sweep(seeds=(0,))
    store = ReportStore(tmp_path / "t.jsonl")
    summary = run_sweep(sw, workers=1, store=store)
    bad = failed_cells(summary)
    assert {c["status"] for c in bad} == {STATUS_ERROR}
    assert "kaboom" in bad[0]["error"]
    # failed rows persist but do not count as completed -> retried next run
    assert store.completed() == {}

    monkeypatch.setattr(runner, "run", lambda spec, **kw: _fake_report(spec))
    summary2 = run_sweep(sw, workers=1, store=store)
    assert not failed_cells(summary2)


# ---------------------------------------------------------------------------
# aggregation + compare
# ---------------------------------------------------------------------------
def test_forgetting_of_curve_shapes():
    def s(errs):
        return {"eval_curve": [{"mean_err": e} for e in errs]}

    assert forgetting_of(s([8.0, 5.0, 7.0])) == pytest.approx(2.0)
    assert forgetting_of(s([8.0, 5.0])) == 0.0  # final is the best
    assert forgetting_of(s([6.0])) == 0.0
    assert forgetting_of({"eval_curve": []}) is None


def _summary_with(err_by_label_seed, sweep):
    rows = []
    for (label, seed), err in err_by_label_seed.items():
        cell = next(c for c in sweep.expand() if c.label == label and c.seed == seed)
        rows.append(_row(cell.key, err=err, seed=seed, label=label))
    return summarize(sweep, rows)


def test_compare_flags_significant_regressions(tmp_path):
    sw = _tiny_sweep(seeds=(0, 1, 2, 3, 4), baseline=None)
    a = _summary_with(
        {("a", s): 7.0 + 0.1 * s for s in range(5)}
        | {("b", s): 7.0 + 0.1 * s for s in range(5)},
        sw,
    )
    b = _summary_with(
        {("a", s): 7.0 + 0.1 * s for s in range(5)}  # unchanged
        | {("b", s): 12.0 + 0.3 * s for s in range(5)},  # much worse
        sw,
    )
    rows, regs = compare(a, b)
    assert len(regs) == 1
    assert regs[0]["variant"] == "b" and regs[0]["metric"] == "mean_dist_err"
    assert regs[0]["p_ttest"] < 0.05 and regs[0]["delta"] == pytest.approx(5.4)
    # an improvement is significant but NOT a regression
    rows_back, regs_back = compare(b, a)
    assert regs_back == []
    assert any(r["significant"] and not r["regression"] for r in rows_back)
    # one seed cannot reach significance
    one = _tiny_sweep(seeds=(0,), baseline=None)
    rows1, regs1 = compare(
        _summary_with({("a", 0): 7.0, ("b", 0): 7.0}, one),
        _summary_with({("a", 0): 7.0, ("b", 0): 12.0}, one),
    )
    assert regs1 == [] and all(r["p_ttest"] is None for r in rows1)

    # the CLI wires this to exit codes
    pa, pb = tmp_path / "a.json", tmp_path / "b.json"
    pa.write_text(json.dumps(a))
    pb.write_text(json.dumps(b))
    assert sweeps_cli_main(["--compare", str(pa), str(pa)]) == 0
    assert sweeps_cli_main(["--compare", str(pa), str(pb)]) == 1
    empty = tmp_path / "empty.json"
    empty.write_text(json.dumps({"variants": {}}))
    assert sweeps_cli_main(["--compare", str(pa), str(empty)]) == 2


def test_sweeps_cli_list_and_unknown_name(capsys):
    assert sweeps_cli_main(["--list"]) == 0
    assert "paper_table1_sweep" in capsys.readouterr().out
    assert sweeps_cli_main(["--sweep", "paper_table1_swep"]) == 2
    assert "did you mean: paper_table1_sweep" in capsys.readouterr().err
    assert sweeps_cli_main(["--sweep", "paper_table1_sweep", "--seeds", "0"]) == 2
    assert sweeps_cli_main(["--sweep", "paper_table1_sweep", "--budget", "0"]) == 2


def test_sweeps_cli_default_store_is_the_ports(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(runner, "run", lambda spec, **kw: _fake_report(spec))
    monkeypatch.chdir(tmp_path)
    args = ["--sweep", "paper_table1_sweep", "--seeds", "1", "--workers", "1"]
    assert sweeps_cli_main([*args, "--fast", "--device", "cpu"]) == 0
    assert (tmp_path / ".sweeps" / "torch_paper_table1_sweep.fast.jsonl").exists()
    assert "agent_m_sequential" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# a shrunk one-seed Table 1 sweep against the reference's
# ---------------------------------------------------------------------------
def _shrunk(sweep, dqn):
    over = (("dqn", dqn), ("n_tasks", 2), ("eval_patients", 2), ("eval_episodes", 2))
    return dataclasses.replace(
        sweep,
        seeds=(0,),
        variants=tuple(dataclasses.replace(v, overrides=over) for v in sweep.variants),
    )


def test_shrunk_table1_sweep_matches_reference(monkeypatch):
    reference_init(monkeypatch)
    ref = jax_sweeps.run_sweep(
        _shrunk(jax_sweeps.get_sweep("paper_table1_sweep"), JaxDQNConfig(**DQN_KW)),
        fast=True,
        workers=1,
    )
    port = run_sweep(
        _shrunk(get_sweep("paper_table1_sweep"), DQNConfig(**DQN_KW)),
        fast=True,
        workers=1,
        device="cpu",
    )
    assert not failed_cells(port)
    assert [(c["label"], c["status"]) for c in port["cells"]] == [
        (c["label"], c["status"]) for c in ref["cells"]
    ]
    assert list(port["variants"]) == list(ref["variants"])
    for label, v in port["variants"].items():
        got = v["metrics"]["mean_dist_err"]["mean"]
        want = ref["variants"][label]["metrics"]["mean_dist_err"]["mean"]
        assert abs(got - want) <= 1e-4, label
    assert [(c["variant"], c["metric"]) for c in port["comparisons"]] == [
        (c["variant"], c["metric"]) for c in ref["comparisons"]
    ]
