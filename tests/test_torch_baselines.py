"""The port's Table 1 baselines, synchronous FedAvg, lifelong trainer and
scenario plumbing against the reference's.

Each baseline builds its agent and trains it inside one function, so
nothing can inject weights in between: :func:`reference_init` makes
the port's ``FleetSteps.init_slot(seed)`` return the reference's init of
the same seed, converted.  From there both sides draw the same host
streams (patients, collection, replay plans) at the tiny widths of
``tests/test_torch_system.py``:

* Agents X, Y and M: every returned loss within 1e-4, final params
  within 1e-5, per-task evaluation within 1e-4 (a flipped argmax would
  move a distance by about a voxel);
* FedAvg over 2 rounds: after each round every agent's params equal
  agent 0's exactly, and agree with the reference's within 1e-5;
* ``LifelongTrainer``: the same batches, bit for bit.
"""

import dataclasses
import json
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: these sizes gain nothing from more, and spinning
# OpenMP threads in parallel test workers would starve the other tests
torch.set_num_threads(1)
jax = pytest.importorskip("jax")

import repro.core  # noqa: E402  (the reference's own import order)
from repro.configs.adfll_dqn import DQNConfig as JaxDQNConfig  # noqa: E402
from repro.core import erb as jax_erb  # noqa: E402
from repro.core import federated as jax_fed  # noqa: E402
from repro.rl import agent as jax_agent  # noqa: E402
from repro.rl.fleet import make_fleet_steps  # noqa: E402
from repro.rl.synth import paper_eight_tasks as jax_tasks  # noqa: E402
from repro_torch.configs.adfll_dqn import DQNConfig  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    dqn_params_to_numpy,
    fleet_state_from_numpy,
)
from repro_torch.core import erb as port_erb  # noqa: E402
from repro_torch.core import federated as port_fed  # noqa: E402
from repro_torch.core.experiment import ChurnEvent  # noqa: E402
from repro_torch.core.lifelong import LifelongTrainer  # noqa: E402
from repro_torch.experiments import SupportsChurn, System  # noqa: E402
from repro_torch.experiments import __main__ as cli  # noqa: E402
from repro_torch.experiments.registry import list_scenarios  # noqa: E402
from repro_torch.experiments.runner import build, run  # noqa: E402
from repro_torch.experiments.spec import ScenarioSpec  # noqa: E402
from repro_torch.experiments.systems import BaselineSystem, ServeSystem  # noqa: E402
from repro_torch.rl import agent as port_agent  # noqa: E402
from repro_torch.rl.fleet import FleetSteps  # noqa: E402
from repro_torch.rl.synth import paper_eight_tasks, patient_split  # noqa: E402

# the tiny widths of tests/test_torch_system.py
DQN_KW = dict(
    volume_shape=(12, 12, 12),
    box_size=(4, 4, 4),
    conv_features=(2,),
    hidden=(8,),
    batch_size=4,
    max_episode_steps=4,
)
CFG, JCFG = DQNConfig(**DQN_KW), JaxDQNConfig(**DQN_KW)
TRAIN_P, TEST_P = patient_split(16)
KW = dict(erb_capacity=256)


def reference_init(monkeypatch) -> None:
    """Make the port's fleet slots start from the reference's init."""

    def init_slot(self, seed):
        jcfg = JaxDQNConfig(**dataclasses.asdict(self.cfg))
        state = make_fleet_steps(jcfg).init_slot(seed)
        tree = {
            k: jax.tree_util.tree_map(np.asarray, getattr(state, k))
            for k in ("params", "target", "opt", "count")
        }
        return fleet_state_from_numpy(tree, self.device)

    monkeypatch.setattr(FleetSteps, "init_slot", init_slot)


@pytest.fixture
def ref_init(monkeypatch):
    reference_init(monkeypatch)


def record_losses(monkeypatch, agent_cls) -> list:
    """Record what ``train_steps`` and ``train_round`` return."""
    out = []
    steps, round_ = agent_cls.train_steps, agent_cls.train_round

    def train_steps(self, *a, **k):
        out.append(steps(self, *a, **k))
        return out[-1]

    def train_round(self, *a, **k):
        shared, loss = round_(self, *a, **k)
        out.append(loss)
        return shared, loss

    monkeypatch.setattr(agent_cls, "train_steps", train_steps)
    monkeypatch.setattr(agent_cls, "train_round", train_round)
    return out


def _params_close(port_params, ref_params, atol):
    got = jax.tree_util.tree_leaves(dqn_params_to_numpy(port_params))
    want = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, ref_params))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, atol=atol, rtol=0)


def _evals_close(ev, ev_ref):
    assert ev.keys() == ev_ref.keys()
    for task in ev:
        assert abs(ev[task] - ev_ref[task]) <= 1e-4


BASELINES = {
    "all_knowing": (
        jax_fed.train_all_knowing,
        port_fed.train_all_knowing,
        lambda tasks: (tasks[:3],),
        dict(steps_per_task=2),
        1,
    ),
    "partial": (
        jax_fed.train_partial,
        port_fed.train_partial,
        lambda tasks: (tasks[0],),
        dict(steps=3),
        1,
    ),
    "sequential": (
        jax_fed.train_sequential_ll,
        port_fed.train_sequential_ll,
        lambda tasks: (tasks[:3],),
        dict(steps_per_round=2),
        3,
    ),
}


@pytest.mark.parametrize("kind", sorted(BASELINES))
def test_baseline_matches_reference(kind, ref_init, monkeypatch):
    ref_fn, port_fn, task_arg, steps_kw, n_losses = BASELINES[kind]
    ref_losses = record_losses(monkeypatch, jax_agent.DQNAgent)
    losses = record_losses(monkeypatch, port_agent.DQNAgent)
    ref = ref_fn(JCFG, *task_arg(jax_tasks()), TRAIN_P, **steps_kw, **KW)
    port = port_fn(CFG, *task_arg(paper_eight_tasks()), TRAIN_P, **steps_kw, **KW,
                   device="cpu")
    assert port.agent_id == ref.agent_id and port.step_count == ref.step_count
    assert len(losses) == len(ref_losses) == n_losses
    np.testing.assert_allclose(losses, ref_losses, atol=1e-4, rtol=0)
    _params_close(port.params, ref.params, 1e-5)
    assert port.engine.n_chunk_steps == port.step_count  # one job of N = 1
    ev_ref = jax_fed.evaluate_on_tasks(ref, jax_tasks()[:2], TEST_P, JCFG,
                                       max_patients=2, n_episodes=2)
    ev = port_fed.evaluate_on_tasks(port, paper_eight_tasks()[:2], TEST_P, CFG,
                                    max_patients=2, n_episodes=2)
    _evals_close(ev, ev_ref)


def test_fedavg_matches_reference_round_by_round(ref_init):
    kw = dict(rounds=2, steps=2, erb_capacity=256, seed=400)
    ref = jax_fed.CentralAggregationSystem(3, JCFG, jax_tasks()[:4], TRAIN_P, **kw)
    port = port_fed.CentralAggregationSystem(
        3, CFG, paper_eight_tasks()[:4], TRAIN_P, **kw, device="cpu"
    )
    for r in range(2):
        ref.round(r)
        port.round(r)
        first = port.agents[0].params
        for a in port.agents:
            for key in first:
                for name in first[key]:
                    assert torch.equal(a.params[key][name], first[key][name])
                    assert torch.equal(a.target_params[key][name], first[key][name])
        for a, b in zip(port.agents, ref.agents):
            _params_close(a.params, b.params, 1e-5)
    # one flush a round, of the whole cohort
    assert port.engine.n_flushes == 2 and port.engine.flush_sizes == [3, 3]
    assert port.engine.n_chunk_steps == 4
    rep_ref = jax_fed.CentralAggregationSystem(
        3, JCFG, jax_tasks()[:4], TRAIN_P, **{**kw, "rounds": 1}
    ).run()
    rep = port_fed.CentralAggregationSystem(
        3, CFG, paper_eight_tasks()[:4], TRAIN_P, **{**kw, "rounds": 1}, device="cpu"
    ).run()
    for f in dataclasses.fields(rep):  # the reference's Report has more
        a, b = getattr(rep, f.name), getattr(rep_ref, f.name)
        assert a == b or (a != a and b != b), f.name  # nan == nan here
    assert json.dumps(rep.summary()) == json.dumps(rep_ref.summary())
    ev_ref = ref.evaluate(jax_tasks()[:2], TEST_P, max_patients=1, n_episodes=2)
    ev = port.evaluate(paper_eight_tasks()[:2], TEST_P, max_patients=1, n_episodes=2)
    assert list(ev) == list(ev_ref) == ["FedAvg"]
    _evals_close(ev["FedAvg"], ev_ref["FedAvg"])


def _filled_pair(rng, capacity, n, task_idx):
    """One reference ERB and one port ERB with the same rows."""
    box = CFG.box_size
    batch = {
        "obs": rng.random((n, *box)).astype(np.float32),
        "loc": rng.random((n, 3)).astype(np.float32),
        "action": rng.integers(0, 6, n).astype(np.int32),
        "reward": rng.standard_normal(n).astype(np.float32),
        "next_obs": rng.random((n, *box)).astype(np.float32),
        "next_loc": rng.random((n, 3)).astype(np.float32),
        "done": (rng.random(n) < 0.2).astype(np.float32),
    }
    ref = jax_erb.erb_init(capacity, box, task=jax_tasks()[task_idx])
    port = port_erb.erb_init(capacity, box, task=paper_eight_tasks()[task_idx])
    jax_erb.erb_add(ref, batch)
    port_erb.erb_add(port, batch)
    return ref, port


def test_lifelong_trainer_draws_the_reference_batches():
    rng = np.random.default_rng(0)
    pairs = [_filled_pair(rng, 64, n, i) for i, n in enumerate((40, 64, 17, 30))]
    sides = {}
    for side, trainer_cls in (
        ("ref", repro.core.LifelongTrainer),
        ("port", LifelongTrainer),
    ):
        seen = []

        def step(state, batch, seen=seen):
            seen.append({k: v.copy() for k, v in batch.items()})
            return state + 1, {"n": state}

        erbs = [p[0 if side == "ref" else 1] for p in pairs]
        tr = trainer_cls(step, 0, batch_size=8, rng=np.random.default_rng(3))
        out = [tr.steps(3, erbs[0]), tr.steps(2, erbs[1], incoming=(erbs[2],))]
        out.append(tr.steps(4, None, incoming=(erbs[3],)))
        sides[side] = (seen, out, tr.state, len(tr.personal), len(tr.seen_erb_ids))
    (seen_ref, *rest_ref), (seen, *rest) = sides["ref"], sides["port"]
    assert rest == rest_ref
    assert len(seen) == len(seen_ref) == 9
    for a, b in zip(seen, seen_ref):
        assert a.keys() == b.keys()
        for k in a:
            assert np.array_equal(a[k], b[k])


def test_baseline_system_protocol_and_errors():
    base = BaselineSystem("partial", CFG, paper_eight_tasks()[:1], TRAIN_P,
                          steps=2, device="cpu")
    assert isinstance(base, System) and not isinstance(base, SupportsChurn)
    with pytest.raises(RuntimeError, match="before run"):
        base.evaluate(paper_eight_tasks()[:1], TEST_P)
    with pytest.raises(ValueError, match="unknown baseline kind"):
        BaselineSystem("oracle", CFG, paper_eight_tasks(), TRAIN_P)
    fedavg = port_fed.CentralAggregationSystem(
        2, CFG, paper_eight_tasks(), TRAIN_P, rounds=1, device="cpu"
    )
    assert isinstance(fedavg, System) and not isinstance(fedavg, SupportsChurn)
    base.run()
    ev = base.evaluate(paper_eight_tasks()[:1], TEST_P, max_patients=1, n_episodes=1)
    assert list(ev) == ["AgentY"]


def test_unported_options_and_spec_validation(monkeypatch):
    # devices resolve over what the system's device names: a CPU cohort
    # gets no mesh, whatever the cards, and runs the single-device
    # engine, as in the reference; on the card the call names the cards
    for count in (0, 2):
        monkeypatch.setattr(torch.cuda, "device_count", lambda c=count: c)
        fed = port_fed.CentralAggregationSystem(
            2, CFG, paper_eight_tasks(), TRAIN_P, devices=2, device="cpu"
        )
        assert fed.engine.mesh is None and fed.engine.sharding.size == 1
    cards = (torch.device("cuda", 0), torch.device("cuda", 1))
    assert port_fed.make_fleet_mesh(2, device="cuda").devices == cards
    monkeypatch.undo()
    serve = ScenarioSpec(name="s", system="serve", dqn=CFG)
    served = build(serve, device="cpu")
    assert isinstance(served, ServeSystem) and isinstance(served, System)
    assert not isinstance(served, SupportsChurn)
    with pytest.raises(ValueError, match="unknown system"):
        ScenarioSpec(name="x", system="oracle")
    with pytest.raises(ValueError, match="unknown task_set"):
        ScenarioSpec(name="x", task_set="some")

    # a spec that carries a churn schedule: only the ADFLL system churns
    churn = (ChurnEvent(at=1.0, action="add"),)
    with pytest.raises(ValueError, match="supports no churn"):
        partial = ScenarioSpec(name="c", system="partial", dqn=CFG, churn=churn)
        build(partial, device="cpu")
    churned = build(ScenarioSpec(name="c", dqn=CFG, churn=churn), device="cpu")
    assert isinstance(churned, SupportsChurn) and churned._pending_churn == 1


@pytest.fixture
def tiny_registry(monkeypatch):
    """Every registered scenario cut to the tiny widths and depth."""
    from repro_torch.experiments import registry

    for spec in list_scenarios():
        tiny = dataclasses.replace(
            spec,
            dqn=CFG,
            sys=dataclasses.replace(spec.sys, erb_capacity=256, erb_share_size=32),
            n_tasks=2,
            eval_patients=1,
            eval_episodes=1,
            fast_train_steps=2,
        )
        monkeypatch.setitem(registry._REGISTRY, spec.name, tiny)


@pytest.mark.parametrize(
    "name, system, n_rounds, labels",
    [
        ("baseline_all_knowing", "all_knowing", 1, ["AgentX"]),
        ("baseline_partial", "partial", 1, ["AgentY"]),
        ("baseline_sequential", "sequential", 2, ["AgentM"]),
        ("fedavg_sync", "fedavg", 6, ["FedAvg"]),
    ],
)
def test_runner_and_cli_run_the_table1_scenarios(
    name, system, n_rounds, labels, tiny_registry, capsys
):
    report = run(name, fast=True, device="cpu")
    assert (report.scenario, report.system, report.n_rounds) == (name, system, n_rounds)
    assert list(report.task_errors) == labels
    assert all(len(errs) == 2 for errs in report.task_errors.values())
    assert np.isfinite(report.mean_dist_err)
    assert [p.mean_err for p in report.eval_curve] == [report.mean_dist_err]
    summary = report.summary()
    assert summary["n_rounds"] == n_rounds and summary["sim_makespan"] is None
    assert cli.main(["--scenario", name, "--fast", "--device", "cpu"]) == 0
    line = capsys.readouterr().out.splitlines()[0]
    m = re.fullmatch(rf"{name},mean_dist_err=([\d.]+),.*,n_rounds={n_rounds},.*", line)
    assert m and float(m.group(1)) == pytest.approx(report.mean_dist_err, abs=1e-3)


def test_cli_lists_the_scenarios(capsys):
    assert cli.main(["--list"]) == 0
    out = capsys.readouterr().out
    names = [line.split()[0] for line in out.splitlines()[1:]]
    assert names == [
        "baseline_all_knowing",
        "baseline_partial",
        "baseline_sequential",
        "churn_addition_fig4",
        "churn_deletion_fig5",
        "fedavg_sync",
        "flash_crowd",
        "gossip_hetero",
        "hospital_diurnal",
        "long_tail_stragglers",
        "paper_fig2",
        "paper_table2_hub_failure",
        "paper_table2_hybrid_failover",
        "paper_table2_total_failure",
        "plane_erb_only",
        "plane_hybrid",
        "plane_weight_only",
        "serve_localization",
        "topo_gossip",
        "topo_gossip_topk",
        "topo_hub",
        "topo_hybrid",
    ]
    assert cli.main(["--scenario", "baseline_partal"]) == 2
    assert "did you mean: baseline_partial" in capsys.readouterr().err
