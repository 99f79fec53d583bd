"""The port's hub failures (the paper's Table 2) against the reference's.

System level (registry widths, ``--fast``, evaluation cut on both sides
alike as in ``test_torch_churn``): the three Table 2 rows give the
reference's records, wire counts, gossip stats, probes and params; the
probe at t = 1.5 sees the pre-failure system, hub 2 strands agents 2 and
3, and the hybrid overlay keeps delivering after every hub is dead.

Transport level, exact: hub death, orphan re-homing, orphan pushes and
pulls, and the hub-hub sync over live hubs only draw the same dropout
stream as the reference's.  The registry's eight churn, hub-failure and
population scenarios and the ``paper_table2_hub_failure`` sweep are the
reference's, field for field, and the CLIs list and print them.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: these sizes gain nothing from more, and spinning
# OpenMP threads in parallel test workers would starve the other tests
torch.set_num_threads(1)
jax = pytest.importorskip("jax")

import repro.core  # noqa: E402, F401  (the reference's own import order)
from repro import sweeps as jax_sweeps  # noqa: E402
from repro.core import erb as jax_erb  # noqa: E402
from repro.core import hub as jax_hub  # noqa: E402
from repro.core import network as jax_network  # noqa: E402
from repro.experiments import registry as jax_registry  # noqa: E402
from repro_torch.configs.adfll_dqn import ADFLLConfig, DQNConfig  # noqa: E402
from repro_torch.core import erb, hub, network  # noqa: E402
from repro_torch.core.experiment import CommLog, HubFailure  # noqa: E402
from repro_torch.experiments import __main__ as cli  # noqa: E402
from repro_torch.experiments import registry  # noqa: E402
from repro_torch.experiments.runner import run  # noqa: E402
from repro_torch.experiments.spec import ScenarioSpec  # noqa: E402
from repro_torch.sweeps import __main__ as sweeps_cli  # noqa: E402
from repro_torch.sweeps import get_sweep  # noqa: E402
from test_torch_churn import (  # noqa: E402
    DQN_KW,
    SYS_KW,
    FailureLog,
    assert_scenario_matches,
    cut_spec,
    run_scenario,
)


# ---------------------------------------------------------------------------
# the Table 2 rows, end to end
# ---------------------------------------------------------------------------
@pytest.mark.parametrize(
    "name",
    [
        "paper_table2_hub_failure",
        "paper_table2_total_failure",
        "paper_table2_hybrid_failover",
    ],
)
def test_table2_scenario_matches_reference(name, monkeypatch):
    log = FailureLog()
    ref, port = run_scenario(name, monkeypatch, hooks=(log,))
    assert_scenario_matches(ref, port)
    port_sys, rep = port
    # the probe at t=1.5 sees the pre-failure system
    assert (rep.eval_curve[0].t, rep.eval_curve[0].n_agents) == (1.5, 4)
    hubs = [h for h, _, _ in log.failures]
    if name == "paper_table2_hub_failure":
        assert log.failures == [(2, [2, 3], 1.5)]
        assert set(port_sys.network.agent_hub.values()) == {0, 1}
    else:
        assert hubs == [0, 1, 2] and port_sys.network.agent_hub == {}
        assert not any(h.alive for h in port_sys.network.hubs)
    if name == "paper_table2_hybrid_failover":
        # the overlay keeps carrying records after every hub is dead
        assert rep.extra["gossip"]["delivered"] > 0


def test_registry_specs_are_the_references():
    for name in (
        "churn_addition_fig4",
        "churn_deletion_fig5",
        "paper_table2_hub_failure",
        "paper_table2_total_failure",
        "paper_table2_hybrid_failover",
        "hospital_diurnal",
        "flash_crowd",
        "long_tail_stragglers",
        "serve_localization",
    ):
        ours = dataclasses.asdict(registry.get_scenario(name))
        ref = dataclasses.asdict(jax_registry.get_scenario(name))
        assert (ref["serve_traffic"] is None) == (name != "serve_localization")
        assert ours == ref, name
        assert dataclasses.asdict(
            registry.get_scenario(name).fast()
        ) == dataclasses.asdict(jax_registry.get_scenario(name).fast())


def test_table2_sweep_is_the_references():
    ours = get_sweep("paper_table2_hub_failure")
    ref = jax_sweeps.get_sweep("paper_table2_hub_failure")
    assert [dataclasses.astuple(v) for v in ours.variants] == [
        dataclasses.astuple(v) for v in ref.variants
    ]
    assert (ours.seeds, ours.baseline, ours.metrics, ours.cell_budget_s) == (
        ref.seeds,
        ref.baseline,
        ref.metrics,
        ref.cell_budget_s,
    )
    assert [c.label for c in ours.expand(fast=True, device="cpu")][:5] == [
        "control"
    ] * 5


def test_cli_prints_every_probe_point(capsys):
    assert cli.main(["--list"]) == 0
    listing = capsys.readouterr().out.splitlines()[1:]
    assert len(listing) == 22
    spec = cut_spec(registry.get_scenario("paper_table2_hub_failure").fast())
    report = run(spec, device="cpu")
    assert [(p.t, p.n_agents) for p in report.eval_curve][0] == (1.5, 4)
    assert len(report.eval_curve) == 2
    assert sweeps_cli.main(["--list"]) == 0
    assert "paper_table2_hub_failure" in capsys.readouterr().out

# ---------------------------------------------------------------------------
# transport level: hub death, orphans, the sync over live hubs
# ---------------------------------------------------------------------------
TASK = erb.TaskTag("t1", "axial", "HGG")
JAX_TASK = jax_erb.TaskTag("t1", "axial", "HGG")


def _erb_pair(i, source_agent=0):
    """The same small ERB for both packages, under one fixed id."""
    rng = np.random.default_rng(i)
    out = []
    for pkg, task in ((erb, TASK), (jax_erb, JAX_TASK)):
        e = pkg.erb_init(4, (2, 2, 2), task=task, source_agent=source_agent)
        e.data["obs"][:] = rng.standard_normal(e.data["obs"].shape)
        e.meta = dataclasses.replace(e.meta, erb_id=f"E_{i:04d}", size=4)
        e.size = 4
        out.append(e)
    return out


def _networks(n_hubs, dropout, topology="hub"):
    nets = []
    for pkg, hub_pkg in ((network, hub), (jax_network, jax_hub)):
        nets.append(
            pkg.Network(
                hubs=[hub_pkg.Hub(h) for h in range(n_hubs)],
                dropout=dropout,
                rng=np.random.default_rng(5),
                topology=topology,
            )
        )
    return nets


def _stores(net):
    return [
        (h.hub_id, h.alive, sorted(h.store("erb"))) for h in net.hubs
    ] + [dict(net.agent_hub), net.n_pushed, net.n_dropped, net.n_synced]


def test_hub_failure_transport_matches_reference():
    """Pushes, pulls and syncs under 50 % dropout around two hub deaths
    (one re-homing, then the last): the same draws, drops, stores,
    orphans and bytes as the reference."""
    ours, ref = _networks(3, 0.5)
    for net in (ours, ref):
        for a in range(6):
            net.attach_agent(a)
    seen = {a: set() for a in range(6)}
    n = 0
    for step in range(6):
        for a in range(6):
            mine, theirs = _erb_pair(n, a)
            n += 1
            assert ours.agent_push(a, mine).delivered == ref.agent_push(a, theirs).delivered
            got = ours.agent_pull(a, seen[a])
            want = ref.agent_pull(a, set(seen[a]))
            assert [e.meta.erb_id for e in got.records] == [
                e.meta.erb_id for e in want
            ]
            assert (got.comm_time, got.nbytes) == (want.comm_time, want.nbytes)
            seen[a] |= {e.meta.erb_id for e in got.records}
        assert ours.sync() == ref.sync()
        if step == 2:
            assert ours.fail_hub(1) == ref.fail_hub(1) == [1, 4]
        if step == 4:
            assert ours.fail_hub(0) == ref.fail_hub(0)
            assert ours.fail_hub(2) == ref.fail_hub(2)
        assert _stores(ours) == _stores(ref)
    assert ours.meter.bytes_by_plane == ref.meter.bytes_by_plane
    assert ours.meter.msgs_by_plane == ref.meter.msgs_by_plane
    assert ours.all_known() == ref.all_known() == set()
    assert ours.rng.random() == ref.rng.random()  # the streams stayed aligned


def test_orphaned_agents_cannot_push_or_pull_via_dead_hubs():
    net = network.Network(hubs=[hub.Hub(0)], rng=np.random.default_rng(0))
    net.attach_agent(0, 0)
    assert net.agent_push(0, _erb_pair(0)[0])
    assert net.fail_hub(0) == [0]
    assert 0 not in net.agent_hub  # no survivor to re-home to
    res = net.agent_push(0, _erb_pair(1)[0])
    assert not res.delivered and res.nbytes == 0
    assert net.agent_pull(0, set()).records == ()
    assert net.n_dropped >= 1
    # a joiner after total failure stays detached instead of crashing
    net.attach_agent(1)
    assert 1 not in net.agent_hub
    assert not net.agent_push(1, _erb_pair(2)[0]).delivered
    dead = net.hubs[0]
    assert not dead.alive and dead.stores == {} and dead.snapshot() == []
    assert dead.pull_unseen(set()) == []


def test_hub_failure_loses_only_unique_erbs_and_rehomes():
    net = network.Network(hubs=[hub.Hub(0), hub.Hub(1)])
    net.attach_agent(0, 0)
    net.attach_agent(1, 1)
    e1, e2, e3 = (_erb_pair(i)[0] for i in range(3))
    net.agent_push(0, e1)
    net.sync()  # replicated on hub 1
    net.agent_push(0, e2)  # only on hub 0
    assert [r["erb_id"] for r in net.hubs[0].snapshot()] == ["E_0000", "E_0001"]
    assert net.fail_hub(0) == [0]
    known = net.all_known("erb")
    assert "E_0000" in known and "E_0001" not in known
    assert net.agent_hub[0] == 1  # re-homed to the survivor
    # a departing agent's shares stay in the hub database
    net.agent_push(1, e3)
    net.detach_agent(1)
    assert "E_0002" in net.hubs[1].database and 1 not in net.agent_hub
    assert [e.meta.erb_id for e in net.agent_pull(0, set()).records] == [
        "E_0000",
        "E_0002",
    ]

# ---------------------------------------------------------------------------
# the runner: hooks and probes
# ---------------------------------------------------------------------------
def test_hub_failure_hook_and_probe_through_the_runner():
    dqn = DQNConfig(**DQN_KW)
    spec = ScenarioSpec(
        name="tiny_hub_failure",
        n_tasks=2,
        n_patients=8,
        dqn=dqn,
        sys=ADFLLConfig(
            **SYS_KW, n_agents=2, n_hubs=2, agent_hub=(0, 1), agent_speed=()
        ),
        hub_failures=(HubFailure(at=0.7, hub_id=1),),
        eval_patients=1,
        eval_episodes=1,
    )
    log, comm = FailureLog(), CommLog()
    report = run(spec, seed=3, hooks=(log, comm), device="cpu")
    assert log.failures == [(1, [1], 0.7)]  # agent 1 orphaned at t=0.7
    # one push a finished round, all delivered: the orphan re-homed
    assert len(comm.rows) == report.n_rounds == 4
    assert sum(r["delivered"] for r in comm.rows) == report.plane_pushed["erb"]
    assert (report.eval_curve[0].t, report.eval_curve[0].n_agents) == (0.7, 2)
    assert len(report.eval_curve) == 2 and np.isfinite(report.mean_dist_err)
    no_probe = run(
        dataclasses.replace(spec, eval_at_churn=False), seed=3, device="cpu"
    )
    assert len(no_probe.eval_curve) == 1
    assert no_probe.history == report.history  # probes consume no stream

