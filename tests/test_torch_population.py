"""The port's population package and scenarios against the reference's.

System level (registry widths, ``--fast``, evaluation cut on both sides
alike as in ``test_torch_churn``): ``hospital_diurnal``, ``flash_crowd``
(1 + 20 agents at ``--fast``) and ``long_tail_stragglers`` give the
reference's round records, wire counts, gossip stats, probes, params and
``extra["population"]``, its ``timeline_digest`` included.

Unit level, bit for bit: the availability segments of every process
(Diurnal, Sessions with exp, lognormal and fixed lengths, Trace with
stagger and repeat) from the same per-member stream; ``from_churn``,
``event_times``, ``scaled``; trace files read by either package.  The
system: an offline agent defers its rounds until it is back, and
anti-entropy never samples an offline peer, as in the reference.
"""

import dataclasses
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: these sizes gain nothing from more, and spinning
# OpenMP threads in parallel test workers would starve the other tests
torch.set_num_threads(1)
jax = pytest.importorskip("jax")

import repro.core  # noqa: E402, F401  (the reference's own import order)
from repro import population as jax_pop  # noqa: E402
from repro.configs.adfll_dqn import ADFLLConfig as JaxADFLLConfig  # noqa: E402
from repro.configs.adfll_dqn import DQNConfig as JaxDQNConfig  # noqa: E402
from repro.core import experiment as jax_experiment  # noqa: E402
from repro.core.federated import ADFLLSystem as JaxADFLLSystem  # noqa: E402
from repro.rl.synth import paper_eight_tasks as jax_tasks  # noqa: E402
from repro_torch import population as pop  # noqa: E402
from repro_torch.configs.adfll_dqn import ADFLLConfig, DQNConfig  # noqa: E402
from repro_torch.core.experiment import ChurnEvent, HubFailure  # noqa: E402
from repro_torch.core.federated import ADFLLSystem  # noqa: E402
from repro_torch.rl.synth import paper_eight_tasks  # noqa: E402
from test_torch_baselines import reference_init  # noqa: E402
from test_torch_churn import (  # noqa: E402
    DQN_KW,
    TRAIN_P,
    assert_scenario_matches,
    run_scenario,
)


# ---------------------------------------------------------------------------
# the scenarios, end to end
# ---------------------------------------------------------------------------
@pytest.mark.parametrize(
    "name", ["hospital_diurnal", "flash_crowd", "long_tail_stragglers"]
)
def test_population_scenario_matches_reference(name, monkeypatch):
    ref, port = run_scenario(name, monkeypatch)
    assert_scenario_matches(ref, port)
    port_sys, rep = port
    summary = rep.extra["population"]
    assert summary == ref[1].extra["population"]
    assert summary["n_agents"] == len(port_sys.agents)
    if name == "flash_crowd":
        # 4 + 200 agents scaled by 0.1 at --fast: 1 + 20 on one engine
        assert summary["n_agents"] == 21 and port_sys.engine.capacity == 32
        assert [(p.t, p.n_agents) for p in rep.eval_curve] == [
            (1.0, 1),
            (rep.makespan, 21),
        ]
    else:
        assert summary["n_toggles"] > 0  # availability processes ran


# ---------------------------------------------------------------------------
# availability processes, bit for bit
# ---------------------------------------------------------------------------
def _both(kind, **kw):
    return getattr(pop, kind)(**kw), getattr(jax_pop, kind)(**kw)


AVAILABILITY = [
    ("Diurnal", dict(period=2.0, on_fraction=0.6, phase=0.0, jitter=0.1)),
    ("Diurnal", dict(period=2.0, on_fraction=0.6, phase=1.5, jitter=0.0)),
    ("Diurnal", dict(period=3.0, on_fraction=1.0)),
    ("Sessions", dict(mean_on=1.5, mean_off=0.5, distribution="exp")),
    ("Sessions", dict(mean_on=1.5, mean_off=0.5, distribution="lognormal")),
    ("Sessions", dict(mean_on=1.0, mean_off=0.25, distribution="fixed")),
    ("Trace", dict(windows=((0.5, 1.0), (2.0, 3.5)), stagger=0.25)),
    ("Trace", dict(windows=((0.0, 0.4), (1.0, 1.2)), repeat=2.0)),
    ("Trace", dict(windows=())),
]


@pytest.mark.parametrize("kind, kw", AVAILABILITY)
def test_availability_segments_match_reference(kind, kw):
    ours, ref = _both(kind, **kw)
    for member in range(3):
        got = list(
            itertools.islice(
                pop.availability_segments(ours, pop.member_rng(7, 1, member), member),
                40,
            )
        )
        want = list(
            itertools.islice(
                jax_pop.availability_segments(
                    ref, jax_pop.member_rng(7, 1, member), member
                ),
                40,
            )
        )
        assert got == want
        assert all(d >= 0.0 for d, _ in got)


def _canon(spec):
    return dataclasses.asdict(spec)


def test_population_spec_helpers_match_reference():
    churn = (
        (3.2, "add", dict(count=4, speed=2.0)),
        (1.6, "add", dict(count=4, hub=1)),
        (1.8, "remove", dict(count=2)),
        (4.0, "remove", dict(agent_id=3)),
    )
    fails = ((2.5, 1), (1.5, 0))
    ours = pop.PopulationSpec.from_churn(
        [ChurnEvent(at=t, action=a, **kw) for t, a, kw in churn],
        [HubFailure(at=t, hub_id=h) for t, h in fails],
    )
    ref = jax_pop.PopulationSpec.from_churn(
        [jax_experiment.ChurnEvent(at=t, action=a, **kw) for t, a, kw in churn],
        [jax_experiment.HubFailure(at=t, hub_id=h) for t, h in fails],
    )
    assert _canon(ours) == _canon(ref)
    assert ours.event_times() == ref.event_times()
    assert ours.n_agents == ref.n_agents == 8
    for frac in (1.0, 0.5, 0.1):
        assert _canon(ours.scaled(frac)) == _canon(ref.scaled(frac))
    crowd = pop.PopulationSpec(
        cohorts=(
            pop.Cohort(n_agents=4),
            pop.Cohort(n_agents=200, arrive_at=1.0, arrive_spread=1.5, depart_at=9.0),
        ),
        departures=(pop.Departure(at=5.0, count=3),),
        hub_outages=(pop.HubOutage(at=5.0, hub_id=0),),
    )
    assert crowd.event_times() == (0.0, 1.0, 5.0, 9.0)
    assert [c.n_agents for c in crowd.scaled(0.25).cohorts] == [1, 50]
    with pytest.raises(ValueError, match="empty population"):
        pop.PopulationSpec()
    with pytest.raises(ValueError, match="depart_at"):
        pop.Cohort(n_agents=1, arrive_at=2.0, depart_at=1.0)
    with pytest.raises(ValueError, match="disjoint"):
        pop.Trace(windows=((1.0, 2.0), (1.5, 3.0)))


def test_trace_files_round_trip_between_packages(tmp_path):
    windows = ((0.1, 0.30000000000000004), (1.0 / 3.0, 2.5), (7.0, 7.125))
    ours, theirs = tmp_path / "ours.jsonl", tmp_path / "theirs.jsonl"
    pop.save_windows(ours, windows)
    jax_pop.save_windows(theirs, windows)
    assert ours.read_text() == theirs.read_text()
    assert pop.load_windows(theirs) == jax_pop.load_windows(ours) == windows
    assert pop.Trace(windows=pop.load_windows(ours)).windows == windows
    (tmp_path / "bad.jsonl").write_text('{"on": 1.0}\n')
    with pytest.raises(ValueError, match="bad trace row"):
        pop.load_windows(tmp_path / "bad.jsonl")


# ---------------------------------------------------------------------------
# the system: offline agents, availability-aware gossip
# ---------------------------------------------------------------------------
SYS_KW = dict(rounds=3, train_steps_per_round=2)


def _pair(monkeypatch, **sys_kw):
    """The same small ADFLL system on both sides, from the reference's
    init."""
    reference_init(monkeypatch)
    ref = JaxADFLLSystem(
        JaxADFLLConfig(**SYS_KW, **sys_kw),
        JaxDQNConfig(**DQN_KW),
        jax_tasks(),
        TRAIN_P,
    )
    port = ADFLLSystem(
        ADFLLConfig(**SYS_KW, **sys_kw),
        DQNConfig(**DQN_KW),
        paper_eight_tasks(),
        TRAIN_P,
        device="cpu",
    )
    return ref, port


def _starts(report, agent_id):
    return [r.start for r in report.history if r.agent_id == agent_id]


def test_offline_agent_defers_its_rounds(monkeypatch):
    ref, port = _pair(monkeypatch, n_agents=2)
    for system in (ref, port):
        system.set_online(1, False)  # away before its first round
        system.sched.at(2.5, lambda s, t, sy=system: sy.set_online(1, True))
    rep_ref, rep = ref.run(), port.run()
    assert [dataclasses.astuple(r)[:6] for r in rep.history] == [
        dataclasses.astuple(r)[:6] for r in rep_ref.history
    ]
    # agent 1 starts nothing while offline, then resumes at t=2.5
    assert _starts(rep, 1)[0] == 2.5 and len(_starts(rep, 1)) == 3
    assert min(_starts(rep, 0)) == 0.0
    assert not port._deferred and port.agents[1].online


def test_anti_entropy_never_samples_an_offline_peer(monkeypatch):
    ref, port = _pair(
        monkeypatch,
        n_agents=4,
        topology="gossip",
        gossip_sampler="full",
        gossip_period=0.25,
    )
    asked = {"ref": [], "port": []}
    for key, system in (("ref", ref), ("port", port)):
        sampler = system.network.gossip.sampler
        peers = sampler.peers

        def spy(aid, ids, peers=peers, log=asked[key]):
            log.append((aid, tuple(ids)))
            return peers(aid, ids)

        sampler.peers = spy
        system.set_online(2, False)
        system.sched.at(1.1, lambda s, t, sy=system: sy.set_online(2, True))
    rep_ref, rep = ref.run(), port.run()
    assert asked["port"] == asked["ref"] and asked["port"]
    offline = [ids for _, ids in asked["port"][: 3 * 4]]
    assert all(2 not in ids for ids in offline)  # rounds before t=1.1
    assert any(2 in ids for _, ids in asked["port"])  # back online later
    assert rep.extra["gossip"] == rep_ref.extra["gossip"]
    assert [dataclasses.astuple(r)[:6] for r in rep.history] == [
        dataclasses.astuple(r)[:6] for r in rep_ref.history
    ]
    assert np.isfinite([r.loss for r in rep.history]).all()
