"""The port's agent departures (the paper's Fig 5) against the reference's.

``churn_deletion_fig5`` (registry widths, ``--fast``, evaluation cut on
both sides alike as in ``test_torch_churn``, and 4 train steps a round
instead of 12): 24 agents leave down to 1 under 75 % dropout, newest
first.  Round records, wire counts, probes and every agent's params
(departed agents included) match the reference's as in
``test_torch_churn``; departed slots stay resident, so the fleet's
flushes cover a strict subset of its rows.  The last probe and the
final point share t = 7.2.

Unit level: removing unknown or departed ids and removing from an empty
membership apply as the reference's do, and evaluation covers live
agents only.
"""

import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: these sizes gain nothing from more, and spinning
# OpenMP threads in parallel test workers would starve the other tests
torch.set_num_threads(1)
jax = pytest.importorskip("jax")

import repro.core  # noqa: E402, F401  (the reference's own import order)
from repro.configs.adfll_dqn import ADFLLConfig as JaxADFLLConfig  # noqa: E402
from repro.configs.adfll_dqn import DQNConfig as JaxDQNConfig  # noqa: E402
from repro.core import experiment as jax_experiment  # noqa: E402
from repro.core.federated import ADFLLSystem as JaxADFLLSystem  # noqa: E402
from repro.rl.synth import paper_eight_tasks as jax_tasks  # noqa: E402
from repro_torch.configs.adfll_dqn import ADFLLConfig, DQNConfig  # noqa: E402
from repro_torch.core.experiment import ChurnEvent  # noqa: E402
from repro_torch.core.federated import ADFLLSystem  # noqa: E402
from repro_torch.rl.synth import paper_eight_tasks  # noqa: E402
from test_torch_churn import (  # noqa: E402
    DQN_KW,
    SYS_KW,
    TEST_P,
    TRAIN_P,
    FailureLog,
    assert_scenario_matches,
    run_scenario,
)


def test_churn_deletion_fig5_matches_reference(monkeypatch):
    log = FailureLog()
    ref, port = run_scenario(
        "churn_deletion_fig5", monkeypatch, train_steps=4, hooks=(log,)
    )
    assert_scenario_matches(ref, port)
    port_sys, rep = port
    # 24 -> 1 agents, newest first; departed slots stay resident
    assert [len(ids) for _, ids, _ in log.churn] == [12, 6, 3, 2]
    assert log.churn[0][1] == list(range(23, 11, -1))
    assert list(port_sys.live_agents()) == [0]
    assert port_sys.engine.capacity == 32
    assert max(port_sys.engine.flush_sizes[-3:]) < port_sys.engine.n_slots
    assert [(p.t, p.n_agents) for p in rep.eval_curve] == [
        (1.8, 24),
        (3.6, 12),
        (5.4, 6),
        (7.2, 3),
        (7.2, 1),
    ]


def test_churn_removal_of_unknown_ids_and_empty_membership():
    ref = JaxADFLLSystem(
        JaxADFLLConfig(**SYS_KW, n_agents=2),
        JaxDQNConfig(**DQN_KW),
        jax_tasks(),
        TRAIN_P,
    )
    port = ADFLLSystem(
        ADFLLConfig(**SYS_KW, n_agents=2),
        DQNConfig(**DQN_KW),
        paper_eight_tasks(),
        TRAIN_P,
        device="cpu",
    )
    events = [
        ("remove", dict(agent_id=7)),  # unknown id: nothing to remove
        ("remove", dict(count=1)),  # the newest: agent 1
        ("remove", dict(agent_id=1)),  # already departed
        ("remove", dict(count=3)),  # more than live: stops at empty
        ("remove", dict(count=1)),  # empty membership
        ("add", dict(count=2)),
    ]
    for action, kw in events:
        got = port._apply_churn(ChurnEvent(at=0.0, action=action, **kw), 0.0)
        want = ref._apply_churn(
            jax_experiment.ChurnEvent(at=0.0, action=action, **kw), 0.0
        )
        assert got == want
    assert sorted(port.live_agents()) == sorted(ref.live_agents()) == [2, 3]
    ev = port.evaluate(paper_eight_tasks()[:1], TEST_P, max_patients=1, n_episodes=1)
    assert sorted(ev) == ["Agent3", "Agent4"]  # live agents only
