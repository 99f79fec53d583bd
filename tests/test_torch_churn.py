"""The port's agent churn against the reference's.

System level (registry widths, ``--fast``, the port's fleet slots
starting from the reference's init through
``test_torch_baselines.reference_init``): the Fig 4 churn ablation
(4 -> 16 agents under 75 % dropout) gives the reference's round records
(every field but the loss identical, the loss within 1e-4), bytes,
messages, records known and makespan exactly; the same evaluation probes
(``t`` and ``n_agents`` equal, ``mean_err`` within 1e-4); and every
agent's params within 1e-5 after the run.  The resident axis grows
4 -> 8 -> 16 mid-run.  To keep the file cheap, evaluation is cut on both
sides alike (one patient, one episode, two tasks).  The helpers here
serve ``test_torch_churn_deletion``, ``test_torch_hub_failure`` and
``test_torch_population`` too.

The spec's churn and hub-failure validation raises as the reference's
does.
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
from repro.experiments import runner as jax_runner  # noqa: E402
from repro_torch.configs.adfll_dqn import ADFLLConfig, DQNConfig  # noqa: E402
from repro_torch.core.experiment import (  # noqa: E402
    ChurnEvent,
    ExperimentHooks,
    HubFailure,
)
from repro_torch.core.federated import ADFLLSystem  # noqa: E402
from repro_torch.experiments import registry  # noqa: E402
from repro_torch.experiments.runner import build, evaluate_into  # noqa: E402
from repro_torch.experiments.spec import ScenarioSpec  # noqa: E402
from repro_torch.rl.synth import paper_eight_tasks, patient_split  # noqa: E402
from test_torch_baselines import _params_close, reference_init  # noqa: E402
from test_torch_gossip import assert_records_match  # noqa: E402

# the evaluation cut of the scenario cases, the same on both sides
EVAL_CUT = dict(eval_patients=1, eval_episodes=1)
MAX_EVAL_TASKS = 2


def cut_spec(spec, train_steps=None):
    """``spec`` (either package's) with evaluation cut to one patient,
    one episode and at most two tasks, and optionally fewer train
    steps a round."""
    tasks = MAX_EVAL_TASKS if spec.eval_tasks is None else spec.eval_tasks
    spec = dataclasses.replace(
        spec, eval_tasks=min(tasks, MAX_EVAL_TASKS), **EVAL_CUT
    )
    if train_steps is not None:
        spec = dataclasses.replace(
            spec, sys=dataclasses.replace(spec.sys, train_steps_per_round=train_steps)
        )
    return spec


def run_scenario(name, monkeypatch, train_steps=None, hooks=()):
    """Run scenario ``name`` (``--fast``, registry widths, evaluation cut)
    end to end on both sides from the reference's init.  Returns
    ``(ref_system, ref_report), (port_system, port_report)``; each
    report's ``eval_curve`` is the probes and the final point."""
    reference_init(monkeypatch)
    ref_spec = cut_spec(jax_runner.resolve(name, fast=True), train_steps)
    built = jax_runner._build(ref_spec, ())
    rep_ref = built.system.run()
    final = jax_runner._eval_point(
        built.system, ref_spec, built.eval_tasks, built.test_patients, rep_ref.makespan
    )
    rep_ref.eval_curve = [*built.curve, final]
    port_spec = cut_spec(registry.get_scenario(name).fast(), train_steps)
    port = build(port_spec, hooks=hooks, device="cpu")
    rep = evaluate_into(port.run(), port, port_spec)
    return (built.system, rep_ref), (port, rep)


def assert_scenario_matches(ref, port):
    (ref_sys, rep_ref), (port_sys, rep) = ref, port
    assert_records_match(rep_ref, rep)
    assert rep.extra == rep_ref.extra
    assert [(p.t, p.n_agents) for p in rep.eval_curve] == [
        (p.t, p.n_agents) for p in rep_ref.eval_curve
    ]
    for a, b in zip(rep.eval_curve, rep_ref.eval_curve):
        assert np.isfinite(a.mean_err) and abs(a.mean_err - b.mean_err) <= 1e-4
    assert ref_sys.agents.keys() == port_sys.agents.keys()
    assert sorted(port_sys.live_agents()) == sorted(ref_sys.live_agents())
    for aid, agent in port_sys.agents.items():
        _params_close(agent.params, ref_sys.agents[aid].params, 1e-5)
        _params_close(agent.target_params, ref_sys.agents[aid].target_params, 1e-5)


class FailureLog(ExperimentHooks):
    def __init__(self):
        self.failures, self.churn = [], []

    def on_hub_failure(self, system, event, orphaned, t):
        self.failures.append((event.hub_id, list(orphaned), t))

    def on_churn(self, system, event, agent_ids, t):
        self.churn.append((event.action, list(agent_ids), t))

# ---------------------------------------------------------------------------
# Fig 4, end to end
# ---------------------------------------------------------------------------
def test_churn_addition_fig4_matches_reference(monkeypatch):
    log = FailureLog()
    ref, port = run_scenario("churn_addition_fig4", monkeypatch, hooks=(log,))
    assert_scenario_matches(ref, port)
    port_sys, rep = port
    # 4 -> 16 agents: the resident axis grew 4 -> 8 -> 16 mid-run
    assert [ids for _, ids, _ in log.churn] == [
        [4, 5, 6, 7],
        [8, 9, 10, 11],
        [12, 13, 14, 15],
    ]
    assert port_sys.engine.capacity == 16
    assert [(p.t, p.n_agents) for p in rep.eval_curve[:3]] == [
        (1.6, 4),
        (3.2, 8),
        (4.8, 12),
    ]
    assert rep.eval_curve[-1].n_agents == 16


# ---------------------------------------------------------------------------
# the system: small configurations, validation
# ---------------------------------------------------------------------------
DQN_KW = dict(
    volume_shape=(12, 12, 12),
    box_size=(4, 4, 4),
    conv_features=(2,),
    hidden=(8,),
    batch_size=4,
    max_episode_steps=4,
)
SYS_KW = dict(rounds=2, train_steps_per_round=2)
TRAIN_P, TEST_P = patient_split(16)


def test_spec_validation_matches_reference():
    gossip = ADFLLConfig(topology="gossip")
    fail = (HubFailure(at=0.7, hub_id=0),)
    with pytest.raises(ValueError, match="no hubs"):
        ScenarioSpec(name="x", sys=gossip, hub_failures=fail)
    with pytest.raises(ValueError, match="negative hub_id"):
        HubFailure(at=0.5, hub_id=-1)
    with pytest.raises(ValueError, match="unknown churn action"):
        ChurnEvent(at=0.5, action="pause")
    with pytest.raises(ValueError, match="count=1"):
        ChurnEvent(at=0.5, action="remove", count=2, agent_id=0)
    with pytest.raises(ValueError, match="fast_population_scale"):
        ScenarioSpec(name="x", fast_population_scale=0.0)
    with pytest.raises(ValueError, match="supports no churn"):
        build(
            ScenarioSpec(
                name="x", system="partial", churn=(ChurnEvent(0.5, "add"),)
            ),
            device="cpu",
        )
    tiny = ADFLLSystem(
        ADFLLConfig(**SYS_KW, n_hubs=1),
        DQNConfig(**DQN_KW),
        paper_eight_tasks(),
        TRAIN_P,
        device="cpu",
    )
    with pytest.raises(ValueError, match="out of range"):
        tiny.schedule_hub_failures((HubFailure(at=0.5, hub_id=3),))
    assert tiny._pending_failures == 0  # nothing was scheduled
