"""The port's stepwise backend against the reference's, and against the
port's own fleet.

``engine="stepwise"`` gives every agent its own one-slot state and
trains each step in its own dispatch: ``replay_gather`` for each pick of
the step's replay plan, ``fused_td`` for the TD tail at N = 1, then the
stacked AdamW at N = 1.

* Against the reference's stepwise (registry widths, ``--fast``, from
  the reference's init): every round-record field but the loss, the
  wire counts and pushes identical; losses within 1e-4, params within
  1e-5 after the run.
* Against the port's fleet (the reference's ``tests/test_fleet.py``
  check, here at 1e-6): the same run on the two engines keeps identical
  round metadata, and every agent's params and target agree within
  1e-6 (the stacked step at N = 1 and at N = 2 sums in other orders).
* ``--engine stepwise`` on the CLI.  On the card (``cuda`` test): one
  ``fused_td`` launch per agent step, one ``replay_gather`` launch per
  pick, and round 0's loss within 1e-4 of the CPU's.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: these sizes gain nothing from more, and spinning
# OpenMP threads in parallel test workers would starve the other tests
torch.set_num_threads(1)
pytest.importorskip("jax")

import repro.core  # noqa: E402, F401  (the reference's own import order)
from repro_torch.configs.adfll_dqn import ADFLLConfig, DQNConfig  # noqa: E402
from repro_torch.core.erb import erb_init  # noqa: E402
from repro_torch.core.federated import ADFLLSystem, env_for  # noqa: E402
from repro_torch.core.replay import ReplayPlan  # noqa: E402
from repro_torch.experiments import __main__ as cli  # noqa: E402
from repro_torch.experiments import registry  # noqa: E402
from repro_torch.experiments.runner import build  # noqa: E402
from repro_torch.kernels.fused_td import fused_td  # noqa: E402
from repro_torch.kernels.replay_gather import replay_gather  # noqa: E402
from repro_torch.optim.adamw import leaves  # noqa: E402
from repro_torch.rl.agent import DQNAgent  # noqa: E402
from repro_torch.rl.fleet import FleetEngine  # noqa: E402
from repro_torch.rl.synth import paper_eight_tasks, patient_split  # noqa: E402
from test_torch_baselines import DQN_KW  # noqa: E402
from test_torch_gossip import (  # noqa: E402
    assert_params_match,
    assert_records_match,
    run_both,
)

# the reference's tests/test_fleet.py widths (target syncs inside a round)
DQN = DQNConfig(
    volume_shape=(16, 16, 16),
    box_size=(6, 6, 6),
    conv_features=(4,),
    hidden=(32,),
    max_episode_steps=12,
    batch_size=16,
    eps_decay_steps=100,
    target_update=8,
)
TRAIN_P, TEST_P = patient_split(16)


@pytest.mark.parametrize("name", ["paper_fig2", "plane_hybrid"])
def test_stepwise_matches_reference_stepwise(name, monkeypatch):
    (ref_sys, rep_ref), (port_sys, rep) = run_both(
        name, monkeypatch, engine="stepwise"
    )
    assert ref_sys.engine is None and port_sys.engine is None
    assert_records_match(rep_ref, rep)
    assert_params_match(ref_sys, port_sys, 1e-5)
    steps = sum(a.step_count for a in port_sys.agents.values())
    assert steps == rep.n_rounds * port_sys.sys_cfg.train_steps_per_round


def _run(engine, planes):
    cfg = ADFLLConfig(
        n_agents=2,
        agent_hub=(0, 1),
        agent_speed=(1.0, 2.0),
        rounds=2,
        train_steps_per_round=12,
        erb_capacity=512,
        erb_share_size=64,
        hub_sync_period=0.25,
        engine=engine,
        share_planes=planes,
    )
    system = ADFLLSystem(cfg, DQN, paper_eight_tasks(), TRAIN_P, seed=0, device="cpu")
    return system, system.run()


@pytest.mark.parametrize("planes", [("erb",), ("erb", "weights")])
def test_stepwise_matches_fleet(planes):
    fleet, rep_fleet = _run("fleet", planes)
    step, rep_step = _run("stepwise", planes)
    assert any(n > 1 for n in fleet.engine.flush_sizes), "nothing batched"
    assert step.engine is None
    ha = [dataclasses.astuple(r) for r in rep_fleet.history]
    hb = [dataclasses.astuple(r) for r in rep_step.history]
    assert len(ha) == len(hb) == 4
    for ra, rb in zip(ha, hb):
        assert ra[:6] == rb[:6] and ra[7:] == rb[7:]  # all but the loss exact
        assert abs(ra[6] - rb[6]) <= 1e-6
    assert rep_step.bytes_by_plane == rep_fleet.bytes_by_plane
    assert (rep_step.n_mixed > 0) == ("weights" in planes)
    for aid, agent in fleet.agents.items():
        other = step.agents[aid]
        assert other.backend == "stepwise" and other.engine.n_steps_trained == 24
        for a, b in zip(leaves(agent.params), leaves(other.params)):
            assert float((a - b).abs().max()) <= 1e-6
        for a, b in zip(leaves(agent.target_params), leaves(other.target_params)):
            assert float((a - b).abs().max()) <= 1e-6
    assert other.n_picks_gathered >= 24


def test_stepwise_agent_options_and_bounds():
    with pytest.raises(ValueError, match="unknown backend"):
        DQNAgent(0, DQN, backend="scan", device="cpu")
    with pytest.raises(ValueError, match="no engine"):
        DQNAgent(0, DQN, backend="stepwise", engine=FleetEngine(DQN, device="cpu"))
    agent = DQNAgent(0, DQN, seed=3, backend="stepwise", device="cpu")
    task = paper_eight_tasks()[0]
    erb = agent.collect(
        env_for(task, TRAIN_P[0], DQN), erb_init(64, DQN.box_size, task=task), 4
    )
    assert agent.train_steps(0, erb) == 0.0
    loss = agent.train_steps(2, erb)
    assert np.isfinite(loss) and agent.step_count == 2
    assert agent.n_picks_gathered == 2  # one ERB: one pick a step
    bad = ReplayPlan(picks=((erb, np.array([0, len(erb)])),), perm=np.arange(2))
    with pytest.raises(IndexError, match="out of range"):
        agent.engine.train_step(agent.slot, bad)


@pytest.fixture
def tiny_fig2(monkeypatch):
    spec = registry.get_scenario("paper_fig2")
    tiny = dataclasses.replace(
        spec,
        dqn=DQNConfig(**DQN_KW),
        sys=dataclasses.replace(spec.sys, rounds=1, erb_capacity=256),
        eval_tasks=2,
        eval_patients=1,
        fast_train_steps=2,
    )
    monkeypatch.setitem(registry._REGISTRY, "paper_fig2", tiny)


def test_cli_engine_override(tiny_fig2, capsys):
    lines = []
    for engine in ("fleet", "stepwise"):
        argv = ["--scenario", "paper_fig2", "--fast", "--device", "cpu"]
        assert cli.main([*argv, "--engine", engine]) == 0
        lines.append(capsys.readouterr().out.splitlines()[0])
    assert lines[0].startswith("paper_fig2,mean_dist_err=")
    assert lines[0] == lines[1]  # the same numbers to three decimals
    with pytest.raises(SystemExit):
        cli.main(["--scenario", "paper_fig2", "--engine", "scan"])
