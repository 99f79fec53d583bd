"""The port's ADFLL system, runner and CLI against the reference's.

Both systems run the same tiny deployment (4 agents on 3 hubs, 2 rounds
of 2 steps) from the reference's init, converted into the port before
``run()``.  The scheduler, hubs, replay plans and share slices are
host-side numpy on both sides, so every round record field but the
loss is identical, as are the bytes on the wire; losses agree within
1e-4.  Evaluation distances agree within 1e-4: greedy rollouts act on
q-values that agree within 1e-5, and one flipped argmax would move a
distance by about a voxel.
"""

import dataclasses
import re
from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: these sizes gain nothing from more, and spinning
# OpenMP threads in parallel test workers would starve the other tests
torch.set_num_threads(1)
jax = pytest.importorskip("jax")

from repro.configs.adfll_dqn import ADFLLConfig as JaxADFLLConfig  # noqa: E402
from repro.configs.adfll_dqn import DQNConfig as JaxDQNConfig  # noqa: E402
from repro.core.federated import ADFLLSystem as JaxADFLLSystem  # noqa: E402
from repro.rl.synth import paper_eight_tasks as jax_tasks  # noqa: E402
from repro_torch.configs.adfll_dqn import ADFLLConfig, DQNConfig  # noqa: E402
from repro_torch.convert import dqn_params_from_numpy  # noqa: E402
from repro_torch.core.federated import ADFLLSystem  # noqa: E402
from repro_torch.experiments import __main__ as cli  # noqa: E402
from repro_torch.experiments import registry  # noqa: E402
from repro_torch.experiments.runner import run  # noqa: E402
from repro_torch.models.sharding import make_fleet_mesh  # noqa: E402
from repro_torch.rl.synth import paper_eight_tasks, patient_split  # noqa: E402

# the tiny library config of .claude/skills/verify/SKILL.md
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


def _systems():
    ref = JaxADFLLSystem(
        JaxADFLLConfig(**SYS_KW), JaxDQNConfig(**DQN_KW), jax_tasks(), TRAIN_P
    )
    port = ADFLLSystem(
        ADFLLConfig(**SYS_KW),
        DQNConfig(**DQN_KW),
        paper_eight_tasks(),
        TRAIN_P,
        device="cpu",
    )
    for aid, agent in ref.agents.items():
        tree = jax.tree_util.tree_map(np.asarray, agent.params)
        port.agents[aid].params = dqn_params_from_numpy(tree)
        port.agents[aid].target_params = dqn_params_from_numpy(tree)
    return ref, port


def test_system_matches_reference():
    ref, port = _systems()
    rep_ref, rep = ref.run(), port.run()
    ha = [dataclasses.astuple(r) for r in rep_ref.history]
    hb = [dataclasses.astuple(r) for r in rep.history]
    assert len(ha) == len(hb) == 8
    for ra, rb in zip(ha, hb):
        assert ra[:6] == rb[:6] and ra[7:] == rb[7:]
        assert abs(ra[6] - rb[6]) <= 1e-4
    assert rep.bytes_by_plane == rep_ref.bytes_by_plane
    assert rep.msgs_by_plane == rep_ref.msgs_by_plane
    assert rep.records_known == rep_ref.records_known
    assert rep.plane_pushed == rep_ref.plane_pushed
    assert (rep.makespan, rep.n_rounds, rep.n_foreign_erbs) == (
        rep_ref.makespan,
        rep_ref.n_rounds,
        rep_ref.n_foreign_erbs,
    )
    tasks_ref, tasks = jax_tasks()[:2], paper_eight_tasks()[:2]
    ev_ref = ref.evaluate(tasks_ref, TEST_P, max_patients=2)
    ev = port.evaluate(tasks, TEST_P, max_patients=2)
    assert ev.keys() == ev_ref.keys()
    for label in ev:
        assert ev[label].keys() == ev_ref[label].keys()
        for task in ev[label]:
            assert abs(ev[label][task] - ev_ref[label][task]) <= 1e-4


def test_unported_options_raise(monkeypatch):
    cfg = DQNConfig(**DQN_KW)
    # fleet_devices resolve over the devices the system's device names: a
    # CPU system gets no mesh, whatever the cards, and runs the
    # single-device engine (the reference's rule); on the card the same
    # call names the visible cards
    sharded = ADFLLConfig(**SYS_KW, fleet_devices=2)
    for count in (0, 2):
        monkeypatch.setattr(torch.cuda, "device_count", lambda c=count: c)
        system = ADFLLSystem(sharded, cfg, paper_eight_tasks(), TRAIN_P, device="cpu")
        assert system.engine.mesh is None and system.engine.sharding.size == 1
    cards = (torch.device("cuda", 0), torch.device("cuda", 1))
    assert make_fleet_mesh(2, device="cuda").devices == cards
    monkeypatch.undo()
    port = ADFLLSystem(
        ADFLLConfig(**SYS_KW), cfg, paper_eight_tasks(), TRAIN_P, device="cpu"
    )
    # churn and hub failures are ported: empty schedules schedule nothing
    port.schedule_churn(())
    port.schedule_hub_failures(())
    assert port._pending_churn == port._pending_failures == 0
    # the weight plane and the stepwise engine are ported: nothing raises
    assert port.agents[0].mix_params((), ()) == 0
    ADFLLSystem(
        ADFLLConfig(**SYS_KW, engine="stepwise", topology="gossip"),
        cfg,
        paper_eight_tasks(),
        TRAIN_P,
        device="cpu",
    )


@pytest.fixture
def tiny_fig2(monkeypatch):
    """paper_fig2 cut to the tiny widths and depth (the registry entry is
    restored after the test)."""
    spec = registry.get_scenario("paper_fig2")
    tiny = replace(
        spec,
        dqn=DQNConfig(**DQN_KW),
        sys=replace(spec.sys, rounds=1, erb_capacity=256, erb_share_size=32),
        eval_tasks=2,
        eval_patients=1,
        fast_train_steps=2,
    )
    monkeypatch.setitem(registry._REGISTRY, "paper_fig2", tiny)
    return tiny


def test_runner_and_cli(tiny_fig2, capsys):
    report = run("paper_fig2", fast=True, device="cpu")
    assert report.scenario == "paper_fig2" and report.n_rounds == 4
    assert np.isfinite(report.mean_dist_err)
    assert len(report.task_errors) == 4
    assert all(len(errs) == 2 for errs in report.task_errors.values())
    assert cli.main(["--scenario", "paper_fig2", "--fast", "--device", "cpu"]) == 0
    line = capsys.readouterr().out.splitlines()[0]
    m = re.fullmatch(
        r"paper_fig2,mean_dist_err=([\d.]+),best_agent_err=[\d.]+,"
        r"sim_makespan=[\d.]+,n_rounds=4,total_bytes=\d+",
        line,
    )
    assert m and float(m.group(1)) == pytest.approx(report.mean_dist_err, abs=1e-3)
    assert cli.main(["--scenario", "nope"]) == 2
    assert "see --list" in capsys.readouterr().err  # no near name
    assert cli.main(["--scenario", "paper_fig3"]) == 2
    assert "did you mean: paper_fig2" in capsys.readouterr().err
