"""The port's collection phase against the reference's ``collect_fleet``.

Both sides start from the reference's init (converted) and the same
seeds.  With epsilon 1 every action is an exploration draw, so the ERB
bytes and each agent's rng state must be identical: that pins the order
of every host draw.  With epsilon at its floor most actions are greedy;
the stacked q-values agree within 1e-5, and the ERBs are identical as
long as no greedy argmax margin falls under that tolerance, which the
test checks before it compares.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: these sizes gain nothing from more, and spinning
# OpenMP threads in parallel test workers would starve the other tests
torch.set_num_threads(1)
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import repro.core  # noqa: E402, F401  (the reference's own import order)
from repro.configs.adfll_dqn import DQNConfig as JaxDQNConfig  # noqa: E402
from repro.core.erb import erb_init as jax_erb_init  # noqa: E402
from repro.core.federated import env_for as jax_env_for  # noqa: E402
from repro.rl.agent import DQNAgent as JaxDQNAgent  # noqa: E402
from repro.rl.fleet import FleetEngine as JaxFleetEngine  # noqa: E402
from repro.rl.fleet import collect_fleet as jax_collect_fleet  # noqa: E402
from repro.rl.fleet import make_collect_steps  # noqa: E402
from repro_torch.configs.adfll_dqn import DQNConfig  # noqa: E402
from repro_torch.convert import dqn_params_from_numpy  # noqa: E402
from repro_torch.core.erb import erb_init  # noqa: E402
from repro_torch.core.federated import env_for  # noqa: E402
from repro_torch.rl.agent import DQNAgent  # noqa: E402
from repro_torch.rl.fleet import CollectSteps, FleetEngine, collect_fleet  # noqa: E402
from repro_torch.rl.synth import paper_eight_tasks  # noqa: E402

KW = dict(
    volume_shape=(16, 16, 16),
    box_size=(6, 6, 6),
    conv_features=(4, 8),
    hidden=(32,),
    max_episode_steps=12,
    batch_size=16,
)
TASKS = paper_eight_tasks()


def _cohorts(n_agents):
    jcfg, cfg = JaxDQNConfig(**KW), DQNConfig(**KW)
    jeng, eng = JaxFleetEngine(jcfg), FleetEngine(cfg, device="cpu")
    ref = [JaxDQNAgent(i, jcfg, seed=i, engine=jeng) for i in range(n_agents)]
    port = [DQNAgent(i, cfg, seed=i, engine=eng) for i in range(n_agents)]
    for a, b in zip(ref, port):
        tree = jax.tree_util.tree_map(np.asarray, a.params)
        b.params = dqn_params_from_numpy(tree)
        b.target_params = dqn_params_from_numpy(tree)
    return jcfg, cfg, ref, port


def _collect(agents, env_fn, erb_fn, cfg, collect):
    envs = [env_fn(TASKS[i], 3 + i, cfg) for i in range(len(agents))]
    erbs = [erb_fn(512, cfg.box_size, task=TASKS[i]) for i in range(len(agents))]
    collect(agents, envs, erbs, 8)
    return envs, erbs


def _assert_same_erbs(ref_erbs, erbs):
    for a, b in zip(ref_erbs, erbs):
        assert a.size == b.size > 0 and a.version == b.version
        for key in a.data:
            assert a.data[key].dtype == b.data[key].dtype
            assert a.data[key].tobytes() == b.data[key].tobytes(), key


def test_exploration_collect_is_byte_identical():
    jcfg, cfg, ref, port = _cohorts(3)
    assert all(a.epsilon() == 1.0 for a in port)
    ref_envs, ref_erbs = _collect(
        ref, jax_env_for, jax_erb_init, jcfg, jax_collect_fleet
    )
    envs, erbs = _collect(port, env_for, erb_init, cfg, collect_fleet)
    for e_ref, e in zip(ref_envs, envs):
        assert np.array_equal(e_ref.volume, e.volume)
    _assert_same_erbs(ref_erbs, erbs)
    for a, b in zip(ref, port):
        assert a.rng.bit_generator.state == b.rng.bit_generator.state


def test_greedy_collect_matches_where_margins_allow(monkeypatch):
    jcfg, cfg, ref, port = _cohorts(2)
    for a in (*ref, *port):
        a.step_count = 10**6  # epsilon at its floor: mostly greedy actions
    seen = []  # every stacked q-value batch the port acts on
    qvals = CollectSteps.qvals

    def recording(self, stacked, obs, loc):
        q = qvals(self, stacked, obs, loc)
        seen.append((stacked, obs.numpy().copy(), loc.numpy().copy(), q.numpy()))
        return q

    monkeypatch.setattr(CollectSteps, "qvals", recording)
    _, ref_erbs = _collect(ref, jax_env_for, jax_erb_init, jcfg, jax_collect_fleet)
    _, erbs = _collect(port, env_for, erb_init, cfg, collect_fleet)
    assert len(seen) == cfg.max_episode_steps
    qs = make_collect_steps(jcfg)
    stacked_ref = ref[0].engine.padded_slot_params([0, 1])
    for _, obs, loc, q in seen:
        q_ref = np.asarray(qs.qvals(stacked_ref, jnp.asarray(obs), jnp.asarray(loc)))
        np.testing.assert_allclose(q, q_ref, atol=1e-5, rtol=0)
        top2 = np.sort(q_ref, -1)[..., -2:]
        assert (top2[..., 1] - top2[..., 0]).min() > 1e-5  # no argmax can flip
    _assert_same_erbs(ref_erbs, erbs)
    for a, b in zip(ref, port):
        assert a.rng.bit_generator.state == b.rng.bit_generator.state
