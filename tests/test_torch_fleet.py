"""The port's fleet engine against the reference's, and its own guarantees.

* ``FleetSteps.train_chunk`` from one converted state, one pool and one
  ``[K=9, N=2, B]`` index tensor: params within 1e-5 and losses within
  1e-4 of the reference after nine steps (the float32 budget
  ``tests/test_fleet.py`` grants between two programs that sum in a
  different order), with a target sync inside the chunk.
* ``FleetEngine``: futures resolve in submission order; dead rows of
  the resident capacity are never read or written.
* ``fleet`` vs ``fleet-eager`` driving of one ADFLL run: identical
  records and losses within 1e-6.  Not bitwise: the batched flush runs
  grouped convolutions over several agents, the eager one over one, and
  PyTorch's CPU convolution may sum in another order for another group
  count.
"""

import dataclasses

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
from repro.rl.fleet import make_fleet_steps  # noqa: E402
from repro_torch.configs.adfll_dqn import ADFLLConfig, DQNConfig  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    fleet_state_from_numpy,
    fleet_state_to_numpy,
)
from repro_torch.core.erb import TaskTag, erb_add, erb_init  # noqa: E402
from repro_torch.core.federated import ADFLLSystem  # noqa: E402
from repro_torch.core.replay import SelectiveReplaySampler  # noqa: E402
from repro_torch.rl import fleet  # noqa: E402
from repro_torch.rl.agent import DQNAgent  # noqa: E402
from repro_torch.rl.fleet import FleetEngine, FleetSteps  # noqa: E402
from repro_torch.rl.synth import paper_eight_tasks, patient_split  # noqa: E402

# tests/test_fleet.py's config: target_update=8 forces a sync in the chunk
KW = dict(
    volume_shape=(16, 16, 16),
    box_size=(6, 6, 6),
    conv_features=(4,),
    hidden=(32,),
    max_episode_steps=12,
    batch_size=16,
    eps_decay_steps=100,
    target_update=8,
)
CFG = DQNConfig(**KW)


def _pool(rng, rows, cfg):
    obs_f = int(np.prod(cfg.box_size))
    pool = np.concatenate(
        [
            rng.standard_normal((rows, obs_f)),
            rng.random((rows, 3)),
            rng.integers(0, cfg.n_actions, (rows, 1)),  # action, stored as float
            rng.standard_normal((rows, 1)),
            rng.standard_normal((rows, obs_f)),
            rng.random((rows, 3)),
            rng.random((rows, 1)) < 0.1,  # done
        ],
        axis=1,
    )
    return pool.astype(np.float32)


def _leaves(tree):
    return jax.tree_util.tree_leaves(tree)


def test_train_chunk_matches_reference():
    jcfg = JaxDQNConfig(**KW)
    ref_steps = make_fleet_steps(jcfg)
    slots = [ref_steps.init_slot(seed) for seed in (3, 4)]
    ref_state = jax.tree_util.tree_map(lambda *xs: jnp.concatenate(xs), *slots)
    rng = np.random.default_rng(0)
    pool = _pool(rng, 256, CFG)
    idx = rng.integers(0, 256, (9, 2, CFG.batch_size)).astype(np.int32)

    state = fleet_state_from_numpy(
        {
            k: jax.tree_util.tree_map(np.asarray, getattr(ref_state, k))
            for k in ("params", "target", "opt", "count")
        }
    )
    new, losses = FleetSteps(CFG, "cpu").train_chunk(
        state, torch.from_numpy(pool), torch.from_numpy(idx)
    )
    ref_new, ref_losses = ref_steps.train_chunk(
        ref_state, jnp.asarray(pool), jnp.asarray(idx)
    )
    assert losses.shape == (9, 2)
    np.testing.assert_allclose(
        losses.numpy(), np.asarray(ref_losses), atol=1e-4, rtol=0
    )
    got = fleet_state_to_numpy(new)
    assert got["count"].tolist() == np.asarray(ref_new.count).tolist() == [9, 9]
    for field in ("params", "target"):
        want = jax.tree_util.tree_map(np.asarray, getattr(ref_new, field))
        for a, b in zip(_leaves(got[field]), _leaves(want)):
            np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)
    # the sync at count 8 copied step 8's params into the target, so the
    # target moved but lags the params by the ninth update
    before = jax.tree_util.tree_map(np.asarray, ref_state.target)
    assert not np.array_equal(_leaves(got["target"])[0], _leaves(before)[0])
    assert not np.array_equal(_leaves(got["target"])[-1], _leaves(got["params"])[-1])


def _filled_erb(rng, capacity=256):
    erb = erb_init(capacity, CFG.box_size, task=TaskTag("t1", "axial", "HGG"))
    n = capacity
    erb_add(
        erb,
        {
            "obs": rng.standard_normal((n, *CFG.box_size)).astype(np.float32),
            "loc": rng.random((n, 3)).astype(np.float32),
            "action": rng.integers(0, CFG.n_actions, n).astype(np.int32),
            "reward": rng.standard_normal(n).astype(np.float32),
            "next_obs": rng.standard_normal((n, *CFG.box_size)).astype(np.float32),
            "next_loc": rng.random((n, 3)).astype(np.float32),
            "done": (rng.random(n) < 0.1).astype(np.float32),
        },
    )
    return erb


def _plans(seed, erb, k=4):
    plan_rng = np.random.default_rng(seed)
    sampler = SelectiveReplaySampler()
    return [sampler.plan(plan_rng, CFG.batch_size, erb) for _ in range(k)]


def test_futures_resolve_in_submission_order():
    erb = _filled_erb(np.random.default_rng(1))
    engine = FleetEngine(CFG, device="cpu")
    for seed in range(3):
        engine.add_slot(seed)
    order = []
    futs = {}
    for slot in (2, 0, 1):
        futs[slot] = engine.submit(slot, _plans(10 + slot, erb))
        futs[slot].on_done(lambda loss, s=slot: order.append(s))
    assert not any(f.done for f in futs.values())
    engine.get_params(0)  # a read forces the flush
    assert order == [2, 0, 1]
    assert engine.flush_sizes == [3] and engine.n_chunk_steps == 4
    assert all(np.isfinite(f.loss) for f in futs.values())


def test_dead_rows_are_never_read():
    """Capacity 4 for 3 slots: the flush gathers the three live slots
    only.  Poisoning the dead row with NaN changes nothing of the live
    slots, bit for bit, and the flush leaves the dead row as it was."""
    erb = _filled_erb(np.random.default_rng(2))
    engines = [FleetEngine(CFG, device="cpu") for _ in range(2)]
    for engine in engines:
        for seed in range(3):
            engine.add_slot(seed)
        assert engine.capacity == 4
    engines[1].state = engines[1].state.map(
        lambda x: x.index_fill(0, torch.tensor([3]), float("nan"))
        if x.is_floating_point()
        else x
    )
    futs = [[e.submit(s, _plans(20 + s, erb)) for s in range(3)] for e in engines]
    for engine in engines:
        engine.flush()
    for s in range(3):
        assert futs[0][s].loss == futs[1][s].loss
        for a, b in zip(
            _leaves(engines[0].get_params(s)), _leaves(engines[1].get_params(s))
        ):
            assert torch.equal(a, b)
    assert all(torch.isnan(x[3]).all() for x in _leaves(engines[1].state.params))
    assert engines[1].state.count[3] == 0


def test_add_slot_reuses_dead_row_without_flush():
    erb = _filled_erb(np.random.default_rng(3))
    engine = FleetEngine(CFG, device="cpu")
    for seed in range(3):
        engine.add_slot(seed)
    fut = engine.submit(0, _plans(30, erb))
    assert engine.add_slot(7) == 3 and engine.capacity == 4
    assert not fut.done  # the dead row was overwritten in place of a flush
    assert engine.add_slot(8) == 4 and engine.capacity == 8
    assert fut.done  # growing the resident axis retires pending jobs


def test_erb_cache_keys_on_version_and_respects_byte_budget(monkeypatch):
    rng = np.random.default_rng(4)
    erbs = [_filled_erb(rng, capacity=64) for _ in range(3)]
    one = erbs[0].size * (2 * 216 + 9) * 4  # bytes of one flattened ERB
    monkeypatch.setattr(fleet, "ERB_CACHE_BYTES", 2 * one)
    engine = FleetEngine(CFG, device="cpu")
    first = engine._flat_erb(erbs[0])
    assert engine._flat_erb(erbs[0]) is first  # hit
    for e in erbs[1:]:
        engine._flat_erb(e)
    # one cache and one byte budget per device (here the engine's one)
    cache = engine._erb_cache[engine.device]
    assert len(cache) == 2  # the byte budget evicted the oldest
    assert engine._erb_cache_nbytes[engine.device] == 2 * one
    assert (erbs[0].meta.erb_id, erbs[0].version) not in cache
    stale = engine._flat_erb(erbs[1])
    # a host-side ring append (overwriting row 0) bumps the version
    erb_add(erbs[1], {k: v[:1] for k, v in erbs[2].data.items()})
    fresh = engine._flat_erb(erbs[1])
    assert fresh is not stale
    assert np.array_equal(fresh.numpy()[0, :216], erbs[2].data["obs"][0].ravel())
    assert not np.array_equal(stale.numpy()[0, :216], fresh.numpy()[0, :216])


def test_agent_flush_on_read():
    erb = _filled_erb(np.random.default_rng(5))
    engine = FleetEngine(CFG, device="cpu")
    agent = DQNAgent(0, CFG, seed=3, engine=engine)
    before = agent.params
    fut = agent._submit_steps(5, erb, ())
    assert not fut.done
    seen = []
    fut.on_done(seen.append)
    after = agent.params  # the read forces the flush
    assert fut.done and np.isfinite(fut.loss) and seen == [fut.loss]
    assert not all(torch.equal(a, b) for a, b in zip(_leaves(before), _leaves(after)))
    assert agent.step_count == 5 and engine.n_chunk_steps == 5


def _system(engine: str) -> ADFLLSystem:
    sys_cfg = ADFLLConfig(
        n_agents=2,
        agent_hub=(0, 1),
        agent_speed=(1.0, 2.0),
        rounds=2,
        train_steps_per_round=6,
        erb_capacity=512,
        erb_share_size=64,
        hub_sync_period=0.25,
        engine=engine,
    )
    train_p, _ = patient_split(16)
    sysm = ADFLLSystem(sys_cfg, CFG, paper_eight_tasks(), train_p, device="cpu")
    sysm.run()
    return sysm


def test_fleet_vs_fleet_eager():
    lazy, eager = _system("fleet"), _system("fleet-eager")
    assert any(n > 1 for n in lazy.engine.flush_sizes), "nothing batched"
    assert all(n == 1 for n in eager.engine.flush_sizes)
    ha = [dataclasses.astuple(r) for r in lazy.history]
    hb = [dataclasses.astuple(r) for r in eager.history]
    assert len(ha) == len(hb) == 4
    for ra, rb in zip(ha, hb):
        assert ra[:6] == rb[:6] and ra[7:] == rb[7:]  # all but the loss exact
        assert abs(ra[6] - rb[6]) <= 1e-6
    for aid in lazy.agents:
        for a, b in zip(
            _leaves(lazy.agents[aid].params), _leaves(eager.agents[aid].params)
        ):
            torch.testing.assert_close(a, b, atol=1e-6, rtol=0)
