"""The fleet axis on a device mesh: the port's sharded fleet engine
against its single-device engine and the reference's.

A :class:`~repro_torch.models.sharding.FleetMesh` may repeat a device,
so every part of the sharded path (the partition of slots, placement
and growth, per-shard launches of ``replay_gather`` and ``fused_td``,
the gather and scatter of a partial flush, per-shard statistics, the
publish path) runs here on CPU entries, as the reference's own test runs
its mesh on eight forced host devices (``tests/test_fleet.py``).  Copies
between cards and overlap across them are not exercised: they need a
host with several.

The sharded engine is held to the single-device port engine at the
tolerance of ``test_fleet_vs_fleet_eager``: a shard's stacked step
convolves fewer agents in one grouped convolution, and PyTorch's CPU
convolution may sum in another order for another group count, so
parameters and losses agree within 1e-6 and records exactly.  Against
the reference's single-device engine, from the converted init, 1e-5
(the reference's mesh run is bitwise its single run).
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
from repro.configs.adfll_dqn import DQNConfig as JaxDQNConfig  # noqa: E402
from repro.core.erb import erb_add as jax_erb_add  # noqa: E402
from repro.core.erb import erb_init as jax_erb_init  # noqa: E402
from repro.core.erb import TaskTag as JaxTaskTag  # noqa: E402
from repro.core.replay import SelectiveReplaySampler as JaxSampler  # noqa: E402
from repro.rl.fleet import FleetEngine as JaxFleetEngine  # noqa: E402
from repro_torch.configs.adfll_dqn import ADFLLConfig, DQNConfig  # noqa: E402
from repro_torch.convert import dqn_params_from_numpy  # noqa: E402
from repro_torch.core import federated  # noqa: E402
from repro_torch.core.erb import TaskTag, erb_add, erb_flatten, erb_init  # noqa: E402
from repro_torch.core.replay import SelectiveReplaySampler  # noqa: E402
from repro_torch.kernels import fused_td as fused_td_mod  # noqa: E402
from repro_torch.kernels import replay_gather as replay_gather_mod  # noqa: E402
from repro_torch.models import sharding  # noqa: E402
from repro_torch.models.sharding import FleetMesh, FleetSharding  # noqa: E402
from repro_torch.optim.adamw import leaves  # noqa: E402
from repro_torch.rl.agent import DQNAgent  # noqa: E402
from repro_torch.rl.env import LandmarkEnv  # noqa: E402
from repro_torch.rl.fleet import FleetEngine, collect_fleet, tree_map  # noqa: E402
from repro_torch.rl.synth import (  # noqa: E402
    make_volume,
    paper_eight_tasks,
    patient_split,
)
from repro_torch.serve import driver  # noqa: E402
from repro_torch.serve.driver import build_session, run_session  # noqa: E402
from repro_torch.serve.traffic import TrafficSpec  # noqa: E402
from repro_torch.telemetry import Telemetry  # noqa: E402

CPU = torch.device("cpu")

# the reference's _MESH_SCRIPT config (tests/test_fleet.py)
KW = dict(
    volume_shape=(16, 16, 16),
    box_size=(6, 6, 6),
    conv_features=(4,),
    hidden=(32,),
    max_episode_steps=8,
    batch_size=16,
    eps_decay_steps=100,
    target_update=8,
)
CFG = DQNConfig(**KW)
# the tiny library config of tests/test_torch_system.py
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


def cpu_mesh(n: int) -> FleetMesh:
    return FleetMesh((CPU,) * n)


def flat(tree) -> list:
    """Every tensor of a nested dict, in sorted-key order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in flat(tree[k])]
    return [tree]


def assert_close(a: dict, b: dict, atol: float) -> None:
    la, lb = flat(a), flat(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y), atol=atol, rtol=0)


# -- the mesh ------------------------------------------------------------------
@pytest.mark.parametrize("count", [0, 1, 3, 8])
def test_make_fleet_mesh_rule(monkeypatch, count):
    """The reference's rule over the visible cards: capped, floored to a
    power of two, None at one or fewer; a CPU caller never gets a mesh,
    and ``cuda:i`` names one card only."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
    floor = 1 << (count.bit_length() - 1) if count else 0
    cases = ((None, floor), (-1, floor), (1, 0), (2, min(2, floor)), (5, min(4, floor)))
    for n, want in cases:
        mesh = sharding.make_fleet_mesh(n)
        if want <= 1:
            assert mesh is None
        else:
            assert mesh.size == want and mesh.axis == sharding.FLEET
            assert mesh.devices == tuple(torch.device("cuda", i) for i in range(want))
            assert sharding.make_fleet_mesh(n, device="cuda") == mesh
        assert sharding.make_fleet_mesh(n, device="cpu") is None
        assert sharding.make_fleet_mesh(n, device="cuda:1") is None
    if floor >= 2:
        assert sharding.make_fleet_mesh(-1, axis="agents").axis == "agents"


def test_fleet_mesh_refuses_a_size_not_a_power_of_two():
    for n in (0, 3, 6):
        with pytest.raises(ValueError, match="power of two"):
            FleetMesh((CPU,) * n)
    with pytest.raises(ValueError, match="one type"):
        FleetMesh((CPU, torch.device("cuda", 0)))
    assert cpu_mesh(4).size == 4 and cpu_mesh(1).devices == (CPU,)
    # the engine refuses a mesh of another device type than its caller's
    with pytest.raises(ValueError, match="cuda devices for a cpu caller"):
        FleetEngine(CFG, device="cpu", mesh=FleetMesh((torch.device("cuda", 0),) * 2))
    # and a mesh it refuses never reaches the engine
    with pytest.raises(ValueError):
        FleetEngine(CFG, device="cpu", mesh=FleetMesh((CPU,) * 3))


def test_placement_splits_and_gathers_back_bit_for_bit():
    """Capacity 8 over 4 shards: slot i is row i // 4 of shard i % 4, and
    the shards gathered back are the tree, bit for bit."""
    sh = FleetSharding(cpu_mesh(4))
    gen = torch.Generator().manual_seed(0)
    tree = {
        "a": {"w": torch.randn(8, 3, 5, generator=gen), "n": torch.arange(8)},
        "b": {"x": torch.randn(8, 2, generator=gen)},
    }
    parts = [tree_map(lambda x, j=j: sh.take(x, j), tree) for j in range(4)]
    for slot in range(8):
        j, row = sh.shard_of(slot), sh.row_of(slot)
        assert (j, row) == (slot % 4, slot // 4)
        assert sh.device_of(slot) == CPU
        assert torch.equal(parts[j]["a"]["w"][row], tree["a"]["w"][slot])
        assert int(parts[j]["a"]["n"][row]) == slot
    assert all(leaf.shape[0] == 2 for p in parts for leaf in leaves(p))
    back = tree_map(lambda *xs: sh.gather(xs), *parts)
    for a, b in zip(leaves(back), leaves(tree)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    want = [(0, [1, 2], [0, 1]), (1, [0], [1]), (3, [3], [0])]
    assert sh.groups([5, 0, 4, 3]) == want


# -- the reference's _MESH_SCRIPT, ported ---------------------------------------
def _task():
    return TaskTag("t1", "axial", "HGG")


def _data_erbs(n=256):
    """One replay buffer filled from a seeded numpy stream, for the port
    and for the reference."""
    data = np.random.default_rng(7)
    batch = {
        "obs": data.standard_normal((n, *CFG.box_size)).astype(np.float32),
        "loc": data.random((n, 3)).astype(np.float32),
        "action": data.integers(0, CFG.n_actions, n).astype(np.int32),
        "reward": data.standard_normal(n).astype(np.float32),
        "next_obs": data.standard_normal((n, *CFG.box_size)).astype(np.float32),
        "next_loc": data.random((n, 3)).astype(np.float32),
        "done": (data.random(n) < 0.1).astype(np.float32),
    }
    erb = erb_init(n, CFG.box_size, task=_task())
    erb_add(erb, batch)
    ref = jax_erb_init(n, CFG.box_size, task=JaxTaskTag("t1", "axial", "HGG"))
    jax_erb_add(ref, batch)
    return erb, ref


def _rounds(engines, erb, sampler, n_slots, seeds, k=6):
    for eng in engines:
        for i in range(n_slots):
            rng = np.random.default_rng(seeds + i)
            eng.submit(i, [sampler.plan(rng, CFG.batch_size, erb) for _ in range(k)])
        eng.flush()


def _ref_tree(tree):
    return dqn_params_from_numpy(jax.tree_util.tree_map(np.asarray, tree))


def test_sharded_engine_matches_single_and_reference():
    """The port of ``_MESH_SCRIPT``: 4 agents on an 8-entry mesh get
    capacity 8; sharded collection gives the unsharded ERBs and rng
    states; two rounds of 6-plan flushes and a partial flush over 3 of 4
    slots keep params, target and opt within 1e-6 of the single-device
    port engine and within 1e-5 of the reference's engine."""
    mesh = cpu_mesh(8)
    single = FleetEngine(CFG, device="cpu")
    shard = FleetEngine(CFG, device="cpu", mesh=mesh)
    a_single = [DQNAgent(i, CFG, seed=i, engine=single) for i in range(4)]
    a_shard = [DQNAgent(i, CFG, seed=i, engine=shard) for i in range(4)]
    assert shard.capacity == 8 and single.capacity == 4  # padded up to the mesh
    assert [a.device for a in a_shard] == [CPU] * 4
    # the reference's init, converted, in both port engines
    ref = JaxFleetEngine(JaxDQNConfig(**KW))
    for i in range(4):
        ref.add_slot(seed=i)
        for eng in (single, shard):
            eng.set_params(i, _ref_tree(ref.get_params(i)))
            eng.set_target(i, _ref_tree(ref.get_target(i)))

    # stacked collection on the mesh == on one device
    vol, lm = make_volume(_task(), 2, n=16)
    erbs = {}
    for name, agents in (("single", a_single), ("shard", a_shard)):
        erbs[name] = [erb_init(256, CFG.box_size, task=_task()) for _ in range(4)]
        envs = [LandmarkEnv(vol, lm, CFG) for _ in range(4)]
        collect_fleet(agents, envs, erbs[name], 4)
    for es, em, a_s, a_m in zip(erbs["single"], erbs["shard"], a_single, a_shard):
        assert es.size == em.size > 0
        assert np.array_equal(erb_flatten(es), erb_flatten(em))
        assert a_s.rng.bit_generator.state == a_m.rng.bit_generator.state

    erb, erb_ref = _data_erbs()
    for round_idx in range(2):
        _rounds([single, shard], erb, SelectiveReplaySampler(), 4, 100 + 10 * round_idx)
        _rounds([ref], erb_ref, JaxSampler(), 4, 100 + 10 * round_idx)
    # a partial flush: slots 0-2 span three shards, each gathers its one
    # row and scatters it back
    _rounds([single, shard], erb, SelectiveReplaySampler(), 3, 500)
    _rounds([ref], erb_ref, JaxSampler(), 3, 500)
    assert shard.flush_sizes == single.flush_sizes == [4, 4, 3]
    assert shard.n_chunk_steps == single.n_chunk_steps == 18
    assert shard.n_shard_steps == 6 * (4 + 4 + 3) and single.n_shard_steps == 18
    for i in range(4):
        for get in ("get_params", "get_target", "get_opt"):
            assert_close(getattr(shard, get)(i), getattr(single, get)(i), 1e-6)
        assert_close(shard.get_params(i), _ref_tree(ref.get_params(i)), 1e-5)
        assert_close(shard.get_target(i), _ref_tree(ref.get_target(i)), 1e-5)
        assert int(shard.get_opt(i)["count"]) == int(single.get_opt(i)["count"])
    # dead rows stay inert copies; the gathered state holds slot order
    state = shard.state
    assert all(x.shape[0] == 8 for x in leaves(state.params))
    assert_close(
        tree_map(lambda x: x[:4], state.params), single.stacked_params(), 1e-6
    )
    assert all(torch.equal(x[4], x[5]) for x in leaves(state.params))
    assert_close(shard.stacked_params(), single.stacked_params(), 1e-6)


def test_growth_and_dead_row_reuse_keep_each_slot_on_its_shard():
    """Dead-row reuse does not flush; growth past the capacity appends
    rows to every shard and moves no slot; a flush after growth, over
    slots of every shard, still matches the single-device engine."""
    erb, _ = _data_erbs()
    single = FleetEngine(CFG, device="cpu")
    shard = FleetEngine(CFG, device="cpu", mesh=cpu_mesh(4))
    for eng in (single, shard):
        for seed in range(3):
            eng.add_slot(seed)
    assert shard.capacity == 4
    futs = [eng.submit(0, _plans(erb, 30)) for eng in (single, shard)]
    for eng in (single, shard):
        assert eng.add_slot(3) == 3  # the dead row: no flush
    assert not any(f.done for f in futs)
    before = shard.get_params(3)  # slot 3 has no job: no flush
    assert not any(f.done for f in futs)
    for eng in (single, shard):
        assert eng.add_slot(4) == 4  # growth retires the pending jobs first
    assert all(f.done for f in futs) and abs(futs[0].loss - futs[1].loss) <= 1e-6
    assert shard.capacity == single.capacity == 8
    assert [len(s.count) for s in shard._shards] == [2, 2, 2, 2]
    assert shard.slot_device(4) == CPU and shard.sharding.shard_of(4) == 0
    assert_close(shard.get_params(3), before, 0.0)
    for eng in (single, shard):
        for slot in (4, 1, 3):
            eng.submit(slot, _plans(erb, 40 + slot))
        eng.flush()
    for slot in range(5):
        assert_close(shard.get_params(slot), single.get_params(slot), 1e-6)
    # a lone shard with every row in order passes its state straight through
    shards_before = list(shard._shards)
    for slot in (0, 4):
        shard.submit(slot, _plans(erb, 60 + slot))
    shard.flush()
    # shards without jobs launched nothing and hold the same tensors
    assert all(a is b for a, b in zip(shard._shards[1:], shards_before[1:]))
    assert shard._shards[0] is not shards_before[0]


def _plans(erb, seed, k=3):
    rng = np.random.default_rng(seed)
    sampler = SelectiveReplaySampler()
    return [sampler.plan(rng, CFG.batch_size, erb) for _ in range(k)]


def test_plain_kernels_run_once_per_shard_with_jobs(monkeypatch):
    """A and B (their plain versions on the CPU) launch once per shard
    that has jobs per stacked step, on that shard's operands only."""
    calls = {"replay_gather": [], "fused_td": []}
    gather, td = replay_gather_mod.replay_gather_plain, fused_td_mod.fused_td_plain

    def counted_gather(buffer, idx, w):
        calls["replay_gather"].append(idx.shape[0])
        return gather(buffer, idx, w)

    def counted_td(q, *rest):
        calls["fused_td"].append(q.shape[0])
        return td(q, *rest)

    monkeypatch.setattr(replay_gather_mod, "replay_gather_plain", counted_gather)
    monkeypatch.setattr(fused_td_mod, "fused_td_plain", counted_td)
    erb, _ = _data_erbs()
    engine = FleetEngine(CFG, device="cpu", mesh=cpu_mesh(4))
    for seed in range(6):
        engine.add_slot(seed)
    # slots 0, 1, 4, 5 on shards 0 and 1 (two jobs each); shards 2, 3 idle
    for slot in (0, 1, 4, 5):
        engine.submit(slot, _plans(erb, slot, k=5))
    engine.flush()
    assert engine.n_chunk_steps == 5 and engine.n_shard_steps == 10
    assert calls["fused_td"] == [2] * 10  # two agents a shard, K = 5 each
    assert calls["replay_gather"] == [2 * CFG.batch_size] * 10


# -- the system, serving and telemetry on a mesh --------------------------------
def _system(monkeypatch, mesh, telemetry=None):
    monkeypatch.setattr(
        federated, "make_fleet_mesh", lambda n, device=None: mesh
    )
    cfg = ADFLLConfig(**SYS_KW, fleet_devices=4 if mesh is not None else 0)
    system = federated.ADFLLSystem(
        cfg,
        DQNConfig(**DQN_KW),
        paper_eight_tasks(),
        TRAIN_P,
        telemetry=telemetry,
        device="cpu",
    )
    assert system.engine.mesh is mesh
    return system


def test_adfll_system_on_a_mesh_gives_the_unsharded_records(monkeypatch):
    """``ADFLLSystem`` with ``make_fleet_mesh`` giving a 4-entry CPU mesh:
    records exact but the loss, losses within 1e-6 of the unsharded run;
    evaluation on each agent's slot device; the observatory's per-agent
    statistics in job order (1e-6); the flush span says ``devices=4``."""
    runs = {}
    for name, mesh in (("single", None), ("mesh", cpu_mesh(4))):
        tel = Telemetry(enabled=True)
        system = _system(monkeypatch, mesh, tel)
        report = system.run()
        ev = system.evaluate(
            paper_eight_tasks()[:2], TEST_P, max_patients=1, n_episodes=2
        )
        runs[name] = (system, report, ev, tel)
    (s1, r1, e1, t1), (s2, r2, e2, t2) = runs["single"], runs["mesh"]
    h1 = [dataclasses.astuple(r) for r in r1.history]
    h2 = [dataclasses.astuple(r) for r in r2.history]
    assert len(h1) == len(h2) == 8
    for a, b in zip(h1, h2):
        assert a[:6] == b[:6] and a[7:] == b[7:]
        assert abs(a[6] - b[6]) <= 1e-6
    assert r1.bytes_by_plane == r2.bytes_by_plane
    assert s1.engine.flush_sizes == s2.engine.flush_sizes
    assert e1.keys() == e2.keys()
    for label in e1:
        for task in e1[label]:
            assert abs(e1[label][task] - e2[label][task]) <= 1e-6
    for aid in range(4):
        assert_close(s2.agents[aid].params, s1.agents[aid].params, 1e-6)
    flushes = [
        [
            e
            for e in t.tracer.events
            if e["name"] == "fleet.flush" and e["kind"] == "span"
        ]
        for t in (t1, t2)
    ]
    assert len(flushes[0]) == len(flushes[1]) > 0
    assert {e["args"]["devices"] for e in flushes[0]} == {1}
    assert {e["args"]["devices"] for e in flushes[1]} == {4}
    # each shard's statistics reach the observatory in job order
    learn = [s.observatory.learning.summary() for s in (s1, s2)]
    assert learn[0].keys() == learn[1].keys() == {"0", "1", "2", "3"}
    for aid in learn[0]:
        a, b = learn[0][aid], learn[1][aid]
        assert (a["n_chunks"], a["n_steps"]) == (b["n_chunks"], b["n_steps"])
        for key in ("last_loss", "min_loss", "max_grad_norm", "max_q", "loss_curve"):
            np.testing.assert_allclose(a[key], b[key], atol=1e-6, rtol=1e-6)


def test_fedavg_on_a_mesh_averages_on_one_device(monkeypatch):
    monkeypatch.setattr(
        federated, "make_fleet_mesh", lambda n, device=None: cpu_mesh(2)
    )
    kw = dict(rounds=1, steps=2, erb_capacity=64, seed=3, device="cpu")
    fed = federated.CentralAggregationSystem(
        3, DQNConfig(**DQN_KW), paper_eight_tasks(), TRAIN_P, devices=2, **kw
    )
    assert fed.engine.capacity == 4 and fed.engine.sharding.size == 2
    fed.run()
    monkeypatch.setattr(federated, "make_fleet_mesh", lambda n, device=None: None)
    ref = federated.CentralAggregationSystem(
        3, DQNConfig(**DQN_KW), paper_eight_tasks(), TRAIN_P, devices=2, **kw
    )
    ref.run()
    for a in fed.agents[1:]:
        assert_close(a.params, fed.agents[0].params, 0.0)
    assert_close(fed.agents[0].params, ref.agents[0].params, 1e-6)


def _session(monkeypatch, mesh):
    monkeypatch.setattr(driver, "make_fleet_mesh", lambda n, device=None: mesh)
    traffic = TrafficSpec(
        n_requests=24, max_batch=4, n_version_slots=2, max_staleness=1, seed=1
    )
    session = build_session(
        DQNConfig(**DQN_KW),
        n_agents=4,
        traffic=traffic,
        seed=1,
        devices=4,
        device="cpu",
    )
    assert session.engine.mesh is mesh
    report = run_session(session, traffic, n_waves=2, train_steps=3)
    results = session.service.results
    per_request = [
        (results[i].final_loc.tolist(), results[i].n_ticks, results[i].version)
        for i in sorted(results)
    ]
    return session, report, per_request


def test_serving_session_on_a_mesh_is_identical(monkeypatch):
    """The session on a 4-entry mesh serves each published snapshot from
    the mesh's first device: every request's voxel, ticks and version
    are the unsharded session's."""
    s1, r1, p1 = _session(monkeypatch, None)
    s2, r2, p2 = _session(monkeypatch, cpu_mesh(4))
    assert p1 == p2 and len(p1) == 24
    assert r1.n_swaps == r2.n_swaps == 1 and r2.recompiles == 0
    assert s2.service.device == s2.engine.device == CPU
    assert s2.engine.n_shard_steps == 4 * s2.engine.n_chunk_steps == 12
    assert_close(s2.publisher.latest.params, s1.publisher.latest.params, 1e-6)


# -- one agent a shard --------------------------------------------------------
def test_one_agent_a_shard_is_bitwise_the_single_device_run(monkeypatch):
    """A shard that holds one job trains it as two lanes (the agent and a
    copy), so its grouped convolution is the one the single-device engine
    runs: with one agent a shard, at one intra-op thread, the mesh gives
    the single-device engine's params, target, opt state and losses bit
    for bit (also on a partial flush), and ``ADFLLSystem`` its records,
    loss included, and params.  The copy adds nothing: shard steps count
    one per shard and step."""
    assert torch.get_num_threads() == 1
    erb, _ = _data_erbs()
    single = FleetEngine(CFG, device="cpu")
    shard = FleetEngine(CFG, device="cpu", mesh=cpu_mesh(4))
    for eng in (single, shard):
        for seed in range(4):
            eng.add_slot(seed)
    futs = {id(eng): [] for eng in (single, shard)}
    for n_slots, seeds in ((4, 100), (4, 110), (3, 500)):
        for eng in (single, shard):
            for i in range(n_slots):
                futs[id(eng)].append(eng.submit(i, _plans(erb, seeds + i, k=4)))
            eng.flush()
    assert [f.loss for f in futs[id(shard)]] == [f.loss for f in futs[id(single)]]
    assert shard.n_shard_steps == 4 * (4 + 4 + 3) and shard.n_chunk_steps == 12
    for i in range(4):
        for get in ("get_params", "get_target", "get_opt"):
            assert_close(getattr(shard, get)(i), getattr(single, get)(i), 0.0)

    runs = []
    for mesh in (None, cpu_mesh(4)):
        system = _system(monkeypatch, mesh)
        runs.append((system, system.run()))
    (s1, r1), (s2, r2) = runs
    assert [dataclasses.astuple(r) for r in r1.history] == [
        dataclasses.astuple(r) for r in r2.history
    ]
    assert len(r2.history) == 8 and s2.engine.sharding.size == 4
    for aid in range(4):
        assert_close(s2.agents[aid].params, s1.agents[aid].params, 0.0)
