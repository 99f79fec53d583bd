"""The port's online inference plane on the CPU: continuous batching, hot
swaps, batch invariance (the reference's ``tests/test_serve.py``
properties, re-proved on ``repro_torch.serve``).

The load-bearing guarantee: batching changes nothing about what a
request computes.  Every request gathers its own version-ring row and
runs as its own agent of the stacked forward, so a continuous batch of
requests — admitted and retired at different ticks, across a param hot
swap — ends on the voxels, after the ticks, that serving each request
alone (``max_batch=1``) on the version it pinned gives.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: these sizes gain nothing from more, and spinning
# OpenMP threads in parallel test workers would starve the other tests
torch.set_num_threads(1)

from repro_torch.configs.adfll_dqn import DQNConfig  # noqa: E402
from repro_torch.core.erb import TaskTag, erb_add, erb_init  # noqa: E402
from repro_torch.models.sharding import make_fleet_mesh  # noqa: E402
from repro_torch.optim.adamw import leaves  # noqa: E402
from repro_torch.rl.agent import DQNAgent  # noqa: E402
from repro_torch.rl.dqn import dqn_init  # noqa: E402
from repro_torch.rl.env import LandmarkEnv, apply_actions  # noqa: E402
from repro_torch.rl.fleet import ActSteps, FleetEngine, make_act_steps  # noqa: E402
from repro_torch.rl.fleet import tree_map  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    LocalizationService,
    ParamPublisher,
    ServeReport,
    TrafficSpec,
    build_session,
    run_session,
    synthetic_requests,
)
from repro_torch.serve.queue import RequestQueue, _Ticket  # noqa: E402
from repro_torch.serve.report import RequestRecord  # noqa: E402
from repro_torch.telemetry import Telemetry  # noqa: E402

# the reference's tests/test_serve.py widths
CFG = DQNConfig(
    volume_shape=(16, 16, 16),
    box_size=(6, 6, 6),
    conv_features=(4,),
    hidden=(32,),
    max_episode_steps=12,
    batch_size=16,
    eps_decay_steps=100,
)
SERVE = dict(device="cpu")


def _stacked_params(n_agents: int, seed: int = 0, cfg: DQNConfig = CFG) -> dict:
    """A hand-built published tree: per-seed inits stacked [N, ...]."""
    params = [
        dqn_init(cfg, torch.Generator().manual_seed(seed + i)) for i in range(n_agents)
    ]
    return tree_map(lambda *xs: torch.stack(xs), *params)


def _requests(n: int, seed: int = 0, n_agents: int = 2):
    spec = TrafficSpec(n_requests=n, seed=seed)
    return synthetic_requests(spec, CFG, n_agents=n_agents)


def _final_locs(service: LocalizationService, ids):
    return {i: tuple(int(v) for v in service.results[i].final_loc) for i in ids}


# -- the act program ----------------------------------------------------------


@pytest.mark.parametrize("cfg", [CFG, DQNConfig()], ids=["tiny", "full"])
def test_act_is_bitwise_invariant_to_its_batch(cfg):
    """Each request of a batch of 16 gives bit for bit the q-values it
    gets dispatched alone and in every smaller pow2 batch (at
    ``DQNConfig()`` a lone request runs as two lanes: at ``groups=1``
    PyTorch's ungrouped convolution rounds differently)."""
    rng = np.random.default_rng(0)
    stacked = _stacked_params(8, cfg=cfg)  # a 2-slot ring of 4 agents
    b = 16
    slot = torch.tensor(rng.integers(0, 8, b))
    obs = torch.tensor(rng.standard_normal((b, *cfg.box_size)), dtype=torch.float32)
    loc = torch.tensor(rng.random((b, 3)), dtype=torch.float32)
    steps = ActSteps(cfg, "cpu")
    actions, q = steps.act(stacked, slot, obs, loc)
    assert actions.dtype == torch.int32 and q.shape == (b, cfg.n_actions)
    assert torch.equal(actions, q.argmax(-1).to(torch.int32))
    for i in range(b):
        a1, q1 = steps.act(stacked, slot[i : i + 1], obs[i : i + 1], loc[i : i + 1])
        assert torch.equal(q1[0], q[i]) and a1[0] == actions[i]
    for n in (2, 4, 8):
        assert torch.equal(steps.act(stacked, slot[:n], obs[:n], loc[:n])[1], q[:n])
    # one new (batch, ring rows) shape each: 16, 1, 2, 4, 8
    assert steps.n_traces == 5


def test_act_steps_cache_is_keyed_by_config_and_device():
    steps = make_act_steps(CFG, "cpu")
    assert make_act_steps(CFG, torch.device("cpu")) is steps
    assert steps.device.type == "cpu"
    other = dataclasses.replace(CFG, hidden=(16,))
    assert make_act_steps(other, "cpu") is not steps


# -- continuous batching ------------------------------------------------------


def test_service_completes_all_requests_batched():
    service = LocalizationService(CFG, params=_stacked_params(2), max_batch=8, **SERVE)
    ids = [service.submit(r) for r in _requests(20)]
    report = service.drain()
    assert report.n_requests == 20
    assert sorted(service.results) == sorted(ids)
    for r in report.requests:
        assert 1 <= r.n_ticks <= CFG.max_episode_steps
        assert r.dist_err is not None  # synthetic traffic carries landmarks
    # continuous batching really batched: fewer ticks than serial sum
    assert report.n_ticks < sum(r.n_ticks for r in report.requests)


def test_no_new_shapes_after_warmup():
    service = LocalizationService(CFG, params=_stacked_params(2), max_batch=8, **SERVE)
    traces_after_warmup = service.steps.n_traces
    service.serve(_requests(20))
    assert service.steps.n_traces == traces_after_warmup
    assert service.report.recompiles == 0
    # only pow2 buckets were dispatched
    assert set(service.report.batch_sizes) <= set(service.buckets)


def test_bucket_ladder_is_pow2():
    params = _stacked_params(1, seed=3)
    for max_batch in (6, 8):
        service = LocalizationService(
            CFG, params=params, max_batch=max_batch, warmup=False, **SERVE
        )
        assert service.buckets == [1, 2, 4, 8]


def test_batched_results_identical_to_unbatched():
    params = _stacked_params(2)
    requests = _requests(12)
    batched = LocalizationService(CFG, params=params, max_batch=8, **SERVE)
    ids_b = [batched.submit(r) for r in requests]
    batched.drain()
    single = LocalizationService(CFG, params=params, max_batch=1, **SERVE)
    ids_s = [single.submit(r) for r in requests]
    single.drain()
    assert max(batched.report.batch_sizes) == 8
    assert set(single.report.batch_sizes) == {1}
    locs_b, locs_s = _final_locs(batched, ids_b), _final_locs(single, ids_s)
    for ib, i_s in zip(ids_b, ids_s, strict=True):
        assert locs_b[ib] == locs_s[i_s]
        assert batched.results[ib].n_ticks == single.results[i_s].n_ticks


def test_ring_is_owned_by_the_service():
    """The ring is a copy: writing a swap into it leaves the published
    tensors alone, and changing them afterwards changes no served row."""
    params = _stacked_params(2)
    before = [t.clone() for t in leaves(params)]
    publisher = ParamPublisher(lambda: params)
    service = LocalizationService(CFG, publisher=publisher, warmup=False, **SERVE)
    ring = [t.clone() for t in leaves(service._vparams)]
    assert all(r.shape[0] == 2 * t.shape[0] for r, t in zip(ring, before))
    assert service.install(publisher.publish())
    for t in leaves(params):
        t.add_(1.0)
    for got, want in zip(leaves(service._vparams), before, strict=True):
        assert torch.equal(got[:2], want) and torch.equal(got[2:], want)


# -- hot swap -----------------------------------------------------------------


def _two_version_publisher(n_agents: int = 2):
    """A publisher whose publishes alternate two distinct param sets."""
    versions = [_stacked_params(n_agents, seed=0), _stacked_params(n_agents, seed=9)]
    state = {"i": 0}

    def source():
        p = versions[state["i"] % 2]
        state["i"] += 1
        return p

    return ParamPublisher(source), versions


def test_hot_swap_consistency_across_versions():
    """A request admitted before a swap completes on the old version; one
    admitted after uses the new one; both match unbatched serving."""
    publisher, versions = _two_version_publisher()
    service = LocalizationService(
        CFG, publisher=publisher, max_batch=4, n_version_slots=2, max_staleness=1,
        **SERVE,
    )
    requests = _requests(8)
    pre, post = requests[:4], requests[4:]  # one full batch each
    ids_pre = [service.submit(r) for r in pre]
    # admit + advance the pre-swap cohort one tick, then publish v1:
    # the cohort stays pinned to v0 while v1 serves later admissions
    service.tick()
    publisher.publish()
    ids_post = [service.submit(r) for r in post]
    report = service.drain()

    assert report.n_swaps == 1
    assert [service.results[i].version for i in ids_pre] == [0] * 4
    assert [service.results[i].version for i in ids_post] == [1] * 4
    assert report.versions_served == {0: 4, 1: 4}
    cohorts = ((ids_pre, pre, versions[0]), (ids_post, post, versions[1]))
    for cohort, reqs, params in cohorts:
        ref = LocalizationService(CFG, params=params, max_batch=1, **SERVE)
        ref_ids = [ref.submit(r) for r in reqs]
        ref.drain()
        got, want = _final_locs(service, cohort), _final_locs(ref, ref_ids)
        for i_mix, i_ref in zip(cohort, ref_ids, strict=True):
            assert got[i_mix] == want[i_ref]
            assert service.results[i_mix].n_ticks == ref.results[i_ref].n_ticks


def test_swap_deferred_while_target_slot_busy():
    """With a 1-slot ring, a swap cannot land while any request is in
    flight — and the staleness bound then stalls admission."""
    publisher, _ = _two_version_publisher()
    service = LocalizationService(
        CFG, publisher=publisher, max_batch=2, n_version_slots=1, max_staleness=0,
        **SERVE,
    )
    for r in _requests(6):
        service.submit(r)
    service.tick()  # two requests now in flight on v0
    publisher.publish()  # v1: can't land, slot 0 is busy
    assert service.sync_params() is False
    assert service.report.n_deferred_swaps >= 1
    assert service.current_version == 0
    report = service.drain()
    # admission paused until the in-flight pair retired, then v1 landed
    assert report.n_stall_ticks >= 1
    assert report.n_swaps == 1
    assert set(report.versions_served) == {0, 1}


def test_stale_or_duplicate_publish_rejected():
    params = _stacked_params(2)
    publisher = ParamPublisher(lambda: params)
    service = LocalizationService(CFG, publisher=publisher, warmup=False, **SERVE)
    pv0 = publisher.latest
    assert service.install(pv0) is False  # duplicate of the installed v0
    assert service.report.n_swaps == 0
    pv1 = publisher.publish()
    assert service.install(pv1) is True
    assert service.current_version == 1
    assert service.install(pv0) is False  # stale


def test_agent_mismatch_rejected():
    service = LocalizationService(
        CFG, params=_stacked_params(2), warmup=False, **SERVE
    )
    other = ParamPublisher(lambda: _stacked_params(3))
    with pytest.raises(ValueError, match="agents"):
        service.install(other.publish())


def test_service_arguments_validated():
    params = _stacked_params(1)
    with pytest.raises(ValueError, match="exactly one"):
        LocalizationService(CFG, **SERVE)
    with pytest.raises(ValueError, match="max_batch"):
        LocalizationService(CFG, params=params, max_batch=0, **SERVE)
    with pytest.raises(ValueError, match="n_version_slots"):
        LocalizationService(CFG, params=params, n_version_slots=0, **SERVE)


# -- publisher ----------------------------------------------------------------


def test_publisher_monotonic_versions():
    publisher = ParamPublisher(lambda: _stacked_params(2))
    assert publisher.version == -1 and publisher.latest is None
    assert [publisher.publish().version for _ in range(3)] == [0, 1, 2]
    assert publisher.latest.version == 2 and publisher.latest.n_agents == 2


def _filled_erb(rng, n: int = 64):
    erb = erb_init(n, CFG.box_size, task=TaskTag("t1", "axial", "HGG"))
    erb_add(
        erb,
        {
            "obs": rng.standard_normal((n, *CFG.box_size)).astype(np.float32),
            "loc": rng.random((n, 3)).astype(np.float32),
            "action": rng.integers(0, CFG.n_actions, n).astype(np.int32),
            "reward": rng.standard_normal(n).astype(np.float32),
            "next_obs": rng.standard_normal((n, *CFG.box_size)).astype(np.float32),
            "next_loc": rng.random((n, 3)).astype(np.float32),
            "done": np.zeros(n, np.float32),
        },
    )
    return erb


def test_publisher_flush_on_read_and_snapshots_stay_put(rng):
    """Publishing mid-round forces the engine flush: the snapshot carries
    the pending job's training.  A published version's tensors do not
    change when the engine trains on."""
    engine = FleetEngine(CFG, device="cpu")
    agent = DQNAgent(0, CFG, seed=0, engine=engine)
    erb = _filled_erb(rng)
    publisher = ParamPublisher(engine)
    v0 = publisher.publish()
    v0_copy = [t.clone() for t in leaves(v0.params)]
    plans = [agent.sampler.plan(agent.rng, CFG.batch_size, erb) for _ in range(4)]
    engine.submit(agent.slot, plans)  # pending, not yet flushed
    v1 = publisher.publish()  # must flush before snapshotting
    assert v1.train_steps == 4 and not engine._pending
    assert any(
        not torch.equal(a, b) for a, b in zip(leaves(v0.params), leaves(v1.params))
    )
    assert all(map(torch.equal, leaves(v0.params), v0_copy))
    v1_copy = [t.clone() for t in leaves(v1.params)]
    plans = [agent.sampler.plan(agent.rng, CFG.batch_size, erb) for _ in range(3)]
    engine.submit(agent.slot, plans)
    engine.flush()  # a further round trains past v1
    assert engine.n_steps_trained == 7
    assert all(map(torch.equal, leaves(v1.params), v1_copy))
    assert not all(map(torch.equal, leaves(engine.stacked_params()), v1_copy))


def test_stacked_params_never_leak_dead_rows():
    engine = FleetEngine(CFG, device="cpu")
    for seed in range(3):
        engine.add_slot(seed)
    assert engine.capacity == 4
    stacked = engine.stacked_params()
    assert all(t.shape[0] == 3 for t in leaves(stacked))
    for s in range(3):
        for got, want in zip(leaves(stacked), leaves(engine.get_params(s))):
            assert torch.equal(got[s], want)
    engine.add_slot(3)  # capacity full: the resident tree itself
    assert engine.stacked_params() is engine.state.params
    assert ParamPublisher(engine).publish().n_agents == 4


# -- queue / report / env helpers ---------------------------------------------


def test_queue_fifo_never_jumps_unarrived_head():
    q = RequestQueue()
    t = [_Ticket(i, r, CFG) for i, r in enumerate(_requests(3))]
    q.push(t[0], not_before=100.0)  # head not yet arrived
    q.push(t[1], not_before=0.0)
    q.push(t[2], not_before=0.0)
    assert q.pop_ready(now=1.0) is None  # FIFO: no jumping the head
    assert len(q) == 3
    assert q.pop_ready(now=200.0) is t[0]
    assert q.pop_ready(now=200.0) is t[1]
    assert q.pop_ready(now=200.0) is t[2]
    assert q.pop_ready(now=200.0) is None


def test_report_percentiles_and_summary():
    report = ServeReport(wall_time_s=2.0)
    for i, lat in enumerate((0.010, 0.020, 0.030, 0.040)):
        report.requests.append(
            RequestRecord(
                request_id=i,
                agent_id=0,
                version=0,
                n_ticks=5,
                latency_s=lat,
                queued_s=0.0,
                dist_err=float(i),
            )
        )
    assert report.percentile_ms(50) == pytest.approx(25.0)
    s = report.summary()
    assert s["n_requests"] == 4
    assert s["requests_per_sec"] == pytest.approx(2.0)
    assert s["p50_latency_ms"] == pytest.approx(25.0)
    assert s["ticks_per_request"] == 5.0
    assert s["mean_dist_err"] == pytest.approx(1.5)
    assert s["recompiles"] == 0
    empty = ServeReport().summary()
    assert empty["p50_latency_ms"] is None and empty["requests_per_sec"] == 0.0


def test_apply_actions_matches_env_step():
    rng = np.random.default_rng(1)
    vol = rng.standard_normal((16, 16, 16)).astype(np.float32)
    env = LandmarkEnv(vol, np.array([8.0, 8.0, 8.0], np.float32), CFG)
    locs = rng.integers(0, 16, size=(9, 3)).astype(np.int32)
    actions = rng.integers(0, CFG.n_actions, size=9).astype(np.int32)
    new, _, _ = env.step(locs, actions)
    np.testing.assert_array_equal(
        new, apply_actions(locs, actions, env.n, CFG.step_size)
    )
    edge = np.array([[15, 15, 15]], np.int32)
    out = apply_actions(edge, np.array([0]), np.array([16]), 1)
    np.testing.assert_array_equal(out, edge)  # clipped at n-1


def test_oscillation_termination():
    """A ticket retires the moment the rollout revisits a voxel."""
    ticket = _Ticket(0, _requests(1)[0], CFG)
    start = ticket.loc.copy()
    step = np.array([0, 0, CFG.step_size], np.int32)
    assert ticket.advance(start + step) is False
    assert ticket.advance(start) is True  # revisit -> oscillation
    assert ticket.n_ticks == 2


# -- train-while-serve session ------------------------------------------------


def test_run_session_serves_across_a_swap():
    traffic = TrafficSpec(n_requests=12, max_batch=4, seed=2)
    session = build_session(CFG, n_agents=2, traffic=traffic, seed=2, device="cpu")
    assert session.service.device.type == "cpu"
    report = run_session(session, traffic, n_waves=2, train_steps=5)
    assert report.n_requests == 12
    assert report.n_swaps == 1
    assert report.recompiles == 0
    assert set(report.versions_served) == {0, 1}
    # one round of 2 agents x 5 steps, one flush of 5 stacked steps
    assert session.engine.n_chunk_steps == 5 and session.engine.n_steps_trained == 10
    assert session.publisher.latest.train_steps == 10


def test_session_refuses_what_is_not_ported(monkeypatch):
    traffic = TrafficSpec(n_requests=4)
    # devices resolve over what the session's device names: a CPU session
    # gets no mesh, whatever the cards (the reference's rule); on the card
    # the call names the cards
    for count in (0, 2):
        monkeypatch.setattr(torch.cuda, "device_count", lambda c=count: c)
        session = build_session(
            CFG, n_agents=1, traffic=traffic, devices=2, device="cpu"
        )
        assert session.engine.mesh is None and session.engine.sharding.size == 1
    cards = (torch.device("cuda", 0), torch.device("cuda", 1))
    assert make_fleet_mesh(2, device="cuda").devices == cards
    monkeypatch.undo()

    # enabled telemetry is ported: the session's fleet gets the
    # observatory and the service the bundle
    tel = Telemetry(enabled=True)
    session = build_session(CFG, n_agents=1, traffic=traffic, telemetry=tel, device="cpu")
    assert session.engine.observatory is not None
    assert session.engine.telemetry is tel and session.service.telemetry is tel
    service = LocalizationService(
        CFG, params=_stacked_params(1), telemetry=tel, device="cpu"
    )
    assert service.telemetry is tel


def test_serve_traffic_requires_serve_system():
    from repro_torch.experiments.registry import get_scenario
    from repro_torch.experiments.spec import ScenarioSpec

    with pytest.raises(ValueError, match="serve_traffic"):
        ScenarioSpec(name="x", system="adfll", serve_traffic=TrafficSpec())
    spec = get_scenario("serve_localization")
    assert (spec.system, spec.seed, spec.dqn.conv_features) == ("serve", 600, (4,))
    assert spec.serve_traffic == TrafficSpec(
        n_requests=32, max_batch=8, n_version_slots=2, max_staleness=1
    )
