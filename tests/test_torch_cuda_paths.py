"""The port's training paths on the card, each against the same run on
the CPU (``cuda`` tests: they skip without a card).  Nothing here
imports JAX, so the tests run where the card is.

* topology: ``topo_hybrid`` and ``topo_gossip_topk`` train through the
  kernels, one ``replay_gather`` and one ``fused_td`` launch per stacked
  step, mix weight snapshots, and keep the CPU run's round order and
  wire counts; round 0's loss within 1e-4 (its rows come from
  exploration alone, so both sides train on the same rows).
* stepwise: one ``fused_td`` launch per agent step and one
  ``replay_gather`` launch per replay pick; round 0 within 1e-4.
* the fleet's main path (``paper_fig2``): card against CPU from one init
  (the port's own, drawn on the host), round 0 within 1e-4 and the same
  round metadata throughout.
* churn and a hub failure on ``paper_fig2``: two agents join mid-run
  (the resident axis grows 4 -> 8), hub 2 dies and its agents re-home,
  then the newest agent leaves; one ``replay_gather`` and one
  ``fused_td`` launch per stacked step, the CPU run's round metadata,
  round 0 within 1e-4.
* the fleet axis on a mesh of ``cuda:0`` twice: one round of 4 slots
  against the unsharded engine, params and losses within 1e-6, A and B
  once per shard per stacked step.
* serving: one train-while-serve session at ``max_batch=1`` and at
  ``max_batch=8`` on the card (identical seeds, so identical published
  versions): every request's final voxel, ticks and pinned version
  identical, one ``replay_gather`` and one ``fused_td`` launch per
  stacked step of the round between the waves.
* the observatory's statistics: ``fused_td`` with ``td_abs`` and
  ``q_max`` against ``fused_td_plain`` (1e-6, NaN where it has NaN) in
  one launch, its other outputs bit for bit those of the launch
  without statistics; ``train_chunk_stats`` bit for bit
  ``train_chunk`` on the card, its statistics within 1e-4 of the CPU's;
  and an observed ``paper_fig2`` against the unobserved one on the card
  (identical records, as far as two unobserved runs agree), A = B =
  stacked steps with the observatory on.
* the fleet engine's CUDA graphs: flushes of 1-4 of 4 slots (the
  resident and the gathered path), statistics off and on, eager, then
  captured, then replayed, against direct ``train_chunk`` and
  ``train_chunk_stats`` calls on the same state, pool and index, bit for
  bit, through a growth of the replay pool that captures again (warm,
  its new graph replayed for the flush's result); a
  snapshot taken before a replay unchanged by it; graphs that turn to
  garbage during another engine's capture are not collected inside it;
  engines that captured leave no device memory behind once deleted.
* the zoo's LM train step: C's backward (``RMSNorm``) against autograd
  through ``rmsnorm_plain`` at the danube train shape; a reduced
  float32 h2o-danube-3-4b's ``loss_fn`` and its gradients on the card
  against the CPU (every leaf's gradient non-zero on the card: a kernel
  output that autograd cannot see through would cut the norms' and the
  attention projections' gradients to zero), C launched ``2L + 1``
  times a forward and the rematerialised groups' norms again in the
  backward (:func:`norms_recomputed`), D never; and D refusing a
  gradient on the card.
* per-layer rematerialisation (chip_smoke's ``lm_train_remat`` (a) at
  h2o-danube-3-4b-smoke's widths, bf16): the loss and every gradient
  leaf with remat against without on the card (1e-5 relative, 1e-4 of
  the leaf's scale), C ``2L + 1`` without and ``2L + 1 + 2L`` with it,
  D never.
* the zoo's Mamba path: jamba-1.5-large-398b's reduced float32 config
  (Mamba with MoE and dense FFNs, one attention layer without rope),
  the teacher-forced forward, a prefill and 4 decode steps on the card
  against the CPU from one init within 1e-4; C launched once a mixer,
  once an FFN and once for the final norm each forward, D once a
  forward (its one attention layer, on the scalar float32 route).
* the examples' paths: D's scalar route at the quickstart's float32
  ``[1, 128, 4|2, 32]`` (one launch, 2e-5 of the plain version), and
  xlstm-125m's train step at full width and depth (every leaf's
  gradient non-zero, a finite loss, C 13 launches a forward and the
  rematerialised groups' again, D none).

* expert-parallel MoE on a one-rank NCCL ``(data 1, model 1)`` mesh
  (chip_smoke's ``moe_ep`` (b) at qwen3-moe-smoke's widths): the
  per-shard body forced past ``moe_apply``'s routing, train (two
  all-to-alls) and decode (an all-reduce), bit for bit the local path,
  and the train branch's gradients through the collectives within 1e-6
  of the local path's.
* the zoo's tensor, sequence and FSDP parallel body on a one-rank NCCL
  mesh (chip_smoke's ``lm_train_mesh`` at h2o-danube-3-4b-smoke's
  float32 widths): ``Model(mesh=)`` issues every collective over groups
  of one; 2 train steps and a prefill against the mesh-less model from
  the same init, losses and grad norms within 1e-5 relative, params
  within 1e-4 of their scale, logits within 1e-4.

* KDA's chunked prefill, kernel F: ``kda_chunk`` against its plain
  version at 1-1024 tokens and three head widths, float32 and bf16
  outputs, steep decays; the route by autograd (``calls_by_route``); and
  Kimi-Linear's smoke model, prefill through F then teacher-forced
  decode, against the CPU.

* the mHC site, kernel G: ``mhc.pre`` and ``mhc.post`` against the plain
  forms at Xing4.0's decode shape (128 rows of 4 x 3584), prefill slices
  (4,096 and 16,384 rows: one slice a row block, then 32 rows a CTA) and
  the smoke width, bf16 and float32: the coefficients and ``H_res``
  within 1e-5, ``u`` and the new stream within 2**-7 (bf16) or 1e-5
  (float32) of their largest; two launches a site; a call autograd would
  record refused; a captured site's replays advance G's counter; Xing4.0's
  smoke model, prefill through G (two launches a site, every site counted
  as ``kernel``) then teacher-forced decode, against the CPU.

* the zoo's decode graphs (``models/model.py::DecodeArena``):
  ``generate`` on the graph path against the eager loop on fresh caches
  of the same bucketed length, bit for bit (tokens and logits), for every
  zoo architecture's smoke config and DeepSeek-V2-Lite's and
  Kimi-Linear's in bf16 (a capture, then replays; a second generation all
  replays); a longer prompt, then a shorter one in the same 64-slot
  bucket (the stale slots emptied); two buckets of one batch alternating
  on Kimi-Linear's shared KDA state; the kernels' launch counters per
  replay as per eager step; the allocated bytes back to the model-free
  level once the model goes.

* the tracer's clock anchor: a kernel synchronised inside a wall span
  lies inside the span on the profiler's timeline
  (``Tracer.to_profiler_us``), within 50 us at each end.

Run on a machine with a card:
    PYTHONPATH=src python -m pytest tests/test_torch_cuda_paths.py -m cuda
"""

import dataclasses
import gc
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.adfll_dqn import DQNConfig  # noqa: E402
from repro_torch.core.experiment import ChurnEvent, HubFailure  # noqa: E402
from repro_torch.experiments import registry  # noqa: E402
from repro_torch.experiments.runner import build, evaluate_into  # noqa: E402
from repro_torch.core.erb import TaskTag, erb_add, erb_flatten, erb_init, flat_columns  # noqa: E402
from repro_torch.core.replay import SelectiveReplaySampler  # noqa: E402
from repro_torch.kernels.fused_td import fused_td, fused_td_plain  # noqa: E402
from repro_torch.kernels.kda_chunk import kda_chunk, kda_chunk_plain  # noqa: E402
from repro_torch.kernels.kda_step import kda_step, kda_step_plain  # noqa: E402
from repro_torch.kernels import graphs  # noqa: E402
from repro_torch.kernels.mhc import mhc, mhc_post_plain, mhc_pre_plain  # noqa: E402
from repro_torch.kernels.replay_gather import replay_gather  # noqa: E402
from repro_torch.configs.base import FFN_NONE, KDA, get_config  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.rmsnorm import RMSNorm, rmsnorm, rmsnorm_plain  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models.model import (  # noqa: E402
    Model,
    forward,
    graph_cache_len,
    logits_fn,
    make_loss_fn,
    make_serve_step,
)
from repro_torch.optim.adamw import leaves, tree_leaves  # noqa: E402
from repro_torch.models.sharding import FleetMesh, ShardingPolicy  # noqa: E402
from repro_torch.rl.fleet import FleetEngine, FleetSteps, unpack_stats  # noqa: E402
from repro_torch.serve import TrafficSpec, build_session, run_session  # noqa: E402
from repro_torch.telemetry import Telemetry  # noqa: E402

# tiny widths: each run takes seconds on either device
TINY = DQNConfig(
    volume_shape=(12, 12, 12),
    box_size=(4, 4, 4),
    conv_features=(2,),
    hidden=(8,),
    batch_size=4,
    max_episode_steps=4,
)


def norms_recomputed(cfg) -> int:
    """C launches a rematerialised train step adds to a forward's: each
    group's recompute runs its blocks but the last (the checkpoint stops
    once the last block's input is saved), then each block's its own."""
    per = [1 + (ffn != FFN_NONE) for _, ffn in cfg.pattern]
    return cfg.n_groups * (2 * sum(per) - per[-1])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _tiny(name, **sys_overrides):
    spec = registry.get_scenario(name)
    sys_cfg = dataclasses.replace(spec.sys, erb_capacity=256, **sys_overrides)
    return dataclasses.replace(
        spec, dqn=TINY, sys=sys_cfg, eval_tasks=2, eval_patients=1, fast_train_steps=2
    ).fast()


def _card_and_cpu(spec, cuda):
    """Run ``spec`` on the CPU, then on the card with the launches read
    around the card's run alone; returns the two systems and reports."""
    out = []
    for dev in ("cpu", cuda):
        system = build(spec, device=dev)
        replay_gather.launches = fused_td.launches = 0
        report = system.run()
        evaluate_into(report, system, spec)
        out.append((system, report))
    torch.cuda.synchronize()
    return out


def _same_rounds(cpu, card):
    assert abs(card.history[0].loss - cpu.history[0].loss) <= 1e-4
    meta = [[dataclasses.astuple(r)[:6] for r in rep.history] for rep in (cpu, card)]
    assert meta[0] == meta[1] and len(meta[0]) > 0
    assert card.bytes_by_plane == cpu.bytes_by_plane
    assert card.msgs_by_plane == cpu.msgs_by_plane
    assert np.isfinite(card.mean_dist_err)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["topo_hybrid", "topo_gossip_topk"])
def test_topology_trains_through_the_kernels_on_card(name, cuda):
    (_, cpu), (system, card) = _card_and_cpu(_tiny(name), cuda)
    steps = system.engine.n_chunk_steps
    assert steps > 0 and replay_gather.launches == fused_td.launches == steps
    assert card.n_mixed > 0 and card.bytes_by_plane["weights"] > 0
    _same_rounds(cpu, card)


@pytest.mark.cuda
def test_stepwise_trains_through_the_kernels_on_card(cuda):
    (_, cpu), (system, card) = _card_and_cpu(
        _tiny("paper_fig2", engine="stepwise"), cuda
    )
    agents = system.agents.values()
    steps = sum(a.step_count for a in agents)
    assert system.engine is None and steps > 0
    assert fused_td.launches == steps
    assert replay_gather.launches == sum(a.n_picks_gathered for a in agents)
    _same_rounds(cpu, card)


@pytest.mark.cuda
def test_fleet_round_zero_card_matches_cpu(cuda):
    (_, cpu), (system, card) = _card_and_cpu(_tiny("paper_fig2"), cuda)
    assert replay_gather.launches == fused_td.launches == system.engine.n_chunk_steps
    _same_rounds(cpu, card)


@pytest.mark.cuda
def test_churn_and_hub_failure_train_through_the_kernels_on_card(cuda):
    spec = dataclasses.replace(
        _tiny("paper_fig2"),
        churn=(
            ChurnEvent(at=0.5, action="add", count=2),
            ChurnEvent(at=1.2, action="remove"),
        ),
        hub_failures=(HubFailure(at=0.9, hub_id=2),),
    )
    (cpu_sys, cpu), (system, card) = _card_and_cpu(spec, cuda)
    assert replay_gather.launches == fused_td.launches == system.engine.n_chunk_steps
    assert system.engine.capacity == 8 and sorted(system.live_agents()) == [
        0,
        1,
        2,
        3,
        4,
    ]
    assert not system.network.hubs[2].alive
    assert [(p.t, p.n_agents) for p in card.eval_curve] == [
        (p.t, p.n_agents) for p in cpu.eval_curve
    ]
    _same_rounds(cpu, card)


@pytest.mark.cuda
def test_batched_serving_matches_single_on_card(cuda):
    out = []
    for max_batch in (1, 8):
        traffic = TrafficSpec(
            n_requests=24, max_batch=max_batch, n_version_slots=2, max_staleness=1
        )
        session = build_session(TINY, n_agents=2, traffic=traffic, device=cuda)
        replay_gather.launches = fused_td.launches = 0
        report = run_session(session, traffic, n_waves=2, train_steps=5)
        assert replay_gather.launches == fused_td.launches == 5
        assert session.engine.n_chunk_steps == 5
        assert report.n_swaps == 1 and report.recompiles == 0
        assert session.service._vparams["fc0"]["w"].device.type == "cuda"
        results = session.service.results
        out.append(
            [
                (tuple(results[i].final_loc.tolist()), results[i].n_ticks,
                 results[i].version)
                for i in sorted(results)
            ]
        )
        out.append(set(report.batch_sizes))
    single, single_buckets, batched, batched_buckets = out
    assert single_buckets == {1} and max(batched_buckets) > 1
    assert single == batched and {v for *_, v in single} == {0, 1}


@pytest.mark.cuda
def test_sharded_engine_matches_unsharded_on_card(cuda):
    """The fleet engine on a mesh of ``cuda:0`` twice against the
    unsharded engine on the card, from the same init, after one round of
    5 steps for 4 slots: params and losses within 1e-6; A and B launched
    once per shard per stacked step, on that shard's operands."""
    mesh = FleetMesh((torch.device("cuda", 0),) * 2)
    engines = [
        FleetEngine(TINY, device=cuda),
        FleetEngine(TINY, device=cuda, mesh=mesh),
    ]
    rng = np.random.default_rng(0)
    n = 128
    erb = erb_init(n, TINY.box_size, task=TaskTag("t1", "axial", "HGG"))
    erb_add(
        erb,
        {
            "obs": rng.standard_normal((n, *TINY.box_size)).astype(np.float32),
            "loc": rng.random((n, 3)).astype(np.float32),
            "action": rng.integers(0, TINY.n_actions, n).astype(np.int32),
            "reward": rng.standard_normal(n).astype(np.float32),
            "next_obs": rng.standard_normal((n, *TINY.box_size)).astype(np.float32),
            "next_loc": rng.random((n, 3)).astype(np.float32),
            "done": (rng.random(n) < 0.1).astype(np.float32),
        },
    )
    futures = []
    for engine in engines:
        for seed in range(4):
            engine.add_slot(seed)
        sampler = SelectiveReplaySampler()
        jobs = []
        for slot in range(4):
            plan_rng = np.random.default_rng(10 + slot)
            plans = [sampler.plan(plan_rng, TINY.batch_size, erb) for _ in range(5)]
            jobs.append(engine.submit(slot, plans))
        replay_gather.launches = fused_td.launches = 0
        engine.flush()
        torch.cuda.synchronize()
        assert replay_gather.launches == fused_td.launches == engine.n_shard_steps
        futures.append(jobs)
    assert engines[1].n_shard_steps == 2 * engines[0].n_shard_steps == 10
    for slot in range(4):
        assert abs(futures[0][slot].loss - futures[1][slot].loss) <= 1e-6
        assert engines[1].slot_device(slot) == torch.device("cuda", 0)
        for a, b in zip(
            leaves(engines[0].get_params(slot)), leaves(engines[1].get_params(slot))
        ):
            assert float((a - b).abs().max()) <= 1e-6


def _td_inputs(rng, n, b, a, out_of_range, device):
    cols = flat_columns(TINY.box_size)
    td_cols = tuple(cols[k].start for k in ("action", "reward", "done"))
    q = rng.standard_normal((n, b, a)).astype(np.float32)
    q_next = rng.standard_normal((n, b, a)).astype(np.float32)
    rows = rng.standard_normal((n, b, cols["done"].stop)).astype(np.float32)
    rows[..., td_cols[0]] = rng.integers(0, a, (n, b))
    rows[..., td_cols[2]] = rng.random((n, b)) < 0.3
    if out_of_range:
        edge = [2.7, -0.5, np.nan, -1, -6, 6, 7, -7, -100, 1e10, 5.9, 0]
        rows[0, : len(edge), td_cols[0]] = edge[:b]
        q[n - 1, 0, 0] = np.nan
    ins = [torch.from_numpy(x).to(device) for x in (q, q_next, rows)]
    return ins, td_cols


@pytest.mark.cuda
@pytest.mark.parametrize(
    "n,b,a,out_of_range",
    [(4, 32, 6, False), (3, 50, 6, False), (1, 7, 1, False), (2, 12, 6, True)],
)
def test_fused_td_stats_match_plain_on_card(cuda, n, b, a, out_of_range):
    ins, td_cols = _td_inputs(np.random.default_rng(b), n, b, a, out_of_range, cuda)
    before = fused_td.launches
    stats = (torch.empty(n, device=cuda), torch.empty(n, device=cuda))
    got = fused_td(*ins, td_cols, 0.9, stats)
    bare = fused_td(*ins, td_cols, 0.9)
    want = fused_td_plain(*ins, td_cols, 0.9)
    torch.cuda.synchronize()
    assert fused_td.launches == before + 2  # one launch each
    assert got.td_abs is stats[0] and got.q_max is stats[1]
    for name in ("td_abs", "q_max"):
        torch.testing.assert_close(
            getattr(got, name), getattr(want, name), atol=1e-6, rtol=1e-6,
            equal_nan=True, msg=name,
        )
    # the statistics change no other output
    for x, y in zip(got[:4], bare[:4], strict=True):
        assert torch.equal(x.nan_to_num(7.0), y.nan_to_num(7.0))
    if out_of_range:
        assert torch.isnan(got.td_abs[0]) and torch.isnan(got.q_max[-1])


def _chunk_inputs(rng, steps, n):
    cfg = steps.cfg
    slots = [steps.init_slot(seed) for seed in range(n)]
    state = slots[0].map(lambda *xs: torch.cat(xs), *slots[1:])
    cols = flat_columns(cfg.box_size)
    pool = rng.random((256, cols["done"].stop), dtype=np.float32)
    pool[:, cols["action"].start] = rng.integers(0, cfg.n_actions, 256)
    pool[:, cols["done"].start] = rng.random(256) < 0.1
    idx = rng.integers(0, 256, (4, n, cfg.batch_size)).astype(np.int32)
    return state, torch.from_numpy(pool), torch.from_numpy(idx)


@pytest.mark.cuda
def test_train_chunk_stats_on_card(cuda):
    cpu_steps = FleetSteps(TINY, "cpu")
    state, pool, idx = _chunk_inputs(np.random.default_rng(0), cpu_steps, 3)
    _, cpu_packed = cpu_steps.train_chunk_stats(state, pool, idx)
    steps = FleetSteps(TINY, cuda)
    state, pool, idx = (state.map(lambda x: x.to(cuda)), pool.to(cuda), idx.to(cuda))
    replay_gather.launches = fused_td.launches = 0
    new, packed = steps.train_chunk_stats(state, pool, idx)
    assert replay_gather.launches == fused_td.launches == 4
    plain, losses = steps.train_chunk(state, pool, idx)
    torch.cuda.synchronize()
    stats = unpack_stats(packed.cpu().numpy(), 4)
    assert np.array_equal(stats["loss"], losses.cpu().numpy())
    for a, b in zip(leaves(new.params), leaves(plain.params), strict=True):
        assert torch.equal(a, b)
    want = unpack_stats(cpu_packed.numpy(), 4)
    for name in ("loss", "td_abs", "q_max", "grad_norm"):
        np.testing.assert_allclose(stats[name], want[name], atol=1e-4, rtol=0)
    assert stats["params_finite"].all() and want["params_finite"].all()


def _random_rows(rng, n):
    box = TINY.box_size
    return {
        "obs": rng.standard_normal((n, *box)).astype(np.float32),
        "loc": rng.random((n, 3)).astype(np.float32),
        "action": rng.integers(0, TINY.n_actions, n).astype(np.int32),
        "reward": rng.standard_normal(n).astype(np.float32),
        "next_obs": rng.standard_normal((n, *box)).astype(np.float32),
        "next_loc": rng.random((n, 3)).astype(np.float32),
        "done": (rng.random(n) < 0.1).astype(np.float32),
    }


class _Stats:
    """An observatory that keeps each flush's statistics."""

    def __init__(self):
        self.flushes = []

    def on_flush(self, slots, stats, n_jobs, sim_t):
        self.flushes.append(stats)


@pytest.mark.cuda
@pytest.mark.parametrize("stats", [False, True], ids=["plain", "stats"])
@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_engine_graphs_match_direct_chunks_on_card(cuda, n, stats):
    """Flushes of ``n`` of 4 slots (4: the resident path; fewer: the
    gathered one), 5 steps each, through the engine, against direct
    ``train_chunk`` (or ``train_chunk_stats``) calls on the same state,
    pool and index: state, losses and statistics bit for bit.  One key
    flushes four times (eager, capture, replay, replay), then the ERB
    outgrows the pool's 512 rows, and the shape's key at the new 4096
    captures again at once, warm, and replays twice.  A snapshot from ``get_params`` and
    ``stacked_params`` taken before a replay is unchanged after it; A
    and B count one launch a stacked step, replays included."""
    k_steps = 5
    rng = np.random.default_rng(n)
    erb = erb_init(1024, TINY.box_size, task=TaskTag("t1", "axial", "HGG"))
    erb_add(erb, _random_rows(rng, 100))
    engine = FleetEngine(TINY, device=cuda)
    engine.telemetry = Telemetry(enabled=True)
    if stats:
        engine.observatory = _Stats()
    for seed in range(4):
        engine.add_slot(seed)
    steps = engine.steps
    chunk = steps.train_chunk_stats if stats else steps.train_chunk
    sampler = SelectiveReplaySampler()
    ref = engine.state.map(torch.clone)
    for flush in range(7):
        if flush == 4:  # 600 rows: the pool grows to 4096
            erb_add(erb, _random_rows(rng, 500))
        plans = [
            [sampler.plan(rng, TINY.batch_size, erb) for _ in range(k_steps)]
            for _ in range(n)
        ]
        idx = np.stack(
            [
                np.stack([np.concatenate([r for _, r in p.picks])[p.perm] for p in job])
                for job in plans
            ],
            1,
        ).astype(np.int32)
        pool = torch.from_numpy(erb_flatten(erb)).to(cuda)
        rows = torch.arange(n, device=cuda)
        want, want_out = chunk(
            ref.map(lambda x: x.index_select(0, rows)), pool, torch.from_numpy(idx).to(cuda)
        )
        ref = ref.map(lambda s, w: s.index_copy(0, rows, w), want)
        if flush == 3:  # before a replay
            snap = engine.get_params(0)
            stacked = engine.stacked_params()
            snap_copy = [t.clone() for t in leaves(snap)]
            stacked_copy = [t.clone() for t in leaves(stacked)]
        futures = [engine.submit(slot, job) for slot, job in enumerate(plans)]
        replay_gather.launches = fused_td.launches = 0
        engine.flush()
        torch.cuda.synchronize()
        assert replay_gather.launches == fused_td.launches == k_steps
        got = engine.state
        for a, b in zip(leaves(got.params), leaves(ref.params), strict=True):
            assert torch.equal(a, b), flush
        for part in ("target", "opt"):
            for a, b in zip(
                tree_leaves(getattr(got, part)), tree_leaves(getattr(ref, part)), strict=True
            ):
                assert torch.equal(a, b), (flush, part)
        assert torch.equal(got.count, ref.count)
        host = want_out.cpu().numpy()
        last = unpack_stats(host, k_steps)["loss"][-1] if stats else host[-1]
        assert [f.loss for f in futures] == [float(x) for x in last]
        if stats:
            seen = engine.observatory.flushes[-1]
            for name, value in unpack_stats(host, k_steps).items():
                assert np.array_equal(seen[name], value), (flush, name)
        if flush == 3:
            for a, b in zip(leaves(snap), snap_copy, strict=True):
                assert torch.equal(a, b)
            for a, b in zip(leaves(stacked), stacked_copy, strict=True):
                assert torch.equal(a, b)
    modes = [e["args"]["graph"] for e in engine.telemetry.tracer.spans("fleet.flush")]
    assert modes == ["eager", "capture", "replay", "replay", "capture", "replay", "replay"]
    assert engine.n_graph_captures == 2 and engine.n_graph_replays == 4
    registry = engine.telemetry.registry
    assert registry.counter_value("fleet.graph.captures") == 2
    assert registry.counter_value("fleet.graph.replays") == 4
    assert [b.shape[0] for b in engine._pool_bufs.values()] == [4096]


@pytest.mark.cuda
def test_capture_outlives_a_collected_graph_on_card(cuda):
    """Graphs of another engine that turn to cyclic garbage while an
    engine captures are not collected inside that capture (the garbage
    collector is off while capturing; a graph destroyed then would abort
    the capture): the capture and its replay succeed."""
    import gc

    rng = np.random.default_rng(7)
    erb = erb_init(1024, TINY.box_size, task=TaskTag("t1", "axial", "HGG"))
    erb_add(erb, _random_rows(rng, 100))
    sampler = SelectiveReplaySampler()

    def flush(engine):
        for slot in range(2):
            engine.submit(slot, [sampler.plan(rng, TINY.batch_size, erb) for _ in range(3)])
        engine.flush()

    engines = []
    for _ in range(2):
        engine = FleetEngine(TINY, device=cuda)
        for seed in range(2):
            engine.add_slot(seed)
        flush(engine)  # eager
        flush(engine)  # captured
        engines.append(engine)
    old, new = engines
    assert old.n_graph_captures == new.n_graph_captures == 1
    erb_add(erb, _random_rows(rng, 500))  # new's pool grows: a warm capture
    chunk = new.steps.train_chunk

    def releasing(*args):
        # old's graphs held by a cycle, which only a collection frees
        box = {"graphs": list(old._graphs.values())}
        box["self"] = box
        old._graphs.clear()
        del box
        return chunk(*args)

    new.steps.train_chunk = releasing
    thresholds = gc.get_threshold()
    gc.set_threshold(1, 1, 1)
    try:
        flush(new)
    finally:
        gc.set_threshold(*thresholds)
    new.steps.train_chunk = chunk
    flush(new)
    gc.collect()
    torch.cuda.synchronize()
    assert new.n_graph_captures == 2 and new.n_graph_replays == 1
    assert all(torch.isfinite(t).all() for t in leaves(new.get_params(0)))


@pytest.mark.cuda
def test_engines_that_captured_are_freed_on_card(cuda):
    """Three engines in turn, each capturing a chunk and replaying it,
    then deleted: after the first, the allocated bytes return to their
    level each time.  (The first warms the process's capture stream,
    whose cuBLAS workspace outlives every engine; a stream of each
    engine's own would leave one workspace behind each.)"""
    rng = np.random.default_rng(11)
    erb = erb_init(1024, TINY.box_size, task=TaskTag("t1", "axial", "HGG"))
    erb_add(erb, _random_rows(rng, 100))
    sampler = SelectiveReplaySampler()
    levels = []
    for _ in range(3):
        engine = FleetEngine(TINY, device=cuda)
        for seed in range(2):
            engine.add_slot(seed)
        for _ in range(3):  # eager, captured, replayed
            for slot in range(2):
                plans = [sampler.plan(rng, TINY.batch_size, erb) for _ in range(3)]
                engine.submit(slot, plans)
            engine.flush()
        assert engine.n_graph_captures == engine.n_graph_replays == 1
        del engine
        gc.collect()
        torch.cuda.synchronize()
        levels.append(torch.cuda.memory_allocated(cuda))
    assert levels[1:] == [levels[0]] * 2


def _records(report):
    return json.dumps(
        [dataclasses.astuple(r) for r in report.history], default=str
    ), report.mean_dist_err


@pytest.mark.cuda
def test_observed_run_matches_unobserved_on_card(cuda):
    spec = _tiny("paper_fig2")
    runs = []
    for tel in (None, None, Telemetry(enabled=True)):
        system = build(spec, device=cuda, telemetry=tel)
        replay_gather.launches = fused_td.launches = 0
        report = system.run()
        launches = (replay_gather.launches, fused_td.launches)
        evaluate_into(report, system, spec)
        runs.append((system, report, launches))
    (_, off1, _), (_, off2, _), (system, on, launches) = runs
    steps = system.engine.n_chunk_steps
    assert launches == (steps, steps) and steps > 0
    if _records(off1) == _records(off2):
        assert _records(on) == _records(off1)
    else:  # the card differs from itself: on vs off may differ as much
        worst = max(
            abs(a.loss - b.loss) for a, b in zip(off1.history, off2.history)
        )
        assert all(
            abs(a.loss - b.loss) <= worst for a, b in zip(on.history, off1.history)
        )
    learning = on.extra["learning"]
    assert learning and all(
        np.isfinite(doc["last_loss"]) and doc["nonfinite_flushes"] == 0
        for doc in learning.values()
    )
    assert on.extra["health"]["status"] != "alert"


@pytest.mark.cuda
@pytest.mark.parametrize(
    "dtype, rtol", [(torch.float32, 1e-5), (torch.bfloat16, 3e-2)]
)
def test_rmsnorm_backward_matches_plain_on_card(cuda, dtype, rtol):
    """The danube train shape [2048, 3840]: C's forward launches once, its
    backward (plain torch) agrees with autograd through ``rmsnorm_plain``
    within ``rtol`` of each output's largest magnitude."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(2048, 3840, generator=gen, device=cuda).to(dtype)
    scale = torch.randn(3840, generator=gen, device=cuda)
    g = torch.randn(2048, 3840, generator=gen, device=cuda).to(dtype)
    out = []
    fns = (
        lambda a, b: RMSNorm.apply(a, b, 1e-5),
        lambda a, b: rmsnorm_plain(a, b, 1e-5),
    )
    for fn in fns:
        xa, sa = x.clone().requires_grad_(), scale.clone().requires_grad_()
        before = rmsnorm.launches
        y = fn(xa, sa)
        launched = rmsnorm.launches - before
        out.append((y, *torch.autograd.grad(y, (xa, sa), g), launched))
    (y, dx, ds, n), (y_p, dx_p, ds_p, n_p) = out
    assert (n, n_p) == (1, 0)
    for got, want in ((y, y_p), (dx, dx_p), (ds, ds_p)):
        got, want = got.detach(), want.detach()
        assert got.dtype == want.dtype
        err = float((got.float() - want.float()).abs().max())
        assert err <= rtol * float(want.float().abs().max())


@pytest.mark.cuda
def test_lm_loss_and_grads_card_match_cpu(cuda):
    cfg = dataclasses.replace(
        get_config("h2o-danube-3-4b").reduced(), n_kv_heads=2, sliding_window=64
    )
    params = Model(cfg, "cpu").init_params(0)
    rng = np.random.default_rng(1)
    toks = torch.tensor(rng.integers(0, cfg.vocab_size, (2, 97)), dtype=torch.int32)
    out = {}
    for dev in ("cpu", cuda):
        live = _to(params, dev)
        flat = tree_leaves(live)
        for t in flat:
            t.requires_grad_(True)
        batch = {"tokens": toks[:, :-1].to(dev), "labels": toks[:, 1:].to(dev)}
        before = rmsnorm.launches, flash_attention.launches
        total, _ = make_loss_fn(cfg)(live, batch)
        grads = torch.autograd.grad(total, flat)
        moved = (rmsnorm.launches - before[0], flash_attention.launches - before[1])
        out[str(dev)] = (float(total), [g.cpu() for g in grads], moved)
    (loss_c, grads_c, moved_c), (loss_g, grads_g, moved_g) = out["cpu"], out["cuda"]
    assert moved_c == (0, 0)
    assert moved_g == (2 * cfg.n_layers + 1 + norms_recomputed(cfg), 0)
    assert loss_g == pytest.approx(loss_c, rel=1e-5)
    for gc, gg in zip(grads_c, grads_g, strict=True):
        scale = float(gc.abs().max())
        assert float(gg.abs().max()) > 0  # every leaf reached on the card
        assert float((gg - gc).abs().max()) <= 1e-4 * scale


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.detach().to(dev)


@pytest.mark.cuda
def test_flash_attention_refuses_a_gradient_on_card(cuda):
    q = torch.randn(1, 64, 2, 64, device=cuda, dtype=torch.bfloat16)
    k = torch.randn(1, 64, 1, 64, device=cuda, dtype=torch.bfloat16)
    before = flash_attention.launches
    with pytest.raises(RuntimeError, match="no backward"):
        flash_attention(q.clone().requires_grad_(), k, k)
    assert flash_attention.launches == before
    with torch.no_grad():
        assert flash_attention(q.clone().requires_grad_(), k, k).shape == q.shape
    assert flash_attention.launches == before + 1


@pytest.mark.cuda
def test_jamba_forward_card_matches_cpu(cuda):
    cfg = get_config("jamba-1.5-large-398b-smoke")
    params = Model(cfg, "cpu").init_params(0)
    rng = np.random.default_rng(2)
    b, s, steps = 2, 48, 4
    toks = rng.integers(0, cfg.vocab_size, (b, s + steps))
    toks = torch.tensor(toks, dtype=torch.int32)
    pos = torch.arange(s, dtype=torch.int32).expand(b, s)
    norms = len(cfg.layer_pattern) * 2 + 1  # every jamba block has an FFN
    out = {}
    for dev in ("cpu", cuda):
        model, live = Model(cfg, dev), _to(params, dev)
        t = toks.to(dev)
        before = rmsnorm.launches, flash_attention.launches
        with torch.no_grad():
            hidden = forward(cfg, live, t[:, :s], pos.to(dev), mode="train")[0]
            moved = (rmsnorm.launches - before[0], flash_attention.launches - before[1])
            logits = [logits_fn(cfg, live, hidden)]
            last, pre = model.prefill_step(live, {"tokens": t[:, :s]})
            caches = serve.load_prefill(model.init_caches(b, s + steps), pre)
            logits.append(last[:, None])
            for i in range(steps):
                step = {
                    "tokens": t[:, s + i : s + i + 1],
                    "pos": torch.full((b,), s + i, dtype=torch.int32, device=dev),
                }
                lg, caches = model.serve_step(live, caches, step)
                logits.append(lg[:, None])
        out[str(dev)] = (torch.cat(logits, 1).float().cpu(), moved)
    (cpu, moved_c), (card, moved_g) = out["cpu"], out["cuda"]
    assert moved_c == (0, 0) and moved_g == (norms, 1)
    assert bool(torch.isfinite(card).all())
    assert float((card - cpu).abs().max()) <= 1e-4



@pytest.mark.cuda
def test_flash_attention_scalar_route_quickstart_shape_on_card(cuda):
    """The quickstart's float32 ``[1, 128, 4|2, 32]`` call: one launch, on
    the scalar route, within 2e-5 of the plain version."""
    from repro_torch.kernels.flash_attention import attention_plain

    rng = np.random.default_rng(0)
    q, k, v = (
        torch.tensor(rng.standard_normal((1, 128, h, 32)), device=cuda).float()
        for h in (4, 2, 2)
    )
    before = dict(flash_attention.launches_by_route)
    out = flash_attention(q, k, v)
    moved = {r: n - before[r] for r, n in flash_attention.launches_by_route.items()}
    assert moved == {"scalar": 1, "wgmma": 0}
    assert float((out - attention_plain(q, k, v)).abs().max()) <= 2e-5


@pytest.mark.cuda
def test_xlstm_125m_train_step_on_card(cuda):
    """xlstm-125m at full width and depth on the card (bf16 params, f32
    moments), batch 2, seq 64: every leaf's loss gradient non-zero, then
    one train step: a finite loss, a non-zero gradient norm, C 13
    launches a forward (a norm a mixer and the final one), D none."""
    from repro_torch.launch.specs import opt_cfg_for
    from repro_torch.models.model import value_and_grad

    cfg = get_config("xlstm-125m")
    model = Model(cfg, cuda, opt_cfg=opt_cfg_for(cfg))
    state = model.init_train_state(0)
    rng = np.random.default_rng(0)
    toks = torch.tensor(rng.integers(0, cfg.vocab_size, (2, 65)), device=cuda)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    _, _, grads = value_and_grad(model.loss_fn, state["params"], batch)
    assert all(bool((g != 0).any()) for g in tree_leaves(grads))
    before = rmsnorm.launches, flash_attention.launches
    state, metrics = model.train_step(state, batch)
    torch.cuda.synchronize()
    moved = (rmsnorm.launches - before[0], flash_attention.launches - before[1])
    assert moved == (len(cfg.layer_pattern) + 1 + norms_recomputed(cfg), 0)
    assert np.isfinite(float(metrics["loss"])) and float(metrics["grad_norm"]) > 0


@pytest.mark.cuda
def test_remat_loss_and_grads_match_plain_on_card(cuda):
    """chip_smoke's ``lm_train_remat`` (a) at h2o-danube-3-4b-smoke's widths
    in bf16: the loss and every gradient leaf from the same params and
    batch with ``ShardingPolicy()`` against ``ShardingPolicy(remat=False)``,
    loss 1e-5 relative and gradients 1e-4 of each leaf's scale; C a
    forward's norms without remat and those and the recompute's with it,
    D never."""
    from repro_torch.models.model import value_and_grad

    cfg = dataclasses.replace(get_config("h2o-danube-3-4b-smoke"), dtype="bfloat16")
    params = Model(cfg, cuda).init_params(0)
    rng = np.random.default_rng(4)
    toks = torch.tensor(rng.integers(0, cfg.vocab_size, (2, 129)), device=cuda)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    out = []
    for policy in (ShardingPolicy(remat=False), ShardingPolicy()):
        before = rmsnorm.launches, flash_attention.launches
        _, m, grads = value_and_grad(make_loss_fn(cfg, policy=policy), params, batch)
        torch.cuda.synchronize()
        moved = (rmsnorm.launches - before[0], flash_attention.launches - before[1])
        out.append((float(m["loss"]), tree_leaves(grads), moved))
    (loss0, g0, moved0), (loss1, g1, moved1) = out
    forward_norms = 2 * cfg.n_layers + 1
    assert moved0 == (forward_norms, 0)
    assert moved1 == (forward_norms + norms_recomputed(cfg), 0)
    assert loss1 == pytest.approx(loss0, rel=1e-5)
    for a, b in zip(g1, g0, strict=True):
        scale = max(float(b.float().abs().max()), 1e-30)
        assert float((a.float() - b.float()).abs().max()) <= 1e-4 * scale


@pytest.mark.cuda
def test_moe_sharded_body_on_a_one_rank_mesh_on_card(cuda):
    """chip_smoke's ``moe_ep`` (b) at qwen3-moe-smoke's widths (float32):
    the per-shard body forced past ``moe_apply``'s routing on a one-rank
    NCCL mesh, against the local path on the same inputs."""
    from repro_torch.launch.mesh import one_rank_device_mesh
    from repro_torch.models import moe

    cfg = get_config("qwen3-moe-235b-a22b-smoke")
    gen = torch.Generator(device=cuda).manual_seed(0)
    p = moe.moe_init(cfg, gen)
    with one_rank_device_mesh("cuda") as mesh:
        groups = dict(model=mesh.get_group("model"), data=mesh.get_group("data"))
        for mode, t in (("train", 96), ("decode", 4)):
            x = torch.randn(t, cfg.d_model, generator=gen, device=cuda)
            live = [
                w.detach().clone().requires_grad_(True)
                for w in (x, *(p[k] for k in moe.EXPERTS))
            ]
            outs = []
            for kw in ({}, dict(seq_sharded=mode == "train", **groups)):
                kw.setdefault("seq_sharded", False)
                y, aux = moe.moe_local(cfg, live[0], p["router"], *live[1:], **kw)
                grads = torch.autograd.grad((y * y).sum() + aux, live)
                outs.append((y.detach(), aux.detach(), grads))
            (y0, a0, g0), (y1, a1, g1) = outs
            assert torch.equal(y1, y0) and torch.equal(a1, a0), mode
            for a, b in zip(g1, g0, strict=True):
                scale = float(b.abs().max())
                assert float((a - b).abs().max()) <= 1e-6 * max(scale, 1.0), mode


@pytest.mark.cuda
def test_zoo_sharded_train_step_on_a_one_rank_mesh_on_card(cuda):
    """chip_smoke's ``lm_train_mesh`` at danube-smoke's widths: the forced
    sharded train step and prefill on a one-rank NCCL mesh against the
    mesh-less model (the collectives are counted: they were issued)."""
    from repro_torch.launch.mesh import one_rank_device_mesh
    from repro_torch.models import spmd
    from repro_torch.optim.adamw import tree_leaves

    cfg = get_config("h2o-danube-3-4b-smoke")
    rng = np.random.default_rng(0)
    toks = torch.tensor(rng.integers(0, cfg.vocab_size, (4, 65)), device=cuda)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def run(mesh):
        model = Model(cfg, cuda, mesh=mesh)
        state = model.init_train_state(0)
        lines = []
        for _ in range(2):
            state, m = model.train_step(state, batch)
            lines.append((float(m["loss"]), float(m["grad_norm"])))
        with torch.no_grad():
            last = model.prefill_step(state["params"], {"tokens": batch["tokens"]})[0]
        return lines, [t.detach().clone() for t in tree_leaves(state["params"])], last

    gathers = []
    real = spmd.all_gather

    def counted(*a, **kw):
        gathers.append(1)
        return real(*a, **kw)

    torch.cuda.set_device(cuda.index or 0)
    with one_rank_device_mesh("cuda") as mesh:
        spmd.all_gather = counted
        try:
            got = run(mesh)
        finally:
            spmd.all_gather = real
    want = run(None)
    assert gathers
    for (gl, gg), (wl, wg) in zip(got[0], want[0], strict=True):
        assert gl == pytest.approx(wl, rel=1e-5) and gg == pytest.approx(wg, rel=1e-5)
    for a, b in zip(got[1], want[1], strict=True):
        assert float((a - b).abs().max()) <= 1e-4 * max(float(b.abs().max()), 1e-30)
    assert float((got[2] - want[2]).abs().max()) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize(
    "arch", ["deepseek-v2-lite-16b-smoke", "jamba-1.5-large-398b-smoke",
             "xlstm-125m-smoke"],
)  # fmt: skip
def test_mixers_sharded_on_a_one_rank_mesh_on_card(cuda, arch):
    """chip_smoke's ``lm_mixers_mesh`` at smoke widths: MLA, Mamba, mLSTM
    and sLSTM in their tensor-parallel regions on a one-rank NCCL mesh
    (MLA's latent cache a sequence block read by the split-K combine)
    against the mesh-less model: 2 train steps, a prefill and 2 decode
    steps."""
    from repro_torch.launch.mesh import one_rank_device_mesh

    cfg = get_config(arch)
    rng = np.random.default_rng(0)
    toks = torch.tensor(rng.integers(0, cfg.vocab_size, (4, 35)), device=cuda)
    batch = {"tokens": toks[:, :-3], "labels": toks[:, 1:-2]}

    def run(mesh):
        model = Model(cfg, cuda, mesh=mesh)
        state = model.init_train_state(0)
        lines = []
        for _ in range(2):
            state, m = model.train_step(state, batch)
            lines.append((float(m["loss"]), float(m["grad_norm"])))
        params = state["params"]
        with torch.no_grad():
            last, pre = model.prefill_step(params, {"tokens": batch["tokens"]})
            caches = model.load_prefill(model.init_caches(4, 34), pre)
            logits = [last]
            for i in range(2):
                step = {"tokens": toks[:, 32 + i : 33 + i],
                        "pos": torch.full((4,), 32 + i, dtype=torch.int32, device=cuda)}
                lg, caches = model.serve_step(params, caches, step)  # fmt: skip
                logits.append(lg)
        return lines, [t.detach().clone() for t in tree_leaves(params)], logits

    torch.cuda.set_device(cuda.index or 0)
    with one_rank_device_mesh("cuda") as mesh:
        got = run(mesh)
    want = run(None)
    for (gl, gg), (wl, wg) in zip(got[0], want[0], strict=True):
        assert gl == pytest.approx(wl, rel=1e-5) and gg == pytest.approx(wg, rel=1e-5)
    for a, b in zip(got[1], want[1], strict=True):
        assert float((a - b).abs().max()) <= 1e-4 * max(float(b.abs().max()), 1e-30)
    for a, b in zip(got[2], want[2], strict=True):
        assert float((a - b).abs().max()) <= 1e-4


@pytest.mark.cuda
def test_wall_span_holds_its_kernel_on_the_profiler_timeline_on_card(cuda):
    tel = Telemetry()
    a = torch.randn(4096, 4096, device=cuda)
    b = a @ a  # cuBLAS's first call (its set-up) before the profile
    torch.cuda.synchronize(cuda)
    act = torch.profiler.ProfilerActivity
    with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as prof:
        with tel.wall_span("matmul", "test") as span:
            for _ in range(4):
                b = a @ b
            torch.cuda.synchronize(cuda)
    start_ns = prof.profiler.kineto_results.trace_start_ns()
    kernels = [
        e
        for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA
        and not getattr(e, "is_user_annotation", False)
    ]
    assert len(kernels) >= 4
    lo = tel.tracer.to_profiler_us(span["t0"], start_ns)
    hi = tel.tracer.to_profiler_us(span["t1"], start_ns)
    first = min(e.time_range.start for e in kernels)
    last = max(e.time_range.end for e in kernels)
    assert lo - 50.0 <= first and last <= hi + 50.0, (lo, first, last, hi)
    # and no clock offset hides inside the span: the closing
    # synchronisation returns just after the last kernel ends (30-60 us on
    # an H100; the first kernel trails the span's start by the profiler's
    # set-up of its first launch, milliseconds, so that end says nothing)
    assert hi - last <= 1000.0, (lo, first, last, hi)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "dtype, o_rtol", [(torch.bfloat16, 2**-7), (torch.float32, 1e-5)]
)
def test_kda_step_matches_plain_on_card(cuda, dtype, o_rtol):
    """The fused KDA decode step at Kimi-Linear's decode shape (B 128, H
    32, d 128), three steps in a row from one state: one launch a step,
    the float32 state within 1e-5 of the plain version's largest magnitude
    (float32 both sides, sums in another order) and ``o`` within
    ``o_rtol`` of its largest (bf16: the output's rounding, one part in
    2**8, twice; float32 as the state)."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    b, h, d = 128, 32, 128
    state = torch.randn(b, h, d, d, generator=gen, device=cuda) * 0.1
    mine, plain = state.clone(), state.clone()
    for _ in range(3):
        qkv = torch.randn(b, 3, h, d, generator=gen, device=cuda).to(dtype)
        g = -torch.exp(torch.randn(b, h, d, generator=gen, device=cuda))
        beta = torch.rand(b, h, generator=gen, device=cuda)
        before = kda_step.launches
        o = kda_step(mine, qkv, g, beta, d**-0.5)
        assert kda_step.launches == before + 1
        want = kda_step_plain(plain, qkv, g, beta, d**-0.5)
        assert o.dtype == dtype and o.shape == (b, h, d)
        err = float((o.float() - want.float()).abs().max())
        assert err <= o_rtol * float(want.float().abs().max()), err
        err = float((mine - plain).abs().max())
        assert err <= 1e-5 * float(plain.abs().max()), err


# -- kernel F: KDA's chunked prefill --------------------------------------------
def _kda_chunk_draw(b, s, h, d, device, seed):
    """qkv, the CPU test's steep decays (``-exp(2 randn)`` up to 60: a
    chunk's cumulative decay reaches hundreds, whose negation overflows
    ``exp``) and beta."""
    gen = torch.Generator(device=device).manual_seed(seed)
    qkv = torch.randn(b, s, 3, h, d, generator=gen, device=device)
    g = -torch.exp(2 * torch.randn(b, s, h, d, generator=gen, device=device))
    beta = torch.rand(b, s, h, generator=gen, device=device)
    return qkv, g.clamp(min=-60.0), beta


@pytest.mark.cuda
@pytest.mark.parametrize(
    "dtype, o_rtol", [(torch.float32, 1e-4), (torch.bfloat16, 2**-7)]
)
@pytest.mark.parametrize("bhd", [(2, 32, 128), (3, 2, 32), (2, 5, 72)])
@pytest.mark.parametrize("s", [1, 63, 64, 65, 200, 1024])
def test_kda_chunk_matches_plain_on_card(cuda, s, bhd, dtype, o_rtol):
    """F against its plain version (the L2 norms and ``chunk_kda``) at
    Kimi-Linear's heads (32 x 128), the smoke config's (2 x 32) and a ragged
    width (5 x 72: fewer columns than the tiles), lengths from one token to
    sixteen chunks, a partial chunk among them: one launch a call, the
    float32 state within 1e-4 of the plain state's largest magnitude and
    float32 ``o`` within 1e-4 of its largest (float32 both sides: the
    substitution, the halving's sums and the state's products in another
    order), bf16 ``o`` within 2**-7 (each side rounds once to bf16, one part
    in 2**8, so the two may differ by that twice)."""
    b, h, d = bhd
    qkv, g, beta = _kda_chunk_draw(b, s, h, d, cuda, seed=s + d)
    before = kda_chunk.launches
    o, state = kda_chunk(qkv, g, beta, d**-0.5, 64, dtype)
    assert kda_chunk.launches == before + 1
    want, want_state = kda_chunk_plain(qkv, g, beta, d**-0.5, 64, dtype)
    assert o.dtype == dtype and o.shape == (b, s, h, d)
    assert state.dtype == torch.float32 and state.shape == (b, h, d, d)
    assert bool(torch.isfinite(o.float()).all() and torch.isfinite(state).all())
    err = float((state - want_state).abs().max())
    assert err <= 1e-4 * float(want_state.abs().max()), err
    err = float((o.float() - want.float()).abs().max())
    assert err <= o_rtol * float(want.float().abs().max()), err


@pytest.mark.cuda
def test_kda_chunk_routes_by_autograd_on_card(cuda):
    """On the card F runs unless autograd would record the call: an input
    that requires a gradient under ``torch.is_grad_enabled()`` takes the
    plain form (``calls_by_route["plain"]``, no launch) and its gradient
    flows; the same input under ``no_grad``, or a detached one with the
    gradient on, launches F (``calls_by_route["kernel"]``), within 1e-4 of
    the plain output's largest."""
    qkv, g, beta = _kda_chunk_draw(2, 70, 2, 32, cuda, seed=3)
    qkv.requires_grad_()
    routes = kda_chunk.calls_by_route

    def moved(fn):
        before = dict(routes), kda_chunk.launches
        out = fn()
        after = {r: n - before[0][r] for r, n in routes.items()}
        return out, after, kda_chunk.launches - before[1]

    def call(x):
        return lambda: kda_chunk(x, g, beta, 32**-0.5, 64, torch.float32)

    (want, _), by, n = moved(call(qkv))
    assert by == {"kernel": 0, "plain": 1} and n == 0 and want.requires_grad
    want.square().sum().backward()
    assert bool(torch.isfinite(qkv.grad).all()) and bool((qkv.grad != 0).any())
    with torch.no_grad():
        (got, _), by, n = moved(call(qkv))
    assert by == {"kernel": 1, "plain": 0} and n == 1
    (again, _), by, n = moved(call(qkv.detach()))
    assert by == {"kernel": 1, "plain": 0} and n == 1
    for o in (got, again):
        err = float((o - want.detach()).abs().max())
        assert err <= 1e-4 * float(want.detach().abs().max()), err


@pytest.mark.cuda
def test_kimi_prefill_through_kda_chunk_card_matches_cpu(cuda):
    """Kimi-Linear's smoke model (float32; capacity factor 16, so no pair is
    dropped) from one init: a 70-token prefill (F once a KDA layer on the
    card, the plain form on the CPU), then 4 teacher-forced decode steps
    through the loaded caches; the prefill's and every step's logits on the
    card within 1e-4 of the CPU's largest (float32 both sides)."""
    cfg = get_config("kimi-linear-48b-a3b-ep4-smoke")
    moe_cfg = dataclasses.replace(cfg.moe, capacity_factor=16.0)
    cfg = dataclasses.replace(cfg, moe=moe_cfg)
    params = Model(cfg, "cpu").init_params(0)
    n_kda = sum(m == KDA for m, _ in cfg.layer_pattern)
    rng = np.random.default_rng(4)
    b, s, steps = 2, 70, 4
    toks = rng.integers(0, cfg.vocab_size, (b, s + steps))
    toks = torch.tensor(toks, dtype=torch.int32)
    out = {}
    for dev in ("cpu", cuda):
        model, live = Model(cfg, dev), _to(params, dev)
        t = toks.to(dev)
        before = kda_chunk.launches
        with torch.no_grad():
            last, pre = model.prefill_step(live, {"tokens": t[:, :s]})
            launched = kda_chunk.launches - before
            caches = serve.load_prefill(model.init_caches(b, s + steps), pre)
            logits = [last[:, None]]
            for i in range(steps):
                step = {
                    "tokens": t[:, s + i : s + i + 1],
                    "pos": torch.full((b,), s + i, dtype=torch.int32, device=dev),
                }
                lg, caches = model.serve_step(live, caches, step)
                logits.append(lg[:, None])
        out[str(dev)] = (torch.cat(logits, 1).float().cpu(), launched)
    (cpu, n_cpu), (card, n_card) = out["cpu"], out["cuda"]
    assert n_cpu == 0 and n_card == n_kda == 3
    assert bool(torch.isfinite(card).all())
    assert float((card - cpu).abs().max()) <= 1e-4 * float(cpu.abs().max())


# -- kernel G: an mHC site ------------------------------------------------------
MHC_KW = dict(norm_eps=1e-6)


def _mhc_draw(t, c, dtype, device, seed):
    """A stream of 4 rows, a site's parameters drawn away from their init
    (alpha, b and the norm's scale), and a sublayer's output."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=device)

    x = randn(t, 4, c).to(dtype)
    p = ((4 * c) ** -0.5 * randn(4 * c, 24), 1 + 0.3 * randn(3), 0.5 * randn(24),
         1 + 0.3 * randn(4 * c))  # fmt: skip
    return x, p, randn(t, c).to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "dtype, rtol", [(torch.bfloat16, 2**-7), (torch.float32, 1e-5)]
)
@pytest.mark.parametrize("t,c", [(128, 3584), (4096, 3584), (16384, 3584), (3, 256),
                                 (37, 256)])  # fmt: skip
def test_mhc_matches_plain_on_card(cuda, t, c, dtype, rtol):
    """G against the plain forms at Xing4.0's decode shape (128 rows: the
    columns sliced over 14 CTAs a row block), a prefill slice of one
    slice a row block and one of 32 rows a CTA, and the smoke width:
    two launches; H_post and H_res within 1e-5 (float32 both sides, the
    projection's 14,336-term sums and the Sinkhorn's in another order);
    ``u`` and the new stream within ``rtol`` of their largest (bf16: each
    side rounds once, one part in 2**8, twice; float32 as the
    coefficients), the new stream from the kernel's own coefficients."""
    x, p, y = _mhc_draw(t, c, dtype, cuda, seed=t + c)
    before = mhc.launches
    u, h_post, h_res = mhc.pre(x, *p, **MHC_KW)
    out = mhc.post(x, y, h_post, h_res)
    assert mhc.launches == before + 2
    want_u, want_post, want_res = mhc_pre_plain(x, *p, **MHC_KW)
    want_out = mhc_post_plain(x, y, h_post, h_res)
    assert u.dtype == out.dtype == dtype and h_res.shape == (t, 4, 4)
    for got, want in ((h_post, want_post), (h_res, want_res)):
        assert float((got - want).abs().max()) <= 1e-5
    for got, want in ((u, want_u), (out, want_out)):
        err = float((got.float() - want.float()).abs().max())
        assert err <= rtol * float(want.float().abs().max()), err


@pytest.mark.cuda
def test_mhc_routes_by_autograd_on_card(cuda):
    """On the card G runs unless autograd would record the call, and then
    each of its two wrappers raises (G has no backward; the plain forms
    stay on the CPU), with nothing counted or launched; under ``no_grad``
    the same stream launches (``calls_by_route["kernel"]``, two launches
    a site) and matches the plain forms."""
    x, p, y = _mhc_draw(8, 256, torch.float32, cuda, seed=2)
    x.requires_grad_()
    routes = mhc.calls_by_route

    def site():
        before = dict(routes), mhc.launches
        u, h_post, h_res = mhc.pre(x, *p, **MHC_KW)
        out = mhc.post(x, y + u, h_post, h_res)
        return out, {r: n - before[0][r] for r, n in routes.items()}, mhc.launches - before[1]

    before = dict(routes), mhc.launches
    with pytest.raises(NotImplementedError, match="no backward"):
        site()
    with torch.no_grad():
        u, h_post, h_res = mhc.pre(x, *p, **MHC_KW)
    with pytest.raises(NotImplementedError, match="no backward"):
        mhc.post(x, y + u, h_post, h_res)
    assert routes == {**before[0], "kernel": before[0]["kernel"] + 1}
    assert mhc.launches == before[1] + 1
    with torch.no_grad():
        got, by, n = site()
    assert by == {"kernel": 1, "plain": 0} and n == 2
    want_u, want_post, want_res = mhc_pre_plain(x.detach(), *p, **MHC_KW)
    want = mhc_post_plain(x.detach(), y + want_u, want_post, want_res)
    err = float((got - want).abs().max())
    assert err <= 1e-5 * float(want.abs().max()), err


@pytest.mark.cuda
def test_mhc_site_replays_count_their_launches_on_card(cuda):
    """A site (128 rows, sliced: its counters made by the eager warm-up)
    captured into a CUDA graph: each replay equals the eager site bit for
    bit and advances G's counter by its two launches."""
    x, p, y = _mhc_draw(128, 3584, torch.bfloat16, cuda, seed=5)

    def site():
        u, h_post, h_res = mhc.pre(x, *p, **MHC_KW)
        return mhc.post(x, y + u, h_post, h_res)

    want = graphs.warm_up(site, cuda)
    graph = graphs.capture(site, cuda, torch.cuda.graph_pool_handle())
    for _ in range(2):
        before = mhc.launches
        got = graphs.replay(graph)
        torch.cuda.synchronize()
        assert mhc.launches == before + 2
        assert torch.equal(got, want)


@pytest.mark.cuda
def test_xing_prefill_through_mhc_card_matches_cpu(cuda):
    """Xing4.0's smoke model (float32; capacity factor 16, so no pair is
    dropped) from one init: a 70-token prefill (G at every site on the
    card, two launches each, the plain forms on the CPU), then 4
    teacher-forced decode steps through the loaded caches; the prefill's
    and every step's logits on the card within 1e-4 of the CPU's largest
    (float32 both sides)."""
    cfg = get_config("xing4.0-29b-a4b-ep4-smoke")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=16.0))
    params = Model(cfg, "cpu").init_params(0)
    sites = 2 * cfg.n_layers
    rng = np.random.default_rng(4)
    b, s, steps = 2, 70, 4
    toks = torch.tensor(rng.integers(0, cfg.vocab_size, (b, s + steps)), dtype=torch.int32)
    out = {}
    for dev in ("cpu", cuda):
        model, live = Model(cfg, dev), _to(params, dev)
        t = toks.to(dev)
        before = mhc.launches, mhc.calls_by_route["kernel"]
        with torch.no_grad():
            last, pre = model.prefill_step(live, {"tokens": t[:, :s]})
            launched = (mhc.launches - before[0], mhc.calls_by_route["kernel"] - before[1])
            caches = serve.load_prefill(model.init_caches(b, s + steps), pre)
            logits = [last[:, None]]
            for i in range(steps):
                step = {
                    "tokens": t[:, s + i : s + i + 1],
                    "pos": torch.full((b,), s + i, dtype=torch.int32, device=dev),
                }
                lg, caches = model.serve_step(live, caches, step)
                logits.append(lg[:, None])
        out[str(dev)] = (torch.cat(logits, 1).float().cpu(), launched)
    (cpu, n_cpu), (card, n_card) = out["cpu"], out["cuda"]
    assert n_cpu == (0, 0) and n_card == (2 * sites, sites)
    assert bool(torch.isfinite(card).all())
    assert float((card - cpu).abs().max()) <= 1e-4 * float(cpu.abs().max())


# -- the zoo's decode graphs ----------------------------------------------------
# every zoo architecture's smoke config (dense GQA, a sliding window, M-RoPE
# and embeds in, MoE, MLA, Mamba, mLSTM/sLSTM, KDA), and the two decode
# cells' models in bf16 (kernels C and E on their bf16 routes)
GRAPH_ARCHS = [f"{name}-smoke" for name in (
    "h2o-danube-3-4b", "qwen2.5-14b", "starcoder2-15b", "qwen2-vl-2b",
    "musicgen-medium", "qwen3-moe-235b-a22b", "moonshot-v1-16b-a3b",
    "deepseek-v2-lite-16b", "jamba-1.5-large-398b", "xlstm-125m",
    "kimi-linear-48b-a3b-ep4", "xing4.0-29b-a4b-ep4",
)] + ["deepseek-v2-lite-16b-smoke:bf16", "kimi-linear-48b-a3b-ep4-smoke:bf16",
      "xing4.0-29b-a4b-ep4-smoke:bf16"]  # fmt: skip


def _graph_model(arch: str, dev):
    name, _, dtype = arch.partition(":")
    cfg = get_config(name)
    if dtype:
        cfg = dataclasses.replace(cfg, dtype="bfloat16")
    model = Model(cfg, dev)
    return model, model.init_params(0)


def _graph_prompt(cfg, b: int, s: int, seed: int, dev) -> torch.Tensor:
    if cfg.input_kind == "embeds":
        return torch.tensor(serve.prompt_embeds(cfg.d_model, b, s, seed), device=dev)
    tok = serve.prompt_tokens(cfg.vocab_size, b, s, seed)
    return torch.tensor(tok, dtype=torch.int32, device=dev)


def _eager_generate(model, params, prompt, gen: int):
    """``serve.generate``'s loop, eager, on fresh caches of the graph
    path's (bucketed) length: (tokens [B, gen + 1], logits [gen, B, V])."""
    b, s = prompt.shape[:2]
    dev = model.device
    key = "embeds" if model.cfg.input_kind == "embeds" else "tokens"
    zeros = torch.zeros((b, 1, model.cfg.d_model), device=dev)
    last, pre = model.prefill_step(params, {key: prompt})
    caches = serve.load_prefill(model.init_caches(b, graph_cache_len(s + gen)), pre)
    tok = last.argmax(-1).to(torch.int32)[:, None]
    tokens, logits = [tok], []
    for i in range(gen):
        pos = torch.full((b,), s + i, dtype=torch.int32, device=dev)
        step = {key: zeros if key == "embeds" else tok, "pos": pos}
        lg, caches = model.serve_step(params, caches, step)
        tok = lg.argmax(-1).to(torch.int32)[:, None]
        tokens.append(tok)
        logits.append(lg.float().clone())
    return torch.cat(tokens, 1), torch.stack(logits)


def _routes() -> dict[str, int]:
    return dict(make_serve_step.steps_by_route)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", GRAPH_ARCHS)
def test_decode_graphs_match_eager_on_card(cuda, arch):
    """``generate`` on the graph path against the eager loop on fresh
    caches of the same bucketed length, bit for bit (tokens and logits):
    the first step captures, the rest replay, and a second generation of
    the shape replays every step."""
    model, params = _graph_model(arch, cuda)
    prompt = _graph_prompt(model.cfg, 3, 37, 1, cuda)
    want = _eager_generate(model, params, prompt, 6)
    for captures in (1, 0):
        before = _routes()
        out = serve.generate(model, params, prompt, 6)
        after = _routes()
        assert after["capture"] - before["capture"] == captures
        assert after["replay"] - before["replay"] == 6 - captures
        assert after["eager"] == before["eager"]
        assert torch.equal(out.tokens, want[0])
        assert torch.equal(out.logits, want[1])
    assert list(model.arena.graphs) == [(3, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize(
    "arch", ["deepseek-v2-lite-16b-smoke", "kimi-linear-48b-a3b-ep4-smoke"]
)
def test_decode_graph_forgets_a_longer_prompt_on_card(cuda, arch):
    """A longer prompt, then a shorter one in the same 64-slot bucket, on
    one model: the second generation equals a fresh eager run (the slots
    the first prompt filled past the second's hold ``kpos`` -1 again, so
    they are not attended to)."""
    model, params = _graph_model(arch, cuda)
    serve.generate(model, params, _graph_prompt(model.cfg, 2, 50, 2, cuda), 5)
    short = _graph_prompt(model.cfg, 2, 21, 3, cuda)
    out = serve.generate(model, params, short, 5)
    assert list(model.arena.graphs) == [(2, 64)]
    want = _eager_generate(model, params, short, 5)
    assert torch.equal(out.tokens, want[0])
    assert torch.equal(out.logits, want[1])


@pytest.mark.cuda
def test_decode_graphs_alternate_on_a_shared_state_on_card(cuda):
    """Two shapes of one batch (buckets 64 and 128) alternating A, B, A on
    Kimi-Linear's smoke config: the KDA state and convolution tail are one
    tensor for both entries, and each generation equals the eager run."""
    model, params = _graph_model("kimi-linear-48b-a3b-ep4-smoke", cuda)
    for s, seed in ((30, 4), (90, 5), (30, 6)):
        prompt = _graph_prompt(model.cfg, 2, s, seed, cuda)
        out = serve.generate(model, params, prompt, 4)
        want = _eager_generate(model, params, prompt, 4)
        assert torch.equal(out.tokens, want[0])
        assert torch.equal(out.logits, want[1])
    a, b = (model.arena.graphs[k].caches for k in ((2, 64), (2, 128)))
    assert a["groups"]["b0"]["state"] is b["groups"]["b0"]["state"]
    assert a["groups"]["b1"]["ckv"] is not b["groups"]["b1"]["ckv"]


@pytest.mark.cuda
def test_decode_graph_replays_count_their_launches_on_card(cuda):
    """The zoo kernels' launch counters advance per replay as they do per
    eager step: C and E (and D, none at decode) over a generation on the
    graph path equal the eager loop's, route by route."""
    model, params = _graph_model("kimi-linear-48b-a3b-ep4-smoke:bf16", cuda)
    prompt = _graph_prompt(model.cfg, 2, 40, 7, cuda)
    counted = []
    for run in (lambda: _eager_generate(model, params, prompt, 5),
                lambda: serve.generate(model, params, prompt, 5),
                lambda: serve.generate(model, params, prompt, 5)):  # fmt: skip
        before = (rmsnorm.launches, dict(rmsnorm.launches_by_route),
                  kda_step.launches, flash_attention.launches)  # fmt: skip
        run()
        torch.cuda.synchronize()
        counted.append((
            rmsnorm.launches - before[0],
            {r: n - before[1][r] for r, n in rmsnorm.launches_by_route.items()},
            kda_step.launches - before[2],
            flash_attention.launches - before[3],
        ))  # fmt: skip
    assert counted[0][2] == 5 * 3  # E: one a KDA layer (of 3) a decode step
    assert counted[1] == counted[0] and counted[2] == counted[0]


@pytest.mark.cuda
def test_decode_arena_is_freed_with_its_model_on_card(cuda):
    """The arena's caches, graphs and graph pool go with the model: the
    allocated bytes return to the level before it was built.  (A first
    model warms the process's capture stream, whose cuBLAS workspace
    outlives every model.)"""
    model, params = _graph_model("kimi-linear-48b-a3b-ep4-smoke", cuda)
    serve.generate(model, params, _graph_prompt(model.cfg, 2, 30, 8, cuda), 3)
    del model, params
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(cuda)
    model, params = _graph_model("kimi-linear-48b-a3b-ep4-smoke", cuda)
    for s in (30, 90):
        out = serve.generate(model, params, _graph_prompt(model.cfg, 2, s, 8, cuda), 3)
    assert len(model.arena.graphs) == 2
    del model, params, out
    gc.collect()
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated(cuda) == base
