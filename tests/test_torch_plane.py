"""The port's weight planes against the reference's.

Plane level, bitwise, from the same numpy trees: ``encode`` gives the
same modes, top-k coordinates, int8 codes, scales, payload bytes and
reconstructions (int8 keyframes, then top-k deltas with error feedback,
and a keyframe again after ``forget_agent``); ``mix_params`` gives the
same float32 bits for plain and compressed snapshots (the reference's
``(1 - a) * p + a * q``, stalest first); ``staleness_alphas`` the same
rates for every flag and clock; ``WeightPlane`` admits, refuses and
evicts the same snapshots.  An uncompressed snapshot is priced at
``32 + 4 * numel`` bytes without a host copy.

System level (registry widths, ``--fast``, from the reference's init):
``plane_weight_only`` and ``plane_hybrid`` keep the reference's round
records, wire counts and pushes exactly, losses within 1e-4 and params
within 1e-5 (``test_torch_gossip.run_both``).  A weight snapshot stays
what it was when taken after the agent trains on.
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
from repro.core import plane as jax_plane  # noqa: E402
from repro_torch.configs.adfll_dqn import DQNConfig  # noqa: E402
from repro_torch.core import plane  # noqa: E402
from repro_torch.core.erb import erb_init  # noqa: E402
from repro_torch.core.federated import env_for  # noqa: E402
from repro_torch.optim.adamw import leaves  # noqa: E402
from repro_torch.rl.agent import DQNAgent  # noqa: E402
from repro_torch.rl.synth import paper_eight_tasks, patient_split  # noqa: E402
from test_torch_baselines import DQN_KW  # noqa: E402
from test_torch_gossip import (  # noqa: E402
    assert_params_match,
    assert_records_match,
    run_both,
)

SHAPES = {
    "conv0": {"b": (4,), "w": (4, 1, 3, 3, 3)},
    "fc0": {"b": (32,), "w": (124, 32)},
    "fc1": {"b": (6,), "w": (32, 6)},
    "loc": {"b": (16,), "w": (3, 16)},
}


def _np_tree(rng, scale=1.0, zero_bias=False):
    out = {}
    for k, v in SHAPES.items():
        out[k] = {}
        for n, shape in v.items():
            x = (scale * rng.standard_normal(shape)).astype(np.float32)
            out[k][n] = np.zeros(shape, np.float32) if zero_bias and n == "b" else x
    return out


def _torch_tree(tree):
    return {
        k: {n: torch.from_numpy(a.copy()) for n, a in v.items()}
        for k, v in tree.items()
    }


def _ref_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _same_tree(ours, ref):
    got, want = leaves(ours), jax.tree_util.tree_leaves(ref)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _same_record(ours, ref):
    assert (ours.snap_id, ours.agent_id, ours.round_idx, ours.mode) == (
        ref.snap_id,
        ref.agent_id,
        ref.round_idx,
        ref.mode,
    )
    assert ours.payload_nbytes == ref.payload_nbytes
    assert len(ours.leaves) == len(ref.leaves)
    for a, b in zip(ours.leaves, ref.leaves):
        assert (a.scale, a.shape, a.nbytes) == (b.scale, b.shape, b.nbytes)
        np.testing.assert_array_equal(a.q, b.q)
        assert a.q.dtype == b.q.dtype == np.int8
        assert (a.idx is None) == (b.idx is None)
        if a.idx is not None:
            np.testing.assert_array_equal(a.idx, b.idx)
    _same_tree(ours.dequantize(), _ref_np(ref.dequantize()))


@pytest.mark.parametrize("compression", ["int8", "topk"])
def test_encode_matches_reference_bitwise(compression):
    rng = np.random.default_rng(0)
    ours = plane.CompressedWeightPlane(compression=compression, k_frac=0.05)
    ref = jax_plane.CompressedWeightPlane(compression=compression, k_frac=0.05)
    base = _np_tree(rng)
    pushes = []
    for r in range(5):
        # a delta that leaves the biases unchanged has all-zero leaves
        step = _np_tree(rng, scale=0.01 * (r + 1), zero_bias=r == 2)
        tree = jax.tree_util.tree_map(lambda a, d: a + d, base, step) if r else base
        pushes.append((r % 2, r, tree))
    for agent_id, r, tree in pushes + [(0, 9, pushes[-1][2])]:
        if r == 9:  # the sender left and came back: a keyframe again
            ours.forget_agent(agent_id)
            ref.forget_agent(agent_id)
        args = (f"W_{r:05d}", agent_id, r, 0.5 * r)
        got = ours.encode(plane.WeightSnapshot(*args, _torch_tree(tree)))
        want = ref.encode(jax_plane.WeightSnapshot(*args, tree))
        _same_record(got, want)
        assert ours.encode(got) is got  # already on the wire format
        assert ours.payload_nbytes(got) == ref.payload_nbytes(want)
    modes = [
        ours.encode(plane.WeightSnapshot(f"X_{r}", 5, r, 0.0, _torch_tree(base))).mode
        for r in range(2)
    ]
    assert modes == (["dense", "delta"] if compression == "topk" else ["dense"] * 2)
    with pytest.raises(ValueError, match="unknown compression"):
        plane.CompressedWeightPlane(compression="fp8")


def test_uncompressed_payload_is_four_bytes_a_parameter():
    tree = _np_tree(np.random.default_rng(1))
    snap = plane.WeightSnapshot("W_1", 0, 0, 0.0, _torch_tree(tree))
    want = jax_plane.WeightPlane().payload_nbytes(
        jax_plane.WeightSnapshot("W_1", 0, 0, 0.0, tree)
    )
    numel = sum(int(np.prod(s)) for v in SHAPES.values() for s in v.values())
    assert plane.WeightPlane().payload_nbytes(snap) == want == 32 + 4 * numel


def test_mix_params_matches_reference_bitwise():
    rng = np.random.default_rng(2)
    params = _np_tree(rng)
    comp, jcomp = plane.CompressedWeightPlane(), jax_plane.CompressedWeightPlane()
    snaps, jsnaps = [], []
    # out of order on the clock, a tie broken by round then id, and a
    # compressed keyframe and delta from one sender
    for i, (t, r) in enumerate([(0.9, 3), (0.2, 1), (0.5, 2), (0.5, 1), (0.7, 0)]):
        tree = _np_tree(rng)
        args = (f"W_{i:05d}", 1 + i % 3, r, t)
        if i >= 3:
            snaps.append(comp.encode(plane.WeightSnapshot(*args, _torch_tree(tree))))
            jsnaps.append(jcomp.encode(jax_plane.WeightSnapshot(*args, tree)))
        else:
            snaps.append(plane.WeightSnapshot(*args, _torch_tree(tree)))
            jtree = jax.tree_util.tree_map(jax.numpy.asarray, tree)
            jsnaps.append(jax_plane.WeightSnapshot(*args, jtree))
    alphas = plane.staleness_alphas(snaps, 1.0, clock="time")
    np.testing.assert_array_equal(
        alphas, jax_plane.staleness_alphas(jsnaps, 1.0, clock="time")
    )
    got = plane.mix_params(_torch_tree(params), snaps, alphas)
    want = jax_plane.mix_params(
        jax.tree_util.tree_map(jax.numpy.asarray, params), jsnaps, alphas
    )
    _same_tree(got, _ref_np(want))
    assert plane.snapshot_params(snaps[0]) is snaps[0].params


@pytest.mark.parametrize("flag", ["constant", "hinge", "poly"])
@pytest.mark.parametrize("clock", ["round", "time"])
def test_staleness_alphas_match_reference(flag, clock):
    rng = np.random.default_rng(3)
    snaps = [
        plane.WeightSnapshot(f"W_{i}", i, int(r), float(t), None)
        for i, (r, t) in enumerate(zip(rng.integers(0, 12, 20), rng.random(20) * 12))
    ]
    jsnaps = [
        jax_plane.WeightSnapshot(s.snap_id, s.agent_id, s.round_idx, s.sim_time, None)
        for s in snaps
    ]
    for now in (0.0, 5.0, 11.5):
        kw = dict(alpha=0.6, flag=flag, hinge_a=10.0, hinge_b=4.0, poly_a=0.5)
        np.testing.assert_array_equal(
            plane.staleness_alphas(snaps, now, clock=clock, **kw),
            jax_plane.staleness_alphas(jsnaps, now, clock=clock, **kw),
        )
    with pytest.raises(ValueError, match="unknown staleness flag"):
        plane.staleness_weight(1.0, "exp")


def test_weight_plane_retention_matches_reference():
    rng = np.random.default_rng(4)
    ours = plane.WeightPlane(max_versions=2)
    ref = jax_plane.WeightPlane(max_versions=2)
    store, jstore = {}, {}
    for i in range(40):
        agent, r = int(rng.integers(0, 3)), int(rng.integers(0, 8))
        snap_id = f"W_{int(rng.integers(0, 30)):05d}"  # ids repeat
        got = ours.admit(store, plane.WeightSnapshot(snap_id, agent, r, 0.0, None))
        jsnap = jax_plane.WeightSnapshot(snap_id, agent, r, 0.0, None)
        want = ref.admit(jstore, jsnap)
        assert got == want
        assert sorted(store) == sorted(jstore)
    assert 0 < len(store) <= 6
    with pytest.raises(ValueError, match="max_versions"):
        plane.WeightPlane(max_versions=0)


@pytest.mark.parametrize("name", ["plane_weight_only", "plane_hybrid"])
def test_plane_scenario_matches_reference(name, monkeypatch):
    (ref_sys, rep_ref), (port_sys, rep) = run_both(name, monkeypatch)
    assert_records_match(rep_ref, rep)
    assert rep.n_mixed > 0 and rep.bytes_by_plane["weights"] > 0
    assert ("erb" in rep.bytes_by_plane) == (name == "plane_hybrid")
    assert_params_match(ref_sys, port_sys, 1e-5)


def test_snapshot_stays_unchanged_after_more_training():
    cfg = DQNConfig(**DQN_KW)
    agent = DQNAgent(0, cfg, seed=1, device="cpu")
    train_p, _ = patient_split(16)
    env = env_for(paper_eight_tasks()[0], train_p[0], cfg)
    erb = agent.collect(
        env, erb_init(256, cfg.box_size, task=paper_eight_tasks()[0]), n_episodes=8
    )
    agent.train_steps(3, erb)
    snap = agent.snapshot_params(1.0)
    before = {k: {n: t.clone() for n, t in v.items()} for k, v in snap.params.items()}
    assert snap.snap_id in agent.seen_snap_ids and snap.round_idx == 0
    agent.train_steps(5, erb)  # more flushes through the resident state
    after = agent.params
    assert any(not torch.equal(a, b) for a, b in zip(leaves(after), leaves(before)))
    for a, b in zip(leaves(snap.params), leaves(before)):
        assert torch.equal(a, b)
    # mixing in our own snapshot is a no-op; a peer's moves the params
    assert agent.mix_params([snap], [0.5]) == 0
    peer = dataclasses.replace(snap, snap_id="W_peer", agent_id=7)
    assert agent.mix_params([peer], [0.5]) == 1
    for p, a, b in zip(leaves(agent.params), leaves(after), leaves(before)):
        assert torch.equal(p, 0.5 * a + 0.5 * b)
