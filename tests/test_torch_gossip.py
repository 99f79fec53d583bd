"""The port's gossip transport and topologies against the reference's.

Transport level, exact: the four peer samplers give the same peer
streams; a gossip overlay fed the same records over the same lossy,
site-priced links draws the same drops, delivers the same records at
the same simulated times, and meters the same bytes.

System level (registry widths, ``--fast``, the port's fleet slots
starting from the reference's init through
``test_torch_baselines.reference_init``): ``topo_gossip``,
``topo_hybrid`` and ``gossip_hetero`` give the reference's round records
(every field but the loss identical, the loss within 1e-4), bytes and
messages per plane, records known, pushes per plane and gossip stats
exactly, and every agent's params within 1e-5 after the run.  The
record ids come off each package's own counter, so they are not
compared.  ``topo_gossip_topk`` keeps the records and the wire counts
exact; its params are held to one int8 step of the largest scale any
snapshot was quantized with (plus 1e-5), because a float32 ulp between
the two frameworks can flip one ``rint`` of a code.

``ci_smoke`` runs both its variants on the CPU through the sweep
runner and the CLI.  On the card (``cuda`` tests): the hybrid topology
and top-k gossip train through the kernels, one ``replay_gather`` and one
``fused_td`` launch per stacked step, and agree with the CPU run.
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
from repro.core import gossip as jax_gossip  # noqa: E402
from repro.core import plane as jax_plane  # noqa: E402
from repro.core.scheduler import Scheduler as JaxScheduler  # noqa: E402
from repro.experiments import runner as jax_runner  # noqa: E402
from repro_torch.core import gossip, plane  # noqa: E402
from repro_torch.core.scheduler import Scheduler  # noqa: E402
from repro_torch.experiments import registry  # noqa: E402
from repro_torch.experiments.runner import build, evaluate_into  # noqa: E402
from repro_torch.kernels.fused_td import fused_td  # noqa: E402
from repro_torch.kernels.replay_gather import replay_gather  # noqa: E402
from repro_torch.optim.adamw import leaves  # noqa: E402
from repro_torch.sweeps import __main__ as sweeps_cli  # noqa: E402
from repro_torch.sweeps import failed_cells, get_sweep, run_sweep  # noqa: E402
from test_torch_baselines import _params_close, reference_init  # noqa: E402


# ---------------------------------------------------------------------------
# system-level parity (shared with test_torch_plane / test_torch_stepwise)
# ---------------------------------------------------------------------------
def run_both(name, monkeypatch, **sys_overrides):
    """Build and run scenario ``name`` (``--fast``, registry widths) on
    both sides from the reference's init; returns ``(ref, port)`` as
    ``(system, report)`` pairs."""
    reference_init(monkeypatch)
    spec = jax_runner.resolve(name, fast=True)
    ref_spec = dataclasses.replace(
        spec, sys=dataclasses.replace(spec.sys, **sys_overrides)
    )
    port_spec = registry.get_scenario(name).fast()
    port_spec = dataclasses.replace(
        port_spec, sys=dataclasses.replace(port_spec.sys, **sys_overrides)
    )
    ref = jax_runner._build(ref_spec, ()).system
    port = build(port_spec, device="cpu")
    return (ref, ref.run()), (port, port.run())


def assert_records_match(rep_ref, rep, loss_tol=1e-4):
    ha = [dataclasses.astuple(r) for r in rep_ref.history]
    hb = [dataclasses.astuple(r) for r in rep.history]
    assert len(ha) == len(hb) > 0
    for ra, rb in zip(ha, hb):
        assert ra[:6] == rb[:6] and ra[7:] == rb[7:]
        assert abs(ra[6] - rb[6]) <= loss_tol
    assert rep.bytes_by_plane == rep_ref.bytes_by_plane
    assert rep.msgs_by_plane == rep_ref.msgs_by_plane
    assert rep.records_known == rep_ref.records_known
    assert rep.plane_pushed == rep_ref.plane_pushed
    assert (rep.makespan, rep.n_rounds, rep.n_mixed, rep.n_foreign_erbs) == (
        rep_ref.makespan,
        rep_ref.n_rounds,
        rep_ref.n_mixed,
        rep_ref.n_foreign_erbs,
    )
    assert rep.extra.get("gossip") == rep_ref.extra.get("gossip")


def assert_params_match(ref_sys, port_sys, atol):
    assert ref_sys.agents.keys() == port_sys.agents.keys()
    for aid, agent in port_sys.agents.items():
        _params_close(agent.params, ref_sys.agents[aid].params, atol)
        _params_close(agent.target_params, ref_sys.agents[aid].target_params, atol)


@pytest.mark.parametrize("name", ["topo_gossip", "topo_hybrid", "gossip_hetero"])
def test_gossip_scenario_matches_reference(name, monkeypatch):
    (ref_sys, rep_ref), (port_sys, rep) = run_both(name, monkeypatch)
    assert_records_match(rep_ref, rep)
    assert rep.n_mixed > 0 and rep.bytes_by_plane["weights"] > 0
    assert_params_match(ref_sys, port_sys, 1e-5)


def test_topk_gossip_matches_reference_within_one_int8_step(monkeypatch):
    encoded = []
    encode = plane.CompressedWeightPlane.encode

    def recording(self, item):
        out = encode(self, item)
        encoded.append(out)
        return out

    monkeypatch.setattr(plane.CompressedWeightPlane, "encode", recording)
    (ref_sys, rep_ref), (port_sys, rep) = run_both("topo_gossip_topk", monkeypatch)
    assert_records_match(rep_ref, rep)
    assert {s.mode for s in encoded} == {"dense", "delta"}
    step = max(leaf.scale for snap in encoded for leaf in snap.leaves)
    assert 0.0 < step < 0.1
    assert_params_match(ref_sys, port_sys, step + 1e-5)
    # the wire carries the compressed records: >= 4x below dense float32
    dense = 4 * sum(x.numel() for x in leaves(port_sys.agents[0].params))
    per_msg = rep.bytes_by_plane["weights"] / rep.msgs_by_plane["weights"]
    assert per_msg <= dense / 4


# ---------------------------------------------------------------------------
# transport level: samplers, overlay, site links
# ---------------------------------------------------------------------------
@pytest.mark.parametrize(
    "name, fanout",
    [("ring", 1), ("ring", 3), ("random", 2), ("full", 2), ("timevary", 2)],
)
def test_sampler_peer_streams_match_reference(name, fanout):
    ours = gossip.make_sampler(name, fanout=fanout, seed=7)
    ref = jax_gossip.make_sampler(name, fanout=fanout, seed=7)
    id_sets = [list(range(6)), [0, 2, 3, 5, 9], [4], list(range(11))] * 3
    for r, ids in enumerate(id_sets):
        ours.new_round(float(r))
        ref.new_round(float(r))
        for aid in ids:
            assert ours.peers(aid, ids) == ref.peers(aid, ids)
    with pytest.raises(ValueError, match="unknown peer sampler"):
        gossip.make_sampler("star")


def _snap_pair(rng, agent_id, round_idx, sim_time, snap_id):
    """The same weight snapshot for the reference (numpy leaves) and the
    port (tensor leaves)."""
    tree = {
        "fc0": {"w": rng.standard_normal((7, 5)).astype(np.float32)},
        "loc": {"b": rng.standard_normal(3).astype(np.float32)},
    }
    ours = plane.WeightSnapshot(
        snap_id,
        agent_id,
        round_idx,
        sim_time,
        {k: {n: torch.from_numpy(a) for n, a in v.items()} for k, v in tree.items()},
    )
    ref = jax_plane.WeightSnapshot(snap_id, agent_id, round_idx, sim_time, tree)
    return ours, ref


def _overlay(pkg, pl, sampler_seed, sites):
    link = pkg.LinkModel(latency=0.01, rate=2.0**14, drop=0.3)
    topo = pkg.GossipTopology(
        {"weights": pl},
        pkg.make_sampler("random", fanout=2, seed=sampler_seed),
        link=link,
        rng=np.random.default_rng(3),
        site_links=pkg.SiteLinks(
            default=link,
            agent_site=sites,
            intra=pkg.LinkModel(latency=0.001, rate=2.0**16, drop=0.1),
            inter=pkg.LinkModel(latency=0.05, rate=2.0**12, drop=0.4),
        ),
    )
    for aid in range(6):
        topo.add_agent(aid)
    return topo


def test_anti_entropy_matches_reference():
    """Same records, lossy site-priced links, scheduled delivery: the
    same drops, deliveries, arrival times, stores and bytes."""
    rng = np.random.default_rng(0)
    sites = {0: 0, 1: 0, 2: 0, 3: 1, 4: 1}  # agent 5 has no site: default link
    ours = _overlay(gossip, plane.WeightPlane(max_versions=2), 11, sites)
    ref = _overlay(jax_gossip, jax_plane.WeightPlane(max_versions=2), 11, sites)
    sched, jsched = Scheduler(), JaxScheduler()
    arrivals, jarrivals = [], []
    for topo, s, log in ((ours, sched, arrivals), (ref, jsched, jarrivals)):
        deliver = topo._deliver

        def spy(dst, rec, name, *rest, deliver=deliver, s=s, log=log):
            log.append((s.now, dst, rec.snap_id))
            return deliver(dst, rec, name, *rest)

        topo._deliver = spy
    n = 0
    for step in range(8):
        for aid in range(6):
            if (aid + step) % 3 == 0:
                a, b = _snap_pair(rng, aid, step, 0.1 * step, f"W_{n:05d}")
                n += 1
                assert ours.insert_local(aid, a, ours.planes["weights"]) == (
                    ref.insert_local(aid, b, ref.planes["weights"])
                )
        t = 0.1 * step
        sched.run(until=t)
        jsched.run(until=t)
        assert ours.anti_entropy(sched) == ref.anti_entropy(jsched)
    sched.run(until=10.0)
    jsched.run(until=10.0)
    assert arrivals == jarrivals and len(arrivals) > 10
    assert dataclasses.asdict(ours.stats) == dataclasses.asdict(ref.stats)
    assert ours.stats.n_dropped > 0
    assert ours.meter.bytes_by_plane == ref.meter.bytes_by_plane
    assert ours.meter.msgs_by_plane == ref.meter.msgs_by_plane
    for aid in range(6):
        assert sorted(ours.local_store(aid, "weights")) == sorted(
            ref.local_store(aid, "weights")
        )
    assert ours.all_known("weights") == ref.all_known("weights")
    assert ours.converged("weights") == ref.converged("weights")
    # immediate delivery without a scheduler converges a full mesh
    mesh = gossip.GossipTopology(
        ours.planes, gossip.FullMeshSampler(), rng=np.random.default_rng(0)
    )
    for aid in range(6):
        mesh.stores[aid] = {"weights": dict(ours.local_store(aid, "weights"))}
    mesh.anti_entropy()
    assert mesh.converged("weights")


def test_site_links_price_like_the_reference():
    def links(pkg):
        return pkg.SiteLinks(
            default=pkg.LinkModel(latency=0.01, rate=1e6),
            agent_site={0: 0, 1: 0, 2: 1},
            hub_site={0: 1},
            intra=pkg.LinkModel(latency=0.001, rate=1e8),
            inter=pkg.LinkModel(latency=0.1, rate=1e5),
        )

    ours, ref = links(gossip), links(jax_gossip)
    legs = [("pair", a, b) for a, b in [(0, 1), (0, 2), (2, 3), (3, 4)]]
    legs += [("agent_hub", a, h) for a, h in [(0, 0), (2, 0), (3, 0), (0, None)]]
    for how, a, b in legs:
        mine, theirs = getattr(ours, how)(a, b), getattr(ref, how)(a, b)
        assert dataclasses.astuple(mine) == dataclasses.astuple(theirs)
        for nbytes in (0, 1000, 123457):
            assert mine.transfer_time(nbytes) == theirs.transfer_time(nbytes)


def test_topology_wiring_and_validation():
    from repro_torch.core.hub import Hub
    from repro_torch.core.network import Network

    with pytest.raises(ValueError, match="unknown topology"):
        Network(hubs=[], topology="star")
    net = Network(hubs=[], topology="gossip")
    with pytest.raises(RuntimeError, match="enable_gossip"):
        net.attach_agent(0)
    hybrid = Network(hubs=[Hub(0)], topology="hybrid")
    with pytest.raises(RuntimeError, match="enable_gossip"):
        hybrid.agent_push(0, None)
    hybrid.attach_agent(0)
    overlay = hybrid.enable_gossip(gossip.RingSampler())
    assert set(overlay.stores) == {0}  # back-filled from the hub layout
    sites = hybrid.configure_sites(
        {0: 1}, hub_site={0: 1}, intra=gossip.LinkModel(0.5)
    )
    assert overlay.site_links is sites and hybrid.link_for(0).latency == 0.5


# ---------------------------------------------------------------------------
# ci_smoke: both variants through the sweep runner and the CLI
# ---------------------------------------------------------------------------
def test_ci_smoke_sweep_is_the_references():
    from repro import sweeps as jax_sweeps

    ours, ref = get_sweep("ci_smoke"), jax_sweeps.get_sweep("ci_smoke")
    assert [dataclasses.astuple(v) for v in ours.variants] == [
        dataclasses.astuple(v) for v in ref.variants
    ]
    assert (ours.seeds, ours.baseline, ours.metrics, ours.cell_budget_s) == (
        ref.seeds,
        ref.baseline,
        ref.metrics,
        ref.cell_budget_s,
    )


def test_ci_smoke_runs_both_variants_on_the_cpu(tmp_path, monkeypatch, capsys):
    summary = run_sweep(get_sweep("ci_smoke"), fast=True, workers=1, device="cpu")
    assert not failed_cells(summary)
    assert sorted(summary["variants"]) == ["erb_hub", "gossip"]
    assert [(c["label"], c["seed"]) for c in summary["cells"]] == [
        ("erb_hub", 0),
        ("erb_hub", 1),
        ("gossip", 0),
        ("gossip", 1),
    ]
    for v in summary["variants"].values():
        values = v["metrics"]["mean_dist_err"]["values"]
        assert len(values) == 2 and all(np.isfinite(x) for x in values.values())
    monkeypatch.chdir(tmp_path)
    argv = ["--sweep", "ci_smoke", "--fast", "--workers", "1", "--device", "cpu"]
    assert sweeps_cli.main([*argv, "--store", "none"]) == 0
    out = capsys.readouterr().out
    assert "gossip" in out and "erb_hub" in out
