"""MLA, Mamba, mLSTM and sLSTM on ``torch.distributed`` ``(data, model)``
meshes against the reference's jitted meshed steps on the CPU.

deepseek-v2-lite-16b-smoke (MLA and its latent cache, a dense prefix
layer, MoE with a shared expert), jamba-1.5-large-398b-smoke (Mamba, an
attention layer, MoE and dense FFNs) and xlstm-125m-smoke (mLSTM and
sLSTM) run through ``Model(mesh=)`` with every leaf in its ``leaf_pspec``
block and every cache in its ``cache_pspec`` block, on gloo worlds of
``{data 2, model 2}`` and ``{data 1, model 4}`` (one process a rank),
with their own MoE settings; at ``{1, 4}`` also deepseek cut to 2 heads
(MLA whole on each rank over a latent cache in sequence blocks) and
xlstm at d_model 192 with 2 heads (mLSTM's cell and sLSTM's recurrence
whole on each rank between channel-split projections, sLSTM's FFN
split).  The cases and the harness are
``tests/test_torch_zoo_mesh.py``'s (``MIXER_CASES``, ``run_case``,
``ref_main``): the reference runs ``make_loss_fn``, ``make_train_step``,
``make_prefill_step`` and ``make_serve_step`` with ``mesh=`` under
``jax.jit`` on four forced host devices, one subprocess a case.  Held:
the loss, aux, token count and grad norm (1e-5 relative), each rank's
block of every gradient (1e-5 of the leaf's scale), the params after 3
steps, the prefill's and 4 decode steps' logits (1e-4), each rank's
state and cache bytes equal to the planner's, and each rank's caches
after decoding equal to its blocks of the reference's (MLA's latent
cache in sequence blocks over ``model``, whole over ``model`` in
``deepseek_37``, whose 37 slots do not divide over 4; the recurrent
states by channel or head).

Also, without a world: a one-rank gloo mesh runs the new regions bit for
bit the mesh-less model (train, prefill and decode), and at the
production mesh ``{data 32, model 8}`` the blocks a rank keeps
(``shard_params`` on ``meta``) are the planner's train state.
``python tests/test_torch_mixers_mesh.py port|ref ...`` are the two
sides' entry points.
"""

import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_zoo_mesh import (  # noqa: E402
    DECODE,
    MIXER_CASES,
    STEPS,
    _env,
    _match,
    cache_slots,
    case_batch,
    check_cache_blocks,
    flatten,
    join_mesh,
    ref_main,
    run_all,
    run_case,
)

MESHES = sorted({mesh for _, mesh, _, _ in MIXER_CASES.values()})
# a rank's train state at {data 32, model 8} as the planner plans it, GB:
# with float32 moments, and with launch.train's (bfloat16 above 1e11
# parameters: jamba)
PRODUCTION = {
    "deepseek-v2-lite-16b": (0.73, 0.73),
    "jamba-1.5-large-398b": (16.99, 10.20),
    "xlstm-125m": (0.05, 0.05),
}


def port_main(nd, nm, rank, rdv, out):
    import torch.distributed as dist

    mesh = join_mesh(nd, nm, rank, rdv)
    res = {}
    for name, (_, shape, _, _) in MIXER_CASES.items():
        if shape == (nd, nm):
            res.update(run_case(name, mesh))
    np.savez(out, **res)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both worlds and every reference run, started together:
    ``port[(nd, nm)][rank]`` and ``ref[name]``."""
    pytest.importorskip("jax")
    tmp = tmp_path_factory.mktemp("mixers_mesh")
    here = os.path.abspath(__file__)
    procs = []
    for nd, nm in MESHES:
        for r in range(nd * nm):
            out = tmp / f"port_{nd}x{nm}_{r}.npz"
            args = ("port", nd, nm, r, tmp / f"rdv_{nd}x{nm}", out)
            procs.append((f"port {nd}x{nm} rank {r}", [sys.executable, here,
                          *map(str, args)], _env()))  # fmt: skip
    flags = "--xla_force_host_platform_device_count=4"
    env = _env({"XLA_FLAGS": flags, "JAX_PLATFORMS": "cpu"})
    for name in MIXER_CASES:
        cmd = [sys.executable, here, "ref", name, str(tmp / f"ref_{name}.npz")]
        procs.append((f"reference {name}", cmd, env))
    run_all(procs)
    port = {
        (nd, nm): [
            dict(np.load(tmp / f"port_{nd}x{nm}_{r}.npz")) for r in range(nd * nm)
        ]
        for nd, nm in MESHES
    }
    ref = {name: dict(np.load(tmp / f"ref_{name}.npz")) for name in MIXER_CASES}
    return port, ref


@pytest.mark.parametrize("name", list(MIXER_CASES))
def test_meshed_mixers_match_the_reference(runs, name):
    """Every rank: the loss, aux and token count of the loss and 3 train
    steps' loss, aux, total and grad norm (1e-5 relative), its block of
    every gradient against the reference's block (1e-5 of the leaf's
    scale), the whole params after the steps, the prefill's last logits
    and 4 decode steps' logits (1e-4)."""
    port, ref = runs
    _match(port, ref[name], name)


@pytest.mark.parametrize("name", list(MIXER_CASES))
def test_each_rank_holds_the_planned_state_and_caches(runs, name):
    """Each rank's parameter and AdamW bytes equal ``bytes_per_device`` of
    ``state_specs``, and its cache bytes ``cache_specs``', at the mesh's
    shape; and its caches after decoding are its blocks of the
    reference's."""
    port, ref = runs
    _, mesh, _, _ = MIXER_CASES[name]
    for got in port[mesh]:
        assert float(got[f"{name}/bytes"]) == float(got[f"{name}/planned_bytes"])
        assert float(got[f"{name}/cache_bytes"]) == float(
            got[f"{name}/planned_cache_bytes"]
        )
    check_cache_blocks(port, ref[name], name)


@pytest.mark.parametrize(
    "name", ["deepseek_22", "deepseek_14", "deepseek_37", "deepseek_2heads"]
)
def test_latent_cache_is_split_along_the_sequence(runs, name):
    """MLA's latent cache (``ckv``, ``krope``) is held in blocks of the
    sequence over ``model`` where its slots divide (36 over 2 and 4: each
    rank holds 18 or 9 slots, the reference's at those positions; also
    where MLA runs whole on each rank), and whole over ``model`` where
    they do not (37 over 4)."""
    port, ref = runs
    _, (nd, nm), _, _ = MIXER_CASES[name]
    specs = check_cache_blocks(port, ref[name], name)
    slots = cache_slots(name)
    split = slots % nm == 0
    for path, spec in specs.items():
        if path.rsplit("/", 1)[-1] in ("ckv", "krope"):
            dim = 2 if path.startswith("groups/") else 1
            assert (spec[dim] == "model") == split, (path, spec)
            for got in port[(nd, nm)]:
                want = slots // nm if split else slots
                assert got[f"{name}/cache/{path}"].shape[dim] == want


@pytest.mark.parametrize(
    "arch", ["deepseek-v2-lite-16b-smoke", "jamba-1.5-large-398b-smoke",
             "xlstm-125m-smoke"],
)  # fmt: skip
def test_one_rank_mesh_runs_the_mixers_bitwise(arch):
    """On a one-rank gloo mesh every collective of the MLA, Mamba, mLSTM
    and sLSTM regions is issued over groups of one (the latent cache a
    sequence block of all the slots, read by the split-K combine); 3
    train steps, a prefill and 4 decode steps then give the mesh-less
    model's losses, grad norms, params and logits bit for bit."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch.mesh import one_rank_device_mesh
    from repro_torch.models import spmd
    from repro_torch.models.model import Model
    from repro_torch.optim.adamw import tree_leaves

    cfg = get_config(arch)
    train_np, _, steps_np = case_batch("danube", cfg)
    batch = {k: torch.from_numpy(v) for k, v in train_np.items()}
    prefill = {k: v for k, v in batch.items() if k != "labels"}
    b, s = train_np["labels"].shape

    def run(mesh):
        model = Model(cfg, "cpu", mesh=mesh)
        state = model.init_train_state(0)
        lines = []
        for _ in range(STEPS):
            state, m = model.train_step(state, batch)
            lines.append((m["loss"].item(), m["grad_norm"].item(), m["total"].item()))
        with torch.no_grad():
            last, pre = model.prefill_step(state["params"], prefill)
            caches = model.load_prefill(model.init_caches(b, s + DECODE), pre)
            logits = [last]
            for step in steps_np:
                step = {k: torch.from_numpy(v) for k, v in step.items()}
                lg, caches = model.serve_step(state["params"], caches, step)
                logits.append(lg)
        return lines, tree_leaves(state["params"]), logits

    want = run(None)
    gathers = []
    real = spmd.all_gather

    def counted(*a, **kw):
        gathers.append(a[0].shape)
        return real(*a, **kw)

    with one_rank_device_mesh("cpu") as mesh:
        spmd.all_gather = counted
        try:
            got = run(mesh)
        finally:
            spmd.all_gather = real
    assert got[0] == want[0]
    assert all(torch.equal(a, b) for a, b in zip(got[1], want[1], strict=True))
    assert all(torch.equal(a, b) for a, b in zip(got[2], want[2], strict=True))
    assert gathers  # the sharded body ran: its gathers were issued


class _ProductionMesh:
    """Rank 0 of the ``{data 32, model 8}`` mesh, as ``shard_params`` reads
    a ``DeviceMesh`` (names, shape, local ranks)."""

    mesh_dim_names = ("data", "model")
    shape = (32, 8)

    def get_local_rank(self, axis):
        return 0


@pytest.mark.parametrize("arch", list(PRODUCTION))
def test_a_rank_holds_the_planned_train_state_at_the_production_mesh(arch):
    """At ``{data 32, model 8}`` (``launch.train --production-mesh``) the
    blocks ``shard_params`` keeps of every leaf, on ``meta``, and their
    AdamW moments are the planner's train state a rank, not the whole
    leaves: with float32 moments jamba 16.99 GB, deepseek 0.73, xlstm
    0.05; with ``launch.train``'s moments (bfloat16 for jamba) 10.20."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch.specs import bytes_per_device, opt_cfg_for, state_specs
    from repro_torch.models.model import meta_params
    from repro_torch.models.sharding import ShardingPolicy, shard_params
    from repro_torch.optim.adamw import AdamWConfig, tree_adamw_init

    cfg = get_config(arch)
    policy = ShardingPolicy()
    mesh = _ProductionMesh()
    axes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    params = shard_params(cfg, meta_params(cfg), mesh, policy)
    for opt_cfg, gb in zip((AdamWConfig(), opt_cfg_for(cfg)), PRODUCTION[arch]):
        state = {"params": params, "opt": tree_adamw_init(opt_cfg, params)}
        held = sum(t.numel() * t.element_size() for t in flatten(state).values())
        planned = bytes_per_device(state_specs(cfg, axes, policy, opt_cfg), axes)
        assert held == planned
        assert round(held / 1e9, 2) == gb


if __name__ == "__main__":
    if sys.argv[1] == "port":
        nd, nm, rank = (int(a) for a in sys.argv[2:5])
        port_main(nd, nm, rank, *sys.argv[5:7])
    else:
        ref_main(sys.argv[2], sys.argv[3])
