"""The port's sharding policy against the reference's, on the CPU.

For every leaf of every assigned config's params, AdamW moments and
decode caches (the port's built on ``meta``, the reference's by
``jax.eval_shape``), under the default policy, ``dp_over_model`` and
``no_fsdp``, at the mesh shapes 16 x 16, 32 x 8 and 2 x 32 x 8: the
leaf's shape and dtype are the reference's, its spec is the reference's
``leaf_pspec``/``cache_pspec`` (the reference is handed a stand-in mesh
with a ``shape`` dict and ``axis_names``, all its rules read) exactly,
and the port's per-card bytes are the reference's shapes divided by its
specs.  Also: ``make_fleet_mesh`` on a host without a card, and the
experiments CLI's ``--mesh``/``--devices -1`` give the records of a run
without them.
"""

import json
import math
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: these sizes gain nothing from more, and spinning
# OpenMP threads in parallel test workers would starve the other tests
torch.set_num_threads(1)

from repro_torch.configs.base import ASSIGNED, get_config  # noqa: E402
from repro_torch.experiments.__main__ import main as cli_main  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.specs import (  # noqa: E402
    bytes_per_device,
    cache_specs,
    opt_cfg_for,
    state_specs,
)
from repro_torch.models import sharding  # noqa: E402

MESHES = (
    {"data": 16, "model": 16},
    {"data": 32, "model": 8},
    {"pod": 2, "data": 32, "model": 8},
)
POLICIES = ({}, {"dp_over_model": True}, {"no_fsdp": True})
CACHE_SHAPES = ((128, 32_768), (1, 524_288))


@pytest.fixture(scope="module")
def ref():
    pytest.importorskip("jax")
    import jax

    import repro.core  # noqa: F401  (import order: see tests/test_torch_fleet.py)
    from repro.configs.base import get_config as ref_get_config
    from repro.models import model as ref_model
    from repro.models import sharding as ref_sharding
    from repro.optim.adamw import AdamWConfig, adamw_init

    return SimpleNamespace(
        jax=jax,
        get_config=ref_get_config,
        model=ref_model,
        sharding=ref_sharding,
        AdamWConfig=AdamWConfig,
        adamw_init=adamw_init,
    )


def ref_mesh(mesh: dict) -> SimpleNamespace:
    """What the reference's rules read of a ``Mesh``."""
    return SimpleNamespace(shape=dict(mesh), axis_names=tuple(mesh))


def ref_policy(ref, overrides: dict, mesh: dict):
    """The reference's policy as its ``dryrun.run_pair`` builds it."""
    multi = "pod" in mesh
    port = dryrun._policy("any", "train", multi, overrides)
    return ref.sharding.ShardingPolicy(
        batch_axes=port.batch_axes,
        fsdp_axes=port.fsdp_axes,
        tensor_parallel=port.tensor_parallel,
        seq_shard=port.seq_shard,
    )


def ref_leaves(ref, tree, spec_fn) -> dict:
    """path -> (shape, dtype, spec tuple) of a reference shape tree."""
    out = {}

    def visit(path, leaf):
        names = [getattr(k, "key", getattr(k, "idx", None)) for k in path]
        pstr = "/".join(str(n) for n in names)
        spec = tuple(spec_fn(pstr, leaf))
        out[pstr] = (tuple(leaf.shape), np.dtype(leaf.dtype), spec)

    ref.jax.tree_util.tree_map_with_path(visit, tree)
    return out


def port_leaves(tree, prefix="") -> dict:
    """path -> (shape, dtype, spec) of a port ``Sharded`` tree."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(port_leaves(v, f"{prefix}/{k}" if prefix else k))
        return out
    t = tree.tensor
    dtype = np.dtype(str(t.dtype).removeprefix("torch.").replace("bfloat16", "V2"))
    return {prefix: (tuple(t.shape), dtype, tree.spec)}


def same_dtype(port, ref_dtype) -> bool:
    if port == np.dtype("V2"):
        return ref_dtype.name == "bfloat16"
    return port == ref_dtype


def ref_bytes(ref_tree: dict, mesh: dict) -> float:
    """Per-card bytes of the reference's leaves under its specs."""
    total = 0.0
    for shape, dtype, spec in ref_tree.values():
        shard = [
            -(-n // sharding.axis_size(mesh, spec[i] if i < len(spec) else None))
            for i, n in enumerate(shape)
        ]
        total += math.prod(shard) * dtype.itemsize
    return total


def assert_same(port: dict, want: dict) -> None:
    assert sorted(port) == sorted(want)
    for path, (shape, dtype, spec) in port.items():
        r_shape, r_dtype, r_spec = want[path]
        assert shape == r_shape, path
        assert same_dtype(dtype, r_dtype), (path, dtype, r_dtype)
        assert spec == r_spec, (path, spec, r_spec)


@pytest.mark.parametrize("arch", ASSIGNED)
def test_param_and_moment_specs_match_reference(ref, arch):
    cfg, rcfg = get_config(arch), ref.get_config(arch)
    opt_cfg = opt_cfg_for(cfg)
    key = ref.jax.random.PRNGKey(0)
    pshape = ref.jax.eval_shape(lambda: ref.model.init_params(rcfg, key))
    ropt = ref.AdamWConfig(opt_dtype=opt_cfg.opt_dtype)
    oshape = ref.jax.eval_shape(lambda: ref.adamw_init(ropt, pshape))
    for mesh in MESHES:
        rmesh = ref_mesh(mesh)
        for overrides in POLICIES:
            policy = dryrun._policy(arch, "train", "pod" in mesh, overrides)
            rpol = ref_policy(ref, overrides, mesh)
            state = state_specs(cfg, mesh, policy, opt_cfg)

            def spec(path, leaf, rpol=rpol, rmesh=rmesh):
                return ref.sharding.leaf_pspec(path, leaf.shape, rmesh, rpol, rcfg)

            want = ref_leaves(ref, pshape, spec)
            assert_same(port_leaves(state["params"]), want)
            got = bytes_per_device(state["params"], mesh)
            assert got == ref_bytes(want, mesh)
            for moment in ("m", "v"):
                want = ref_leaves(ref, oshape[moment], spec)
                assert_same(port_leaves(state["opt"][moment]), want)
                got = bytes_per_device(state["opt"][moment], mesh)
                assert got == ref_bytes(want, mesh)
            assert state["opt"]["count"].spec == ()


@pytest.mark.parametrize("arch", ASSIGNED)
def test_cache_specs_match_reference(ref, arch):
    cfg, rcfg = get_config(arch), ref.get_config(arch)
    for batch, seq in CACHE_SHAPES:
        cshape = ref.jax.eval_shape(
            lambda b=batch, s=seq: ref.model.init_caches(rcfg, b, s)
        )
        for mesh in MESHES:
            rmesh = ref_mesh(mesh)
            for overrides in POLICIES:
                policy = dryrun._policy(arch, "decode", "pod" in mesh, overrides)
                rpol = ref_policy(ref, overrides, mesh)

                def spec(path, leaf, rpol=rpol, rmesh=rmesh):
                    return ref.sharding.cache_pspec(path, leaf.shape, rmesh, rpol)

                want = ref_leaves(ref, cshape, spec)
                caches = cache_specs(cfg, batch, seq, mesh, policy)
                assert_same(port_leaves(caches), want)
                assert bytes_per_device(caches, mesh) == ref_bytes(want, mesh)


def test_make_fleet_mesh_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    for n in (None, -1, 0, 1, 4):
        assert sharding.make_fleet_mesh(n) is None
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert sharding.make_fleet_mesh(-1) is None
    assert sharding.make_fleet_mesh(8) is None
    # more than one card: a mesh of the cards, floored to a power of two;
    # naming them touches no card (this torch has no CUDA to allocate on)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    assert sharding.make_fleet_mesh(1) is None
    mesh = sharding.make_fleet_mesh(-1)
    assert mesh.devices == (torch.device("cuda", 0), torch.device("cuda", 1))
    assert mesh.size == 2 and mesh.axis == sharding.FLEET
    # a CPU caller never gets one
    assert sharding.make_fleet_mesh(-1, device="cpu") is None


def test_cli_mesh_flags_give_the_single_device_records(tmp_path, capsys):
    base = ["--scenario", "plane_erb_only", "--fast", "--device", "cpu"]
    payloads, lines = [], []
    for extra in ([], ["--mesh"], ["--devices", "-1"]):
        out = tmp_path / f"run{len(payloads)}.json"
        assert cli_main([*base, *extra, "--json", str(out)]) == 0
        payloads.append(json.loads(out.read_text()))
        printed = capsys.readouterr().out.splitlines()
        lines.append([x for x in printed if "wrote" not in x])
    assert payloads[0] == payloads[1] == payloads[2]
    assert lines[0] == lines[1] == lines[2]


def test_fedavg_and_serving_accept_devices_on_one_card():
    from repro_torch.configs.adfll_dqn import DQNConfig
    from repro_torch.core.federated import CentralAggregationSystem
    from repro_torch.rl.synth import paper_eight_tasks
    from repro_torch.serve import TrafficSpec, build_session

    cfg = DQNConfig(box_size=(4, 4, 4), conv_features=(2,), hidden=(8,))
    tasks = paper_eight_tasks()[:2]
    system = CentralAggregationSystem(2, cfg, tasks, [0], devices=-1, device="cpu")
    assert len(system.agents) == 2
    traffic = TrafficSpec(n_requests=2)
    session = build_session(cfg, n_agents=1, traffic=traffic, devices=-1, device="cpu")
    assert session is not None
