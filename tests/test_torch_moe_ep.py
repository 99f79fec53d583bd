"""Expert-parallel MoE over ``torch.distributed`` ``(data, model)`` meshes
against the reference's sharded ``moe_apply`` on the CPU.

The port runs one ``gloo`` process per rank (``init_device_mesh("cpu",
(n_data, n_model))``); the reference runs its ``shard_map`` under
``jax.jit`` on a ``jax.sharding.Mesh`` of forced host devices, in a
subprocess per device count (the device count only takes effect before
JAX starts), as ``tests/test_fleet.py`` runs its mesh.  Both take the
same numpy-seeded params, tokens and output cotangent, in float32, at
``{data 1, model 2}``, ``{data 2, model 2}`` (FSDP: the experts'
``d_model`` axis split over data) and ``{data 1, model 4}``:

* train (all-to-all) and decode (psum) at capacity factor 1.25, where
  pairs drop, and 16: ``y`` and ``aux`` within 1e-5, the dropped pairs of
  every shard equal, and the gradients of x, the router and the experts
  (each rank's slice, put together) within 1e-5 of their scale;
* a decode batch the data axis does not divide takes the local path on
  both sides; a train ``S`` the model axis does not divide raises on both;
* each rank holds ``E_loc / E`` of the expert bytes (``1 / n_data`` more
  under FSDP);
* at ``{data 1, model 2}``, qwen3-moe-smoke through ``Model(mesh=)``: the
  loss and every gradient (each leaf put together from the ranks' blocks
  by its ``leaf_pspec``) against the reference's jitted
  ``make_loss_fn(mesh=)`` at the one-process train step's tolerance
  (``tests/test_torch_lm_train.py``: 1e-5 of each leaf's scale), and one
  ``train_step`` (the global gradient norm over the ranks' blocks) against
  the reference's.

Every world and reference run starts once for the module; a world's
rendezvous is a file under the test's temporary directory, its process
group times out after a minute, and each process is joined with a
timeout that fails the tests.  ``python tests/test_torch_moe_ep.py port
...`` / ``ref ...`` are the two sides' entry points.
"""

import dataclasses
import datetime
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: these sizes gain nothing from more, and spinning
# OpenMP threads in parallel test workers would starve the other tests
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "qwen3-moe-235b-a22b-smoke"  # E 4, top-k 2
MESHES = ((1, 2), (2, 2), (1, 4))
D_MODEL, D_FF = 32, 16  # the layer cases' widths (D divides over data 2)
# name: (mode, capacity factor, [B, S])
CASES = {
    "train_cf1.25": ("train", 1.25, (2, 16)),
    "train_cf16": ("train", 16.0, (2, 16)),
    "decode_cf1.25": ("decode", 1.25, (8, 1)),
    "decode_cf16": ("decode", 16.0, (8, 1)),
    "decode_odd_batch": ("decode", 1.25, (3, 1)),  # 3 % n_data 2: local path
}
AUX_WEIGHT = 0.37  # the aux loss's weight in the differentiated scalar
GRADS = ("x", "router", "w1", "w3", "w2")
MODEL_BATCH = (2, 16)
TIMEOUT = 240  # seconds for a world or a reference run, import included


# -- inputs, made the same way on both sides -------------------------------------
def layer_cfg(cfg_mod, cf):
    """The smoke config's MoE at the layer cases' widths and ``cf``."""
    cfg = cfg_mod.get_config(ARCH)
    moe = dataclasses.replace(cfg.moe, d_ff_expert=D_FF, capacity_factor=cf)
    return dataclasses.replace(cfg, d_model=D_MODEL, moe=moe)


def layer_inputs(name):
    """Whole params, x and the cotangent of y of a case, from numpy."""
    _, _, (b, s) = CASES[name]
    rng = np.random.default_rng(sorted(CASES).index(name))
    e = 4
    p = {
        "router": rng.standard_normal((D_MODEL, e)) * D_MODEL**-0.5,
        "w1": rng.standard_normal((e, D_MODEL, D_FF)) * D_MODEL**-0.5,
        "w3": rng.standard_normal((e, D_MODEL, D_FF)) * D_MODEL**-0.5,
        "w2": rng.standard_normal((e, D_FF, D_MODEL)) * D_FF**-0.5,
    }
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.standard_normal((b, s, D_MODEL)).astype(np.float32)
    gy = rng.standard_normal((b, s, D_MODEL)).astype(np.float32)
    return p, x, gy


def model_inputs(shapes: dict):
    """qwen3-moe-smoke params (every leaf from numpy, by path in sorted
    order: fan-in scaled normals, norm scales near 1) and a token batch."""
    rng = np.random.default_rng(11)
    params = {}
    for path in sorted(shapes):
        shape = shapes[path]
        if path.endswith("scale"):
            v = 1.0 + 0.1 * rng.standard_normal(shape)
        else:
            v = rng.standard_normal(shape) * shape[-2] ** -0.5
        params[path] = v.astype(np.float32)
    toks = rng.integers(0, 512, (MODEL_BATCH[0], MODEL_BATCH[1] + 1))
    return params, toks[:, :-1].astype(np.int32), toks[:, 1:].astype(np.int32)


def nest(flat: dict) -> dict:
    out: dict = {}
    for path, v in flat.items():
        node = out
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return out


def flatten(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flatten(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tree}


# -- the port's side: one process a rank -----------------------------------------
def port_main(nd, nm, rank, rdv, out):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import base as cfg_mod
    from repro_torch.models import moe
    from repro_torch.models.model import Model, init_params, value_and_grad
    from repro_torch.optim.adamw import tree_adamw_init

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo",
        init_method=f"file://{rdv}",
        rank=rank,
        world_size=nd * nm,
        timeout=datetime.timedelta(seconds=60),
    )
    mesh = init_device_mesh("cpu", (nd, nm), mesh_dim_names=("data", "model"))
    # each dispatch's dropped pairs and the branch each body call took
    dropped, branches = [], []
    dispatch, body = moe._dispatch_indices, moe.moe_local

    def recording_dispatch(eidx, *args):
        out = dispatch(eidx, *args)
        dropped.append(int((~out[2]).sum()))
        return out

    def recording_body(*args, model=None, seq_sharded, **kw):
        path = "local" if model is None else ("all_to_all" if seq_sharded else "psum")
        branches.append(path)
        return body(*args, model=model, seq_sharded=seq_sharded, **kw)

    moe._dispatch_indices, moe.moe_local = recording_dispatch, recording_body
    res = {}
    for name, (mode, cf, _) in CASES.items():
        cfg = layer_cfg(cfg_mod, cf)
        p_np, x_np, gy = layer_inputs(name)
        whole = {k: torch.from_numpy(v) for k, v in p_np.items()}
        p = moe.shard_moe_params(cfg, whole, mesh)
        for k in moe.EXPERTS:
            res[f"{name}/bytes_{k}"] = p[k].nbytes / whole[k].nbytes
        live = {k: v.detach().clone().requires_grad_(True) for k, v in p.items()}
        x = torch.from_numpy(x_np).requires_grad_(True)
        y, aux = moe.moe_apply(cfg, live, x, mesh=mesh, mode=mode)
        loss = (y * torch.from_numpy(gy)).sum() + AUX_WEIGHT * aux
        grads = torch.autograd.grad(loss, [x] + [live[k] for k in GRADS[1:]])
        res[f"{name}/y"] = y.detach().numpy()
        res[f"{name}/aux"] = aux.detach().numpy()
        res[f"{name}/dropped"] = np.int64(dropped[-1])
        res[f"{name}/path"] = np.array(branches[-1])
        for k, g in zip(GRADS, grads, strict=True):
            res[f"{name}/grad_{k}"] = g.numpy()
    # a train S the model axis does not divide
    cfg = layer_cfg(cfg_mod, 1.25)
    whole = {k: torch.from_numpy(v) for k, v in p_np.items()}
    p = moe.shard_moe_params(cfg, whole, mesh)
    try:
        moe.moe_apply(cfg, p, torch.zeros(2, 15, D_MODEL), mesh=mesh, mode="train")
        res["odd_s_raises"] = np.bool_(False)
    except ValueError:
        res["odd_s_raises"] = np.bool_(True)

    if (nd, nm) == (1, 2):  # the model through Model(mesh=)
        cfg = cfg_mod.get_config(ARCH)
        model = Model(cfg, device="cpu", mesh=mesh)
        like = init_params(cfg, torch.Generator().manual_seed(0))
        shapes = {k: tuple(v.shape) for k, v in flatten(like).items()}
        flat, toks, labels = model_inputs(shapes)
        whole = nest({k: torch.from_numpy(v) for k, v in flat.items()})
        params = model.shard(whole)
        batch = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)}
        total, metrics, grads = value_and_grad(model.loss_fn, params, batch)
        res["model/total"] = total.numpy()
        res["model/aux"] = metrics["aux"].numpy()
        for k, g in flatten(grads).items():
            res[f"model/grad/{k}"] = g.numpy()
        state = {"params": params, "opt": tree_adamw_init(model.opt_cfg, params)}
        state, metrics = model.train_step(state, batch)
        res["model/step_grad_norm"] = metrics["grad_norm"].numpy()
        res["model/step_total"] = metrics["total"].numpy()
        for k, v in flatten(state["params"]).items():
            res[f"model/step/{k}"] = v.numpy()
    np.savez(out, **res)
    dist.destroy_process_group()


# -- the reference's side: one process a device count ----------------------------
def ref_main(ndev, out):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    import repro.core  # noqa: F401  (the reference's own import order)
    from repro.configs import base as cfg_mod
    from repro.models import moe
    from repro.models.model import init_params, make_loss_fn, make_train_step
    from repro.optim.adamw import AdamWConfig, adamw_init

    res = {}
    for nd, nm in (m for m in MESHES if m[0] * m[1] == ndev):
        mesh = Mesh(np.array(jax.devices()[:ndev]).reshape(nd, nm), ("data", "model"))
        for name, (mode, cf, (b, s)) in CASES.items():
            cfg = layer_cfg(cfg_mod, cf)
            p_np, x_np, gy = layer_inputs(name)

            def loss(p, x, cfg=cfg, mode=mode, gy=gy):
                y, aux = moe.moe_apply(cfg, p, x, mesh=mesh, mode=mode)
                return (y * gy).sum() + AUX_WEIGHT * aux, (y, aux)

            fn = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))
            (_, (y, aux)), (gp, gx) = fn(p_np, x_np)
            key = f"{nd}x{nm}/{name}"
            res[f"{key}/y"] = np.asarray(y)
            res[f"{key}/aux"] = np.asarray(aux)
            res[f"{key}/grad_x"] = np.asarray(gx)
            for k in GRADS[1:]:
                res[f"{key}/grad_{k}"] = np.asarray(gp[k])
            # each shard's dropped pairs, from the reference's own routing
            local = b % nd != 0
            drops = []
            for r in range(nd * nm):
                di, mi = divmod(r, nm)
                if local:
                    xs = x_np
                elif mode == "train":
                    xs = x_np[di * b // nd : (di + 1) * b // nd]
                    xs = xs[:, mi * s // nm : (mi + 1) * s // nm]
                else:
                    xs = x_np[di * b // nd : (di + 1) * b // nd]
                xf = jnp.asarray(xs.reshape(-1, D_MODEL))
                cap = max(1, int(-(-2 * xf.shape[0] * cf // 4)))
                _, eidx, _ = moe._route(cfg, p_np["router"], xf)
                _, _, keep = moe._dispatch_indices(eidx, 4, cap)
                drops.append(int((~keep).sum()))
            res[f"{key}/dropped"] = np.array(drops)
        cfg = layer_cfg(cfg_mod, 1.25)
        try:
            jax.jit(lambda p, x: moe.moe_apply(cfg, p, x, mesh=mesh, mode="train"))(
                p_np, np.zeros((2, 15, D_MODEL), np.float32)
            )
            res[f"{nd}x{nm}/odd_s_raises"] = np.bool_(False)
        except ValueError:
            res[f"{nd}x{nm}/odd_s_raises"] = np.bool_(True)

        if (nd, nm) == (1, 2):
            cfg = cfg_mod.get_config(ARCH)
            key = jax.random.PRNGKey(0)
            shape_tree = jax.eval_shape(lambda k: init_params(cfg, k), key)
            shapes = {k: tuple(v.shape) for k, v in flatten(shape_tree).items()}
            flat, toks, labels = model_inputs(shapes)
            params = jax.tree_util.tree_map(jnp.asarray, nest(flat))
            batch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
            vg = jax.jit(jax.value_and_grad(make_loss_fn(cfg, mesh=mesh), has_aux=True))
            (total, metrics), grads = vg(params, batch)
            res["model/total"] = np.asarray(total)
            res["model/aux"] = np.asarray(metrics["aux"])
            for k, g in flatten(grads).items():
                res[f"model/grad/{k}"] = np.asarray(g)
            opt_cfg = AdamWConfig()
            step = jax.jit(make_train_step(cfg, opt_cfg, mesh=mesh))
            state = {"params": params, "opt": adamw_init(opt_cfg, params)}
            state, metrics = step(state, batch)
            res["model/step_grad_norm"] = np.asarray(metrics["grad_norm"])
            res["model/step_total"] = np.asarray(metrics["total"])
            for k, v in flatten(state["params"]).items():
                res[f"model/step/{k}"] = np.asarray(v)
    np.savez(out, **res)


# -- the runs, started together once for the module ------------------------------
def _env(extra=None):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(ROOT, "src")] + [p for p in [env.get("PYTHONPATH")] if p]
    )
    env["OMP_NUM_THREADS"] = "1"
    env.update(extra or {})
    return env


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Start every world and both reference runs, wait for all (each with
    a timeout), and load what each wrote: ``port[(nd, nm)][rank]`` and
    ``ref[ndev]``."""
    pytest.importorskip("jax")
    tmp = tmp_path_factory.mktemp("moe_ep")
    here = os.path.abspath(__file__)
    procs = []
    for nd, nm in MESHES:
        rdv = tmp / f"rdv_{nd}x{nm}"
        for r in range(nd * nm):
            out = tmp / f"port_{nd}x{nm}_{r}.npz"
            args = ("port", nd, nm, r, rdv, out)
            cmd = [sys.executable, here, *map(str, args)]
            procs.append((f"port {nd}x{nm} rank {r}", cmd, _env()))
    for ndev in (2, 4):
        flags = f"--xla_force_host_platform_device_count={ndev}"
        env = _env({"XLA_FLAGS": flags, "JAX_PLATFORMS": "cpu"})
        cmd = [sys.executable, here, "ref", str(ndev), str(tmp / f"ref_{ndev}.npz")]
        procs.append((f"reference {ndev} devices", cmd, env))
    running = [
        (name, subprocess.Popen(cmd, env=env, cwd=ROOT, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True))
        for name, cmd, env in procs
    ]  # fmt: skip
    failed = []
    for name, proc in running:
        try:
            text, _ = proc.communicate(timeout=TIMEOUT)
        except subprocess.TimeoutExpired:
            proc.kill()
            text, _ = proc.communicate()
            failed.append(f"{name}: timed out\n{text[-3000:]}")
            continue
        if proc.returncode != 0:
            failed.append(f"{name}: exit {proc.returncode}\n{text[-3000:]}")
    if failed:
        pytest.fail("\n\n".join(failed))
    port = {
        (nd, nm): [
            dict(np.load(tmp / f"port_{nd}x{nm}_{r}.npz")) for r in range(nd * nm)
        ]
        for nd, nm in MESHES
    }
    ref = {n: dict(np.load(tmp / f"ref_{n}.npz")) for n in (2, 4)}
    return port, ref


def _put_together(ranks, key, nd, nm, name):
    """A whole expert gradient from each rank's slice: experts over model,
    and under FSDP the ``d_model`` axis (1 of w1/w3, 2 of w2) over data."""
    k = key.rsplit("_", 1)[1]
    fsdp_dim = 2 if k == "w2" else 1
    rows = []
    for di in range(nd):
        blocks = [ranks[di * nm + mi][f"{name}/{key}"] for mi in range(nm)]
        rows.append(np.concatenate(blocks, 0))
    if rows[0].shape[fsdp_dim] == D_MODEL:  # no FSDP: every data rank whole
        for r in rows[1:]:
            np.testing.assert_array_equal(r, rows[0])
        return rows[0]
    return np.concatenate(rows, fsdp_dim)


def _close_to_scale(got, want, rtol, what):
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, (what, err, scale)


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"data{m[0]}_model{m[1]}")
def test_moe_apply_on_a_mesh_matches_the_reference(runs, mesh, name):
    """Every rank's ``y`` and ``aux`` within 1e-5 of the reference's and
    the branch the reference's rules pick; the x and router gradients
    (whole on each rank) and the experts' (put together) within 1e-5 of
    their scale; each shard's dropped pairs equal to the reference's
    routing of the same tokens (some at cf 1.25 in train, none at 16)."""
    port, ref = runs
    nd, nm = mesh
    ranks = port[mesh]
    want = ref[nd * nm]
    key = f"{nd}x{nm}/{name}"
    mode, cf, (b, _) = CASES[name]
    local = b % nd != 0
    for r, got in enumerate(ranks):
        for k in ("y", "aux"):
            np.testing.assert_allclose(
                got[f"{name}/{k}"], want[f"{key}/{k}"], atol=1e-5, rtol=0
            )
        assert str(got[f"{name}/path"]) == (
            "local" if local else ("all_to_all" if mode == "train" else "psum")
        ), (r, got[f"{name}/path"])
        # replicated gradients are whole on every rank
        for k in ("x", "router"):
            g, w = got[f"{name}/grad_{k}"], want[f"{key}/grad_{k}"]
            _close_to_scale(g, w, 1e-5, (r, k))
    drops = [int(got[f"{name}/dropped"]) for got in ranks]
    assert drops == want[f"{key}/dropped"].tolist()
    if name == "train_cf1.25":
        assert sum(drops) > 0, "no pair dropped at capacity factor 1.25"
    if cf == 16.0:
        assert sum(drops) == 0
    for k in ("w1", "w3", "w2"):
        got = _put_together(ranks, f"grad_{k}", nd, nm, name)
        _close_to_scale(got, want[f"{key}/grad_{k}"], 1e-5, k)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"data{m[0]}_model{m[1]}")
def test_each_rank_holds_its_share_of_the_experts(runs, mesh):
    """``E_loc / E`` of each expert leaf's bytes, and ``1 / n_data`` of
    that under FSDP (d_model 32 divides over data 2); an S the model
    axis does not divide raises on both sides."""
    port, ref = runs
    nd, nm = mesh
    for got in port[mesh]:
        for k in ("w1", "w3", "w2"):
            assert float(got[f"train_cf16/bytes_{k}"]) == 1 / (nm * nd)
        assert bool(got["odd_s_raises"])
    assert bool(ref[nd * nm][f"{nd}x{nm}/odd_s_raises"])


def test_model_loss_and_train_step_on_a_mesh_match_the_reference(runs):
    """qwen3-moe-smoke on ``{data 1, model 2}`` through ``Model(mesh=)``:
    the loss and router loss (1e-5 relative), every gradient within 1e-5
    of its scale (each leaf put together from both ranks' blocks by its
    ``leaf_pspec``, a leaf the model axis does not split the same on
    each), and after one ``train_step`` the grad norm (1e-5 relative) and
    every param within 1e-4 (``test_torch_lm_train``'s bound after its
    steps)."""
    from repro_torch.configs.base import get_config
    from repro_torch.models.sharding import param_specs

    port, ref = runs
    ranks, want = port[(1, 2)], ref[2]
    specs = param_specs(get_config(ARCH), {"data": 1, "model": 2})
    for got in ranks:
        for k in ("model/total", "model/aux", "model/step_grad_norm"):
            assert float(got[k]) == pytest.approx(float(want[k]), rel=1e-5), k

    def grad_paths(res):
        pre = "model/grad/"
        return sorted(k[len(pre) :] for k in res if k.startswith(pre))

    paths = grad_paths(want)
    assert paths == grad_paths(ranks[0])
    for path in paths:
        for prefix, check in (("model/grad/", "grad"), ("model/step/", "step")):
            split = [i for i, ax in enumerate(specs[path]) if ax == "model"]
            if split:  # each rank's block of the model axis, put together
                got = np.concatenate([r[prefix + path] for r in ranks], split[0])
            else:
                got = ranks[0][prefix + path]
                np.testing.assert_array_equal(ranks[1][prefix + path], got)
            if check == "grad":
                _close_to_scale(got, want[prefix + path], 1e-5, path)
            else:
                np.testing.assert_allclose(got, want[prefix + path], atol=1e-4, rtol=0)


def test_one_rank_mesh_is_bitwise_the_local_path():
    """chip_smoke's ``moe_ep`` on the CPU at smoke widths, one gloo rank:
    (a) ``Model(mesh=)`` keeps the params it was given and its prefill and
    decode logits are the mesh-less model's bit for bit; (b) the
    per-shard body forced into the all-to-all (train) and psum (decode)
    branches gives the local path's ``y`` and router loss bit for bit."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import one_rank_device_mesh
    from repro_torch.models import moe
    from repro_torch.models.model import Model
    from repro_torch.optim.adamw import tree_leaves

    with one_rank_device_mesh("cpu") as mesh:
        model, params, prompt = serve.setup(ARCH, 2, 16, 0, "cpu")
        want = serve.generate(model, params, prompt, 3)
        on_mesh = Model(model.cfg, "cpu", mesh=mesh)
        mine = on_mesh.shard(params)
        assert all(a is b for a, b in zip(tree_leaves(mine), tree_leaves(params)))
        got = serve.generate(on_mesh, mine, prompt, 3)
        assert torch.equal(got.tokens, want.tokens)
        assert torch.equal(got.logits, want.logits)

        cfg = get_config(ARCH)
        gen = torch.Generator().manual_seed(0)
        p = moe.moe_init(cfg, gen)
        w = [p["router"]] + [p[k] for k in moe.EXPERTS]
        groups = dict(model=mesh.get_group("model"), data=mesh.get_group("data"))
        for mode, t in (("train", 64), ("decode", 4)):
            x = torch.randn(t, cfg.d_model, generator=gen)
            y0, a0 = moe.moe_local(cfg, x, *w, seq_sharded=False)
            y1, a1 = moe.moe_local(cfg, x, *w, seq_sharded=mode == "train", **groups)
            assert torch.equal(y1, y0) and torch.equal(a1, a0), mode


if __name__ == "__main__":
    if sys.argv[1] == "port":
        nd, nm, rank = (int(a) for a in sys.argv[2:5])
        port_main(nd, nm, rank, sys.argv[5], sys.argv[6])
    else:
        ref_main(int(sys.argv[2]), sys.argv[3])
