"""The zoo on ``torch.distributed`` ``(data, model)`` meshes against the
reference's jitted meshed steps on the CPU.

The port runs one ``gloo`` process per rank (``init_device_mesh("cpu",
(n_data, n_model))``) through ``Model(mesh=)``: each rank holds its
``leaf_pspec`` block of every parameter and of AdamW's moments, the
stream batch-sharded over ``data`` and sequence-sharded over ``model``,
tensor-parallel attention and FFNs, the vocab-parallel embedding and
cross entropy.  The reference runs ``make_loss_fn``, ``make_train_step``,
``make_prefill_step`` and ``make_serve_step`` with ``mesh=`` under
``jax.jit`` on a ``jax.sharding.Mesh`` of four forced host devices, one
subprocess a case (the device count only takes effect before JAX
starts).  Both take the same numpy-seeded params (every leaf, biases
non-zero), tokens or embeds and positions, in float32.

The cases, at ``{data 2, model 2}``: danube-smoke; starcoder2-smoke
(LayerNorm, biases, the GELU MLP's row-parallel bias); moonshot-smoke (a
dense prefix layer, MoE with a shared expert, the sequence-sharded stream
into the experts); danube-smoke at ``microbatches=2`` with
``hoist_dense_gathers``; danube-smoke under the dryrun's ``dp_over_model``
(FSDP over data, whole over model, the batch over both).  At ``{data 1,
model 4}``: qwen2-vl-2b-smoke (embeds, M-RoPE ``[3, B, S]``, 2 kv heads
for 4 q heads over model 4), danube-smoke at ``S = 18`` (the stream not
sequence-sharded) and musicgen-medium-smoke cut to 2 heads (attention
whole on each rank between the sequence gather and its block).  Held: the loss, aux and grad norm of 3 steps
(1e-5 relative), each rank's block of every gradient against the same
block of the reference's (1e-5 of the leaf's scale), the params after 3
steps (1e-4), the prefill's last logits and 4 decode steps' logits
(1e-4), each rank's parameter and AdamW bytes equal to the planner's
``bytes_per_device``, and its cache bytes to ``cache_specs``' (qwen2-vl's
2 kv heads do not divide over model 4: its kv cache is held in sequence
blocks, read by the split-K combine, each block the reference's).

Also: a one-rank gloo mesh runs the whole sharded body (every collective
over groups of one) bit for bit the mesh-less step; ``launch.train``'s
meshed body at ``{2, 2}`` prints the one-process run's lines and its
``--ckpt`` holds the whole params; ``--production-mesh`` refuses a world
that is not 256 ranks.  ``python tests/test_torch_zoo_mesh.py port|ref
...`` are the two sides' entry points.  The configs with MLA and recurrent
mixers are held on this file's harness in
``tests/test_torch_mixers_mesh.py`` (against the reference) and
``tests/test_torch_zoo_mesh_whole.py`` (against the one-process model).
"""

import datetime
import io
import os
import re
import subprocess
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: these sizes gain nothing from more, and spinning
# OpenMP threads in parallel test workers would starve the other tests
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.abspath(__file__)).rsplit(os.sep, 1)[0]
# name: (arch, (n_data, n_model), (B, S), policy overrides)
DP = dict(batch_axes=("data", "model"), tensor_parallel=False, seq_shard=False)
CASES = {
    "danube": ("h2o-danube-3-4b-smoke", (2, 2), (4, 32), {}),
    "starcoder2": ("starcoder2-15b-smoke", (2, 2), (4, 32), {}),
    "moonshot": ("moonshot-v1-16b-a3b-smoke", (2, 2), (4, 32), {}),
    "danube_mb2_hoist": (
        "h2o-danube-3-4b-smoke", (2, 2), (8, 32),
        dict(microbatches=2, hoist_dense_gathers=True),
    ),
    "danube_dp_over_model": ("h2o-danube-3-4b-smoke", (2, 2), (4, 32), DP),
    "qwen2vl": ("qwen2-vl-2b-smoke", (1, 4), (4, 32), {}),
    "danube_s18": ("h2o-danube-3-4b-smoke", (1, 4), (4, 18), {}),
    "musicgen_2heads": ("musicgen-medium-smoke", (1, 4), (4, 32), {}),
}  # fmt: skip
# The configs with MLA and recurrent mixers, split as the planner plans
# them, held to the mesh-less model on {data 2, model 2} by
# tests/test_torch_zoo_mesh_whole.py: at capacity factor 16 no pair drops
# and without the router loss the experts' per-shard capacity and aux
# mean change no number, so the port's own one-process run is the
# reference.
WHOLE_MIXERS = {
    "deepseek": ("deepseek-v2-lite-16b-smoke", (2, 2), (4, 32), {}),
    "jamba": ("jamba-1.5-large-398b-smoke", (2, 2), (4, 32), {}),
    "xlstm": ("xlstm-125m-smoke", (2, 2), (4, 32), {}),
}
# The same configs with their own MoE settings against the reference's
# meshed steps (tests/test_torch_mixers_mesh.py); deepseek_37: a decode
# cache of 37 slots, which do not divide over model 4, so the latent
# cache stays whole over model (the prefill's 32 are split); the 2-head
# cases (CFG_OVERRIDES): MLA whole on each rank over a latent cache in
# sequence blocks, and mLSTM's cell and sLSTM's recurrence whole between
# channel-split projections and a split sLSTM FFN (d_model 192: d_inner
# 384 and the FFN's 256 divide over model 4, 2 heads do not).
MIXER_CASES = {
    "deepseek_22": ("deepseek-v2-lite-16b-smoke", (2, 2), (4, 32), {}),
    "jamba_22": ("jamba-1.5-large-398b-smoke", (2, 2), (4, 32), {}),
    "xlstm_22": ("xlstm-125m-smoke", (2, 2), (4, 32), {}),
    "deepseek_14": ("deepseek-v2-lite-16b-smoke", (1, 4), (4, 32), {}),
    "jamba_14": ("jamba-1.5-large-398b-smoke", (1, 4), (4, 32), {}),
    "xlstm_14": ("xlstm-125m-smoke", (1, 4), (4, 32), {}),
    "deepseek_37": ("deepseek-v2-lite-16b-smoke", (1, 4), (4, 32), {}),
    "deepseek_2heads": ("deepseek-v2-lite-16b-smoke", (1, 4), (4, 32), {}),
    "xlstm_2heads": ("xlstm-125m-smoke", (1, 4), (4, 32), {}),
}
EXTRA_SLOTS = {"deepseek_37": 1}  # decode cache slots past S + DECODE
NO_DROPS = dict(capacity_factor=16.0, router_aux_weight=0.0)
# config changes: 2 heads do not divide over model 4, so the attention
# runs whole on each rank between the sequence gather and its block
CFG_OVERRIDES = {
    "musicgen_2heads": dict(n_heads=2, n_kv_heads=2),
    "deepseek_2heads": dict(n_heads=2, n_kv_heads=2),
    "xlstm_2heads": dict(d_model=192, n_heads=2, n_kv_heads=2),
}
MESHES = sorted({mesh for _, mesh, _, _ in CASES.values()})
STEPS, DECODE = 3, 4
# the cache leaves compared after decoding: attention caches and states
CACHE_LEAVES = ("k", "v", "ckv", "krope", "conv", "ssm", "c", "n", "m", "h")
TRAIN_ARGS = ["--arch", "h2o-danube-3-4b-smoke", "--steps", "2", "--batch", "4",
              "--seq", "32", "--device", "cpu"]  # fmt: skip
TIMEOUT = 420  # seconds for a world or a reference run, import included


# -- inputs, made the same way on both sides -------------------------------------
def flatten(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flatten(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tree}


def nest(flat: dict) -> dict:
    out: dict = {}
    for path, v in flat.items():
        node = out
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return out


def _seed(name) -> int:
    first = sorted({**CASES, **WHOLE_MIXERS})
    if name in first:
        return first.index(name)
    return 50 + sorted(MIXER_CASES).index(name)


def case_params(name, shapes: dict) -> dict:
    """Every leaf from numpy, by path in sorted order: norm scales near 1,
    vectors (biases, norm biases) 0.1 normals, matrices fan-in scaled."""
    rng = np.random.default_rng(_seed(name))
    out = {}
    for path in sorted(shapes):
        shape = shapes[path]
        core = shape[1:] if path.startswith("groups/") else shape
        if path.endswith("scale"):
            v = 1.0 + 0.1 * rng.standard_normal(shape)
        elif len(core) == 1:
            v = 0.1 * rng.standard_normal(shape)
        else:
            v = rng.standard_normal(shape) * core[-2] ** -0.5
        out[path] = v.astype(np.float32)
    return out


def case_batch(name, cfg):
    """``(train batch, prefill batch, decode batches)`` as numpy: tokens or
    embeds, labels, M-RoPE positions ``[3, B, S]`` with distinct
    coordinates, and per decode step its token (or embeds) and position."""
    _, _, (b, s), _ = _case(name)
    rng = np.random.default_rng(100 + _seed(name))
    v = cfg.vocab_size
    toks = rng.integers(0, v, (b, s + 1)).astype(np.int32)
    train = {"labels": toks[:, 1:]}
    if cfg.input_kind == "embeds":
        train["embeds"] = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    else:
        train["tokens"] = toks[:, :-1].copy()
    if cfg.rope == "mrope":
        t = np.arange(s, dtype=np.int32)
        pos3 = np.stack([t, t // 2, t % 4])[:, None, :]
        train["positions"] = np.broadcast_to(pos3, (3, b, s)).copy()
    prefill = {k: x for k, x in train.items() if k != "labels"}
    steps = []
    for i in range(DECODE):
        step = {"pos": np.full((b,), s + i, np.int32)}
        if cfg.input_kind == "embeds":
            step["embeds"] = rng.standard_normal((b, 1, cfg.d_model)).astype(
                np.float32
            )
        else:
            step["tokens"] = rng.integers(0, v, (b, 1)).astype(np.int32)
        steps.append(step)
    return train, prefill, steps


def _case(name):
    return {**CASES, **WHOLE_MIXERS, **MIXER_CASES}[name]


def cache_slots(name) -> int:
    """The decode caches' length: the prompt, the decode steps and any
    extra slots."""
    _, _, (_, s), _ = _case(name)
    return s + DECODE + EXTRA_SLOTS.get(name, 0)


def case_policy(policy_cls, name):
    *_, overrides = _case(name)
    return policy_cls(**overrides)


def case_config(get_config, name):
    import dataclasses

    cfg = get_config(_case(name)[0])
    if name in WHOLE_MIXERS:
        return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **NO_DROPS))
    return dataclasses.replace(cfg, **CFG_OVERRIDES.get(name, {}))


# -- the port's side: one process a rank -----------------------------------------
def run_case(name, mesh) -> dict:
    """One case through ``Model(mesh=)`` (``mesh`` None: the one-process
    model): the loss's gradients, 3 train steps, the whole params after,
    the prefill's last logits and 4 decode steps' logits, the attention
    caches after decoding, and (on a mesh) the rank's state and cache
    bytes beside the planner's."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch.specs import bytes_per_device, cache_specs, state_specs
    from repro_torch.models.model import Model, meta_params, value_and_grad
    from repro_torch.models.sharding import ShardingPolicy, mesh_axes

    cfg = case_config(get_config, name)
    policy = case_policy(ShardingPolicy, name)
    model = Model(cfg, "cpu", mesh=mesh, policy=policy)
    shapes = {k: tuple(v.shape) for k, v in flatten(meta_params(cfg)).items()}
    flat = case_params(name, shapes)

    def fresh():  # the steps update params in place: a new copy each time
        return model.shard(nest({k: torch.tensor(v) for k, v in flat.items()}))

    res = {}
    params = fresh()
    train_np, prefill_np, steps_np = case_batch(name, cfg)
    batch = {k: torch.from_numpy(v) for k, v in train_np.items()}
    _, metrics, grads = value_and_grad(model.loss_fn, params, batch)
    for k in ("loss", "aux", "n_tokens"):
        res[f"{name}/loss_fn/{k}"] = metrics[k].numpy()
    for k, g in flatten(grads).items():
        res[f"{name}/grad/{k}"] = g.numpy()
    state = model.init_train_state(0)
    if mesh is not None:
        res[f"{name}/bytes"] = np.float64(
            sum(t.numel() * t.element_size() for t in flatten(state).values())
        )
        res[f"{name}/planned_bytes"] = np.float64(
            bytes_per_device(
                state_specs(cfg, mesh_axes(mesh), policy, model.opt_cfg),
                mesh_axes(mesh),
            )
        )
    state = {"params": fresh(), "opt": state["opt"]}
    for i in range(STEPS):
        state, metrics = model.train_step(state, batch)
        for k in ("loss", "aux", "grad_norm", "total"):
            res[f"{name}/step{i}/{k}"] = metrics[k].numpy()
    for k, v in flatten(model.gather(state["params"])).items():
        res[f"{name}/params/{k}"] = v.numpy()
    with torch.no_grad():
        b, s = train_np["labels"].shape
        pre = {k: torch.from_numpy(v) for k, v in prefill_np.items()}
        last, pre_caches = model.prefill_step(params, pre)
        res[f"{name}/logits/prefill"] = last.numpy()
        slots = cache_slots(name)
        caches = model.init_caches(b, slots)
        if mesh is not None:
            axes = mesh_axes(mesh)
            res[f"{name}/cache_bytes"] = np.float64(
                sum(t.numel() * t.element_size() for t in flatten(caches).values())
            )
            res[f"{name}/planned_cache_bytes"] = np.float64(
                bytes_per_device(cache_specs(cfg, b, slots, axes, policy), axes)
            )
        caches = model.load_prefill(caches, pre_caches)
        for i, step in enumerate(steps_np):
            step = {k: torch.from_numpy(v) for k, v in step.items()}
            logits, caches = model.serve_step(params, caches, step)
            res[f"{name}/logits/decode{i}"] = logits.numpy()
        for k, v in flatten(caches).items():
            if k.rsplit("/", 1)[-1] in CACHE_LEAVES:
                res[f"{name}/cache/{k}"] = v.numpy()
    return res


def join_mesh(nd, nm, rank, rdv):
    """Join a gloo world of ``nd * nm`` through the file ``rdv`` (a
    minute's timeout) and build its ``(data, model)`` mesh."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo",
        init_method=f"file://{rdv}",
        rank=rank,
        world_size=nd * nm,
        timeout=datetime.timedelta(seconds=60),
    )
    return init_device_mesh("cpu", (nd, nm), mesh_dim_names=("data", "model"))


def port_main(nd, nm, rank, rdv, out, ckpt):
    import torch.distributed as dist

    from repro_torch.launch import train

    mesh = join_mesh(nd, nm, rank, rdv)
    res = {}
    for name, (_, shape, _, _) in CASES.items():
        if shape == (nd, nm):
            res.update(run_case(name, mesh))
    if (nd, nm) == (2, 2):  # launch.train's meshed body
        args = train._parser().parse_args(TRAIN_ARGS + ["--ckpt", ckpt])
        text = io.StringIO()
        with redirect_stdout(text):
            train.train_on_mesh(args, mesh)
        res["train/stdout"] = np.array(text.getvalue())
    np.savez(out, **res)
    dist.destroy_process_group()


# -- the reference's side: one process a case ------------------------------------
def ref_main(name, out):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    import repro.core  # noqa: F401  (the reference's own import order)
    from repro.configs.base import get_config
    from repro.launch.serve import _load_prefill
    from repro.models.model import (
        init_caches,
        init_params,
        make_loss_fn,
        make_prefill_step,
        make_serve_step,
        make_train_step,
    )
    from repro.models.sharding import ShardingPolicy
    from repro.optim.adamw import AdamWConfig, adamw_init

    _, (nd, nm), (b, s), _ = _case(name)
    mesh = Mesh(np.array(jax.devices()[: nd * nm]).reshape(nd, nm), ("data", "model"))
    cfg = case_config(get_config, name)
    policy = case_policy(ShardingPolicy, name)
    shape_tree = jax.eval_shape(lambda k: init_params(cfg, k), jax.random.PRNGKey(0))
    shapes = {k: tuple(v.shape) for k, v in flatten(shape_tree).items()}
    params = jax.tree_util.tree_map(jnp.asarray, nest(case_params(name, shapes)))
    train_np, prefill_np, steps_np = case_batch(name, cfg)
    batch = {k: jnp.asarray(v) for k, v in train_np.items()}
    res = {}
    loss_fn = make_loss_fn(cfg, mesh=mesh, policy=policy)
    (_, metrics), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params, batch
    )
    for k in ("loss", "aux", "n_tokens"):
        res[f"{name}/loss_fn/{k}"] = np.asarray(metrics[k])
    for k, g in flatten(grads).items():
        res[f"{name}/grad/{k}"] = np.asarray(g)
    opt_cfg = AdamWConfig()
    step = jax.jit(make_train_step(cfg, opt_cfg, mesh=mesh, policy=policy))
    state = {"params": params, "opt": adamw_init(opt_cfg, params)}
    for i in range(STEPS):
        state, metrics = step(state, batch)
        for k in ("loss", "aux", "grad_norm", "total"):
            res[f"{name}/step{i}/{k}"] = np.asarray(metrics[k])
    for k, v in flatten(state["params"]).items():
        res[f"{name}/params/{k}"] = np.asarray(v)
    prefill = jax.jit(make_prefill_step(cfg, mesh=mesh, policy=policy))
    last, pre_caches = prefill(params, {k: jnp.asarray(v) for k, v in prefill_np.items()})
    res[f"{name}/logits/prefill"] = np.asarray(last)
    caches = _load_prefill(cfg, init_caches(cfg, b, cache_slots(name)), pre_caches, s)
    serve = jax.jit(make_serve_step(cfg, mesh=mesh, policy=policy))
    for i, st in enumerate(steps_np):
        logits, caches = serve(params, caches, {k: jnp.asarray(v) for k, v in st.items()})
        res[f"{name}/logits/decode{i}"] = np.asarray(logits)
    for k, v in flatten(caches).items():
        if k.rsplit("/", 1)[-1] in CACHE_LEAVES:
            res[f"{name}/cache/{k}"] = np.asarray(v)
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


def run_all(procs) -> None:
    """Start every ``(name, argv, env)`` together, wait for each with a
    timeout, and fail the test with the output of any that timed out or
    exited non-zero."""
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


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Start both worlds and every reference run, wait for all (each with
    a timeout), and load what each wrote: ``port[(nd, nm)][rank]``,
    ``ref[name]``, and the path of the meshed ``--ckpt``."""
    pytest.importorskip("jax")
    tmp = tmp_path_factory.mktemp("zoo_mesh")
    here = os.path.abspath(__file__)
    ckpt = tmp / "mesh_ckpt.npz"
    procs = []
    for nd, nm in MESHES:
        rdv = tmp / f"rdv_{nd}x{nm}"
        for r in range(nd * nm):
            out = tmp / f"port_{nd}x{nm}_{r}.npz"
            args = ("port", nd, nm, r, rdv, out, ckpt)
            cmd = [sys.executable, here, *map(str, args)]
            procs.append((f"port {nd}x{nm} rank {r}", cmd, _env()))
    flags = "--xla_force_host_platform_device_count=4"
    env = _env({"XLA_FLAGS": flags, "JAX_PLATFORMS": "cpu"})
    for name in CASES:
        cmd = [sys.executable, here, "ref", name, str(tmp / f"ref_{name}.npz")]
        procs.append((f"reference {name}", cmd, env))
    run_all(procs)
    port = {
        (nd, nm): [
            dict(np.load(tmp / f"port_{nd}x{nm}_{r}.npz")) for r in range(nd * nm)
        ]
        for nd, nm in MESHES
    }
    ref = {name: dict(np.load(tmp / f"ref_{name}.npz")) for name in CASES}
    return port, ref, ckpt


def check_cache_blocks(port, ref, name):
    """Each rank's caches after decoding (kv and latent caches, recurrent
    states) are its blocks of the reference's under ``cache_pspec`` (1e-4
    of the leaf's scale): a leaf held in sequence blocks has the rank's
    slots only, a state the rank's channels or heads.  Returns the
    leaves' specs."""
    from repro_torch.configs.base import get_config
    from repro_torch.models.sharding import ShardingPolicy, stored_cache_specs

    _, (nd, nm), (b, _), _ = _case(name)
    mesh_shape = {"data": nd, "model": nm}
    cfg = case_config(get_config, name)
    specs = stored_cache_specs(
        cfg, b, cache_slots(name), mesh_shape, case_policy(ShardingPolicy, name)
    )
    keys = sorted(k for k in ref if k.startswith(f"{name}/cache/"))
    assert keys
    for r, got in enumerate(port[(nd, nm)]):
        coord = {"data": r // nm, "model": r % nm}
        assert keys == sorted(k for k in got if k.startswith(f"{name}/cache/"))
        for k in keys:
            spec = specs[k[len(f"{name}/cache/") :]]
            block = _block(ref[k], spec, coord, mesh_shape)
            assert got[k].shape == block.shape, (r, k, got[k].shape, block.shape)
            _close_to_scale(got[k], block, 1e-4, (r, k))
    return {k[len(f"{name}/cache/") :]: specs[k[len(f"{name}/cache/") :]] for k in keys}


def _spec_of(name, path, mesh_shape):
    from repro_torch.configs.base import get_config
    from repro_torch.models.sharding import ShardingPolicy, param_specs

    cfg = case_config(get_config, name)
    return param_specs(cfg, mesh_shape, case_policy(ShardingPolicy, name))[path]


def _block(whole, spec, coord, mesh_shape):
    """The block of ``whole`` a rank at ``coord`` ({axis: index}) holds."""
    for dim, ax in enumerate(spec):
        names = (ax,) if isinstance(ax, str) else tuple(ax or ())
        if not names:
            continue
        idx, n = 0, 1
        for a in names:
            idx, n = idx * mesh_shape[a] + coord[a], n * mesh_shape[a]
        size = whole.shape[dim] // n
        whole = np.take(whole, np.arange(idx * size, (idx + 1) * size), axis=dim)
    return whole


def _close_to_scale(got, want, rtol, what):
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, (what, err, scale)


@pytest.mark.parametrize("name", list(CASES))
def test_meshed_steps_match_the_reference(runs, name):
    """Every rank: the loss, aux and grad norm of the loss and of 3 train
    steps (1e-5 relative); its block of every gradient against the
    reference's block (1e-5 of the leaf's scale; the blocks put together
    are the whole gradient, and every replicated copy is checked); the
    whole params after the steps (1e-4); the prefill's last logits and 4
    decode steps' logits (1e-4)."""
    port, ref, _ = runs
    _match(port, ref[name], name)


def _match(port, want, name, metrics=("loss", "aux", "n_tokens")):
    _, (nd, nm), _, _ = _case(name)
    mesh_shape = {"data": nd, "model": nm}
    grads = sorted(k for k in want if k.startswith(f"{name}/grad/"))
    step_metrics = [k for k in ("loss", "aux", "grad_norm", "total") if k in metrics
                    or k in ("grad_norm", "total")]  # fmt: skip
    for r, got in enumerate(port[(nd, nm)]):
        coord = {"data": r // nm, "model": r % nm}
        keys = [f"{name}/loss_fn/{k}" for k in metrics]
        keys += [f"{name}/step{i}/{k}" for i in range(STEPS) for k in step_metrics]
        for k in keys:
            assert float(got[k]) == pytest.approx(float(want[k]), rel=1e-5, abs=1e-7), (
                r, k
            )
        assert grads == sorted(k for k in got if k.startswith(f"{name}/grad/"))
        for k in grads:
            spec = _spec_of(name, k[len(f"{name}/grad/") :], mesh_shape)
            block = _block(want[k], spec, coord, mesh_shape)
            _close_to_scale(got[k], block, 1e-5, (r, k))
        for k in (k for k in want if k.startswith(f"{name}/params/")):
            np.testing.assert_allclose(got[k], want[k], atol=1e-4, rtol=0, err_msg=k)
        for k in (k for k in want if k.startswith(f"{name}/logits/")):
            np.testing.assert_allclose(got[k], want[k], atol=1e-4, rtol=0, err_msg=k)


def test_qwen2vl_kv_cache_is_held_in_sequence_blocks(runs):
    """qwen2-vl-2b-smoke's 2 kv heads do not divide over model 4, so its
    kv caches are split along the sequence (``cache_pspec``): each rank
    holds a quarter of the 36 slots, its cache bytes equal the planner's
    ``cache_specs``, and after prefill and 4 decode steps its blocks are
    the reference's."""
    port, ref, _ = runs
    specs = check_cache_blocks(port, ref["qwen2vl"], "qwen2vl")
    assert all(spec[2] == "model" for path, spec in specs.items()
               if path.rsplit("/", 1)[-1] in ("k", "v"))  # fmt: skip
    for got in port[(1, 4)]:
        assert float(got["qwen2vl/cache_bytes"]) == float(
            got["qwen2vl/planned_cache_bytes"]
        )
        assert got["qwen2vl/cache/groups/b0/k"].shape[2] == (32 + DECODE) // 4


@pytest.mark.parametrize("name", list(CASES))
def test_each_rank_holds_the_planned_bytes(runs, name):
    """Each rank's parameter and AdamW bytes (its blocks of the params and
    moments, and the count) equal ``launch/specs.py::bytes_per_device``
    of ``state_specs`` at the mesh's shape, and are below the whole
    state's (the layout splits something)."""
    port, _, _ = runs
    _, mesh, _, _ = CASES[name]
    for got in port[mesh]:
        assert float(got[f"{name}/bytes"]) == float(got[f"{name}/planned_bytes"])
    from repro_torch.configs.base import get_config
    from repro_torch.launch.specs import bytes_per_device, state_specs
    from repro_torch.models.sharding import ShardingPolicy
    from repro_torch.optim.adamw import AdamWConfig

    cfg = case_config(get_config, name)
    whole = bytes_per_device(
        state_specs(cfg, None, case_policy(ShardingPolicy, name), AdamWConfig()), None
    )
    assert float(port[mesh][0][f"{name}/bytes"]) < whole


def test_launch_train_on_a_mesh_prints_the_one_process_lines(runs, tmp_path):
    """``launch.train``'s meshed body on ``{data 2, model 2}`` prints the
    one-process run's ``step i loss= gnorm=`` lines (4 and 3 decimals)
    and its parameter count; its ``--ckpt`` holds the whole params, within
    1e-4 of the one-process run's."""
    from repro_torch.launch import train

    port, _, ckpt = runs
    text = str(port[(2, 2)][0]["train/stdout"])
    for other in port[(2, 2)][1:]:
        assert str(other["train/stdout"]) == ""  # only rank 0 prints
    one = tmp_path / "one.npz"
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert train.main(TRAIN_ARGS + ["--ckpt", str(one)]) == 0
    steps = re.compile(r"^(step .*|.*M params.*)$", re.M)
    assert steps.findall(text) == steps.findall(buf.getvalue())
    assert len(steps.findall(text)) == 3
    assert re.search(r"rank 0 holds [0-9.]+ GB of params", text)
    whole, got = dict(np.load(one)), dict(np.load(ckpt))
    assert sorted(whole) == sorted(got)
    for k in whole:
        assert np.shape(got[k]) == np.shape(whole[k]), k
        np.testing.assert_allclose(got[k], whole[k], atol=1e-4, rtol=0, err_msg=k)


def test_production_mesh_refuses_another_world(monkeypatch):
    """``--production-mesh`` needs the 256 ranks of ``{data 32, model 8}``;
    a world of one (no ``WORLD_SIZE``) or of 8 is refused, naming it."""
    from repro_torch.launch import train

    for world in (None, "8"):
        if world is None:
            monkeypatch.delenv("WORLD_SIZE", raising=False)
        else:
            monkeypatch.setenv("WORLD_SIZE", world)
        with pytest.raises(SystemExit, match="256 ranks"):
            train.main(["--arch", "h2o-danube-3-4b-smoke", "--production-mesh"])


@pytest.mark.parametrize(
    "arch,overrides",
    [
        ("h2o-danube-3-4b-smoke", {}),
        ("starcoder2-15b-smoke", dict(microbatches=2, hoist_dense_gathers=True)),
        ("qwen2-vl-2b-smoke", {}),
    ],
)
def test_one_rank_mesh_runs_the_sharded_body_bitwise(arch, overrides):
    """On a one-rank gloo mesh every collective of the sharded body is
    issued over groups of one (each FSDP gather a copy); 3 train steps
    and a prefill then give the mesh-less model's losses, grad norms,
    params and logits bit for bit."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch.mesh import one_rank_device_mesh
    from repro_torch.models import spmd
    from repro_torch.models.model import Model
    from repro_torch.models.sharding import ShardingPolicy
    from repro_torch.optim.adamw import tree_leaves

    cfg = get_config(arch)
    policy = ShardingPolicy(**overrides)
    train_np, _, _ = case_batch("danube", cfg)
    batch = {k: torch.from_numpy(v) for k, v in train_np.items()}
    prefill = {k: v for k, v in batch.items() if k != "labels"}

    def run(mesh):
        model = Model(cfg, "cpu", mesh=mesh, policy=policy)
        state = model.init_train_state(0)
        lines = []
        for _ in range(STEPS):
            state, m = model.train_step(state, batch)
            lines.append((m["loss"].item(), m["grad_norm"].item(), m["total"].item()))
        with torch.no_grad():
            last = model.prefill_step(state["params"], prefill)[0]
        return lines, tree_leaves(state["params"]), last

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
    assert torch.equal(got[2], want[2])
    assert gathers  # the sharded body ran: its gathers were issued


if __name__ == "__main__":
    if sys.argv[1] == "port":
        nd, nm, rank = (int(a) for a in sys.argv[2:5])
        port_main(nd, nm, rank, *sys.argv[5:8])
    else:
        ref_main(sys.argv[2], sys.argv[3])
