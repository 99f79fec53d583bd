"""Per-layer rematerialisation (``ShardingPolicy.remat``) in the zoo's
train step, on the CPU.

Under ``remat`` (the default, as in the reference) ``models/model.py``'s
train-mode forward runs each group of layers inside one non-reentrant
checkpoint and each block inside another; the dense prefix and the final
norm stay outside.  Held here:

* the step with remat against the step without, bit for bit (loss, router
  loss and every gradient leaf; the state after two steps at
  ``microbatches=2``), on one reduced config of each block kind:
  danube (GQA, dense FFN), deepseek (MLA, MoE with a shared expert, the
  dense prefix), jamba (Mamba, MoE, a 3-block group), xlstm (mLSTM, sLSTM,
  blocks without an FFN) and qwen2-vl (M-RoPE positions ``[3, B, S]``);
* that the recompute ran: the norms of a step are a forward's plus each
  group's recompute (its blocks but the last: the checkpoint's early
  stop) and each block's own (:func:`norms_recomputed`), and prefill,
  decode and a forward without autograd checkpoint nothing;
* the port at ``ShardingPolicy()`` against the reference's rematerialised
  ``make_train_step`` (two steps from its converted init);
* a gloo world ``{data 2, model 2}`` (four processes, started once):
  danube with ``hoist_dense_gathers`` at ``microbatches=2`` and moonshot,
  whose experts are gathered over ``data`` inside the MoE layer, bit for
  bit without remat, and the all-gathers of a step up by exactly the
  forward gathers of the recomputed blocks;
* the planner: the activations a rematerialised step saves are the
  un-rematerialised parts' (embeddings' output into the final norm, the
  prefix, the loss) plus one ``[B, S, D]`` stream a group, less than
  without remat; ``recompute_bytes`` and ``--set remat=false``.

``python tests/test_torch_remat.py port ND NM RANK RDV OUT`` is one rank
of the gloo world.
"""

import dataclasses
import datetime
import os
import subprocess
import sys
from contextlib import contextmanager

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: these sizes gain nothing from more, and spinning
# OpenMP threads in parallel test workers would starve the other tests
torch.set_num_threads(1)

from repro_torch.configs.base import FFN_NONE, InputShape, get_config  # noqa: E402
from repro_torch.launch import analysis, dryrun  # noqa: E402
from repro_torch.launch.mesh import make_local_mesh  # noqa: E402
from repro_torch.launch.specs import opt_cfg_for  # noqa: E402
from repro_torch.models import blocks  # noqa: E402
from repro_torch.models import model as model_lib  # noqa: E402
from repro_torch.models.sharding import ShardingPolicy  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig, tree_leaves  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_lm_train import _batch, _state, ref  # noqa: E402,F401

ROOT = os.path.dirname(os.path.abspath(__file__)).rsplit(os.sep, 1)[0]
CONFIGS = (
    "h2o-danube-3-4b-smoke",
    "deepseek-v2-lite-16b-smoke",
    "jamba-1.5-large-398b-smoke",
    "xlstm-125m-smoke",
    "qwen2-vl-2b-smoke",
)
PLAIN, REMAT = ShardingPolicy(remat=False), ShardingPolicy()
# the gloo world's cases: (arch, (B, S), policy overrides)
MESH_CASES = {
    "danube_mb2_hoist": (
        "h2o-danube-3-4b-smoke", (8, 32), dict(microbatches=2, hoist_dense_gathers=True)
    ),
    "moonshot": ("moonshot-v1-16b-a3b-smoke", (4, 32), {}),
}
TIMEOUT = 240  # seconds for the world, import included


def norms_per_forward(cfg) -> int:
    """Norms of one forward: one a mixer, one an FFN, the final one."""
    return sum(1 + (ffn != FFN_NONE) for _, ffn in cfg.layer_pattern) + 1


def norms_recomputed(cfg) -> int:
    """Norms a rematerialised step adds to a forward's: each group's
    recompute runs its blocks but the last, then each block's its own."""
    per = [1 + (ffn != FFN_NONE) for _, ffn in cfg.pattern]
    return cfg.n_groups * (2 * sum(per) - per[-1])


def make_batch(cfg, b, s, seed):
    """Tokens (or embeds) and next-token labels from numpy, M-RoPE
    positions ``[3, B, S]`` with distinct t/h/w coordinates."""
    rng = np.random.default_rng(seed)
    toks = torch.tensor(rng.integers(0, cfg.vocab_size, (b, s + 1)), dtype=torch.int32)
    batch = {"labels": toks[:, 1:]}
    if cfg.input_kind == "embeds":
        emb = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
        batch["embeds"] = torch.from_numpy(emb)
    else:
        batch["tokens"] = toks[:, :-1]
    if cfg.rope == "mrope":
        hw = np.sort(rng.integers(0, s, (2, b, s)), axis=-1)
        t = np.broadcast_to(np.arange(s), (1, b, s))
        batch["positions"] = torch.tensor(np.concatenate([t, hw]), dtype=torch.int32)
    return batch


@contextmanager
def counted(module, name):
    """Calls of ``module.name`` inside the block, counted in a list."""
    calls = []
    real = getattr(module, name)

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    setattr(module, name, spy)
    try:
        yield calls
    finally:
        setattr(module, name, real)


@contextmanager
def counted_norms():
    """Every norm of the zoo's forward (the blocks' and the final one)."""
    with counted(blocks, "norm_apply") as a, counted(model_lib, "norm_apply") as b:
        yield lambda: len(a) + len(b)


def loss_and_grads(cfg, params, batch, policy):
    loss_fn = model_lib.make_loss_fn(cfg, policy=policy)
    with counted_norms() as norms:
        total, metrics, grads = model_lib.value_and_grad(loss_fn, params, batch)
    return total, metrics, tree_leaves(grads), norms()


@pytest.mark.parametrize("arch", CONFIGS)
def test_remat_is_bitwise_the_plain_step_and_recomputes(arch):
    cfg = get_config(arch)
    params = model_lib.Model(cfg, "cpu").init_params(0)
    batch = make_batch(cfg, 2, 32, seed=CONFIGS.index(arch))
    total0, m0, g0, n0 = loss_and_grads(cfg, params, batch, PLAIN)
    total1, m1, g1, n1 = loss_and_grads(cfg, params, batch, REMAT)
    assert torch.equal(total1, total0)
    for k in ("loss", "aux", "n_tokens"):
        assert torch.equal(m1[k], m0[k]), k
    assert len(g1) == len(g0)
    assert all(torch.equal(a, b) for a, b in zip(g1, g0, strict=True))
    assert n0 == norms_per_forward(cfg)
    assert n1 == n0 + norms_recomputed(cfg) > n0


def test_remat_train_steps_at_two_microbatches_are_bitwise():
    """Two steps of ``Model.train_step`` at ``microbatches=2`` (deepseek:
    the prefix, MLA, MoE): metrics and the state after, bit for bit; each
    step's norms twice a rematerialised forward's."""
    cfg = get_config("deepseek-v2-lite-16b-smoke")
    batches = [make_batch(cfg, 4, 32, seed=10 + i) for i in range(2)]
    runs = []
    for policy in (PLAIN, REMAT):
        two = dataclasses.replace(policy, microbatches=2)
        model = model_lib.Model(cfg, "cpu", policy=two)
        state = model.init_train_state(0)
        lines = []
        with counted_norms() as norms:
            for batch in batches:
                state, m = model.train_step(state, batch)
                lines.append({k: v.clone() for k, v in m.items()})
            runs.append((lines, tree_leaves(state), norms()))
    (l0, s0, n0), (l1, s1, n1) = runs
    for a, b in zip(l1, l0, strict=True):
        assert all(torch.equal(a[k], b[k]) for k in b), sorted(b)
    assert all(torch.equal(a, b) for a, b in zip(s1, s0, strict=True))
    assert n0 == 2 * 2 * norms_per_forward(cfg)
    assert n1 == n0 + 2 * 2 * norms_recomputed(cfg)


def test_only_the_train_forward_under_autograd_is_rematerialised():
    """Prefill, decode and a train-mode forward without autograd call no
    checkpoint; a train step calls one a group and one a block."""
    cfg = get_config("jamba-1.5-large-398b-smoke")
    model = model_lib.Model(cfg, "cpu")
    params = model.init_params(0)
    batch = make_batch(cfg, 2, 16, seed=3)
    with counted(model_lib, "checkpoint") as calls:
        with torch.no_grad():
            _, caches = model.prefill_step(params, {"tokens": batch["tokens"]})
            full = model.load_prefill(model.init_caches(2, 17), caches)
            step = {"tokens": batch["tokens"][:, :1], "pos": torch.full((2,), 16)}
            model.serve_step(params, full, step)
            model.loss_fn(params, batch)
        assert calls == []
        model_lib.value_and_grad(model.loss_fn, params, batch)
        s = batch["labels"].shape[1]
        xent_chunks = s // min(REMAT.loss_chunk, s)
        want = cfg.n_groups * (1 + len(cfg.pattern)) + xent_chunks
        # the group's recompute enters its blocks' checkpoints again and
        # stops inside the last one's, once its input is saved
        want += cfg.n_groups * len(cfg.pattern)
        assert len(calls) == want


def test_default_policy_rematerialises_as_the_reference(ref):  # noqa: F811
    """``ShardingPolicy()`` rematerialises on both sides; two steps of
    ``Model(cfg, "cpu").train_step`` against the reference's jitted
    ``make_train_step`` at its default policy from the reference's init:
    loss and grad norm 1e-5 relative, params 1e-4."""
    assert REMAT.remat is True and ref.policy().remat is True
    rcfg, rstate, state = _state(ref, "h2o-danube-3-4b", seed=3)
    cfg = get_config("h2o-danube-3-4b-smoke")
    rstep = ref.jax.jit(ref.model.make_train_step(rcfg, ref.adamw.AdamWConfig()))
    model = model_lib.Model(cfg, "cpu", opt_cfg=AdamWConfig())
    assert model.policy.remat
    rng = np.random.default_rng(11)
    for _ in range(2):
        toks, labels = _batch(rng, cfg.vocab_size, 4, 32)
        rbatch = {"tokens": ref.jnp.asarray(toks), "labels": ref.jnp.asarray(labels)}
        rstate, rm = rstep(rstate, rbatch)
        batch = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)}
        state, m = model.train_step(state, batch)
        for key in ("loss", "total", "grad_norm"):
            assert float(m[key]) == pytest.approx(float(rm[key]), rel=1e-5), key
    want = ref.jax.tree_util.tree_leaves(rstate["params"])
    got = tree_leaves(state["params"])
    assert len(got) == len(want)
    for g, w in zip(got, want, strict=True):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, rtol=0)


# -- the planner -------------------------------------------------------------------
@pytest.mark.parametrize("arch", CONFIGS[:3])  # danube, deepseek, jamba
def test_saved_bytes_at_remat_are_one_stream_a_group(arch):
    cfg = get_config(arch)
    opt = opt_cfg_for(cfg)
    b, s = 2, 64
    shape = InputShape("t", s, b, "train")
    _, saved = dryrun.plan_step(cfg, shape, REMAT, opt, group_shortcut=False)
    _, plain = dryrun.plan_step(cfg, shape, PLAIN, opt, group_shortcut=False)
    # the prefix, the final norm and the loss: the step without the groups
    bare = dataclasses.replace(cfg, n_layers=cfg.first_k_dense)
    _, outside = dryrun.plan_step(bare, shape, REMAT, opt)
    itemsize = torch.empty((), dtype=getattr(torch, cfg.dtype)).element_size()
    assert saved == outside + cfg.n_groups * b * s * cfg.d_model * itemsize
    assert saved < plain


def test_saved_bytes_count_a_checkpoints_inputs_once():
    """A checkpoint's inputs are saved through the hooks where it is
    called: an outer one's counted (a storage once, however many views),
    a nested one's and its region's not."""
    x = torch.ones(8, 16, requires_grad=True)

    def inner(t):
        return (t * 2).sin()

    def outer(t, view):
        return model_lib.checkpoint(inner, t.cos() + view, use_reentrant=False)

    with analysis.SavedBytes() as sb:
        y = x * 1.0
        model_lib.checkpoint(outer, y, y[:4].repeat(2, 1)[:, :], use_reentrant=False)
    assert sb.bytes == y.untyped_storage().nbytes() + 8 * 16 * 4


def test_recompute_bytes_and_remat_false_plans():
    cfg = get_config("jamba-1.5-large-398b-smoke")
    shape = InputShape("t", 64, 2, "train")
    mesh = make_local_mesh()
    on = dryrun.run_pair(cfg, shape, mesh=mesh, print_analyses=False)
    off = dryrun.run_pair(
        cfg, shape, mesh=mesh, print_analyses=False, policy_overrides={"remat": False}
    )
    m_on, m_off = on["memory_estimate"], off["memory_estimate"]
    assert m_off["recompute_bytes"] == 0.0
    stream = 2 * 64 * cfg.d_model * 4
    assert m_on["recompute_bytes"] > (len(cfg.pattern) - 1) * stream
    assert m_on["act_bytes"] < m_off["act_bytes"]
    assert m_on["total_bytes"] < m_off["total_bytes"]
    assert m_on["resident_bytes"] == m_off["resident_bytes"]
    assert dryrun.recompute_bytes(cfg, shape, PLAIN, opt_cfg_for(cfg)) == 0.0
    assert on["flops_global"] > off["flops_global"]  # the recompute's work


def test_dryrun_cli_takes_remat_false(tmp_path, capsys):
    argv = ["--arch", "h2o-danube-3-4b", "--shape", "train_4k", "--out", str(tmp_path)]
    assert dryrun.main(argv + ["--set", "remat=false"]) == 0
    assert "'recompute_bytes': 0.0" in capsys.readouterr().out


# -- the gloo world ----------------------------------------------------------------
def mesh_case(name, mesh) -> dict:
    """One case on this rank: the loss's gradients and one train step,
    without remat and with; the all-gathers of each step, and the forward
    gathers of each block call of the plain step (which the rematerialised
    step must issue again: each group's blocks but the last, then each
    block)."""
    from repro_torch.models import moe, spmd

    arch, (b, s), overrides = MESH_CASES[name]
    cfg = get_config(arch)
    batch = make_batch(cfg, b, s, seed=7)
    gathers = []
    real_gather = spmd._ALL_GATHER

    def gather(out, src, **kw):
        gathers.append(1)
        return real_gather(out, src, **kw)

    fsdp_experts = []
    real_local = moe.moe_local

    def local(cfg_, x_flat, router_w, w1, *a, **kw):
        fsdp_experts.append(w1.shape[1] != x_flat.shape[1])
        return real_local(cfg_, x_flat, router_w, w1, *a, **kw)

    per_block = []
    real_block = model_lib.block_apply

    def block(*a, path="", **kw):
        before = len(gathers)
        out = real_block(*a, path=path, **kw)
        if path.startswith("groups/"):
            per_block.append(len(gathers) - before)
        return out

    spmd._ALL_GATHER, moe.moe_local = gather, local
    res = {}
    try:
        runs = []
        for remat in (False, True):
            policy = ShardingPolicy(remat=remat, **overrides)
            model = model_lib.Model(cfg, "cpu", mesh=mesh, policy=policy)
            params = model.init_params(0)
            _, m, g = model_lib.value_and_grad(model.loss_fn, params, batch)
            state = model.init_train_state(0)
            del per_block[:]
            model_lib.block_apply = block if not remat else real_block
            n0 = len(gathers)
            state, sm = model.train_step(state, batch)
            model_lib.block_apply = real_block
            runs.append((m, tree_leaves(g), sm, tree_leaves(state), len(gathers) - n0))
            if not remat:
                forward_gathers = list(per_block)
        (m0, g0, sm0, st0, n_plain), (m1, g1, sm1, st1, n_remat) = runs
    finally:
        spmd._ALL_GATHER, moe.moe_local = real_gather, real_local
        model_lib.block_apply = real_block
    n = len(cfg.pattern)
    assert len(forward_gathers) % n == 0
    predicted = 0
    for i in range(0, len(forward_gathers), n):  # a group of one microbatch
        f = forward_gathers[i : i + n]
        predicted += sum(f) + sum(f[:-1])
    res["loss_fn_bitwise"] = all(torch.equal(m1[k], m0[k]) for k in m0) and all(
        torch.equal(a, c) for a, c in zip(g1, g0, strict=True)
    )
    res["step_bitwise"] = all(torch.equal(sm1[k], sm0[k]) for k in sm0) and all(
        torch.equal(a, c) for a, c in zip(st1, st0, strict=True)
    )
    res["gathers"] = np.array([n_plain, n_remat, predicted])
    res["fsdp_expert_gathers"] = np.int64(sum(fsdp_experts))
    return {f"{name}/{k}": v for k, v in res.items()}


def port_main(nd, nm, rank, rdv, out):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    dist.init_process_group(
        "gloo", init_method=f"file://{rdv}", rank=rank, world_size=nd * nm,
        timeout=datetime.timedelta(seconds=60),
    )  # fmt: skip
    mesh = init_device_mesh("cpu", (nd, nm), mesh_dim_names=("data", "model"))
    res = {}
    for name in MESH_CASES:
        res.update(mesh_case(name, mesh))
    np.savez(out, **res)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The four ranks of ``{data 2, model 2}``, started together and each
    waited for with a timeout; what each wrote."""
    tmp = tmp_path_factory.mktemp("remat_mesh")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(ROOT, "src")] + [p for p in [env.get("PYTHONPATH")] if p]
    )
    here = os.path.abspath(__file__)
    procs = []
    for r in range(4):
        args = ("port", 2, 2, r, tmp / "rdv", tmp / f"rank{r}.npz")
        procs.append(subprocess.Popen(
            [sys.executable, here, *map(str, args)], env=env, cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))  # fmt: skip
    failed = []
    for r, proc in enumerate(procs):
        try:
            text, _ = proc.communicate(timeout=TIMEOUT)
        except subprocess.TimeoutExpired:
            proc.kill()
            text, _ = proc.communicate()
            failed.append(f"rank {r}: timed out\n{text[-3000:]}")
            continue
        if proc.returncode != 0:
            failed.append(f"rank {r}: exit {proc.returncode}\n{text[-3000:]}")
    if failed:
        pytest.fail("\n\n".join(failed))
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(4)]


@pytest.mark.parametrize("name", sorted(MESH_CASES))
def test_mesh_remat_is_bitwise_and_gathers_again(world, name):
    for rank, res in enumerate(world):
        assert res[f"{name}/loss_fn_bitwise"], rank
        assert res[f"{name}/step_bitwise"], rank
        plain, remat, predicted = res[f"{name}/gathers"]
        assert predicted > 0, rank
        assert remat - plain == predicted, (rank, plain, remat, predicted)
        if name == "moonshot":  # the experts gathered over data in the layer
            assert res[f"{name}/fsdp_expert_gathers"] > 0, rank


if __name__ == "__main__":
    nd, nm, rank = (int(a) for a in sys.argv[2:5])
    port_main(nd, nm, rank, *sys.argv[5:7])
