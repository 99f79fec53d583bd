"""The H100 planner against the reference's analysis, on the CPU.

The port's FLOP counter (``launch/analysis.py::FlopCounter``, the port's
own step walked on ``meta`` tensors) against the reference's
``repro.launch.analysis.count_flops`` (its jaxpr walk) for every
assigned config's reduced variant, in training (``make_train_step``,
both at ``ShardingPolicy(remat=False)`` and both rematerialising per
layer at ``ShardingPolicy()``), prefill and decode, at batch 2 and 64 tokens:
the matrix-product FLOPs are identical and the totals within 3 % (the
elementwise counts differ where one side fuses what the other spells
out: a softmax, a SiLU, a backward formula).  In training the two
programs differ in two products, both the reference's work and not the
counter's rules, and the test adds them back from the shapes: the
reference checkpoints its attention's kv step inside the query chunk's
checkpoint, so its backward computes the scores ``Q K^T`` once more
(``2 B Hq S S d_qk`` an attention layer; the port checkpoints the
query chunk only), and its sLSTM scan computes the cotangent of the
zero initial hidden state (one ``[B, 4, H, dh] x [4, H, dh, dh]``
product an sLSTM layer), which the port's token loop skips.  Both are
products of a backward, and a backward runs once with or without the
rematerialisation: a rematerialised forward is recomputed by both
sides alike (the group's blocks but the last, then each block's own:
the port's early stop and JAX's dead-code elimination cut the same
last block), and neither term's product is in a forward, so each keeps
its count at ``remat=True``.  Also: the
group shortcut against the full walk, ``analytic_hbm_bytes`` against
the reference's, the collective model's arithmetic, and ``run_pair`` in
each mode.
"""

import dataclasses
import math
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: these sizes gain nothing from more, and spinning
# OpenMP threads in parallel test workers would starve the other tests
torch.set_num_threads(1)

from repro_torch.configs.base import (  # noqa: E402
    ASSIGNED,
    ATTN,
    MLA,
    SLSTM,
    InputShape,
    get_config,
)
from repro_torch.launch import analysis, dryrun  # noqa: E402
from repro_torch.launch.mesh import make_local_mesh, make_production_mesh  # noqa: E402
from repro_torch.launch.specs import opt_cfg_for  # noqa: E402
from repro_torch.models.sharding import ShardingPolicy  # noqa: E402

B, S = 2, 64
MODES = ("train", "prefill", "decode")
TOTAL_RTOL = 0.03


@pytest.fixture(scope="module")
def ref():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    import repro.core  # noqa: F401  (import order: see tests/test_torch_fleet.py)
    from repro.configs.base import get_config as ref_get_config
    from repro.launch import analysis as ref_analysis
    from repro.models import model as ref_model
    from repro.models.sharding import ShardingPolicy as RefPolicy
    from repro.optim.adamw import AdamWConfig

    return SimpleNamespace(
        jax=jax,
        jnp=jnp,
        get_config=ref_get_config,
        analysis=ref_analysis,
        model=ref_model,
        policy=RefPolicy,
        AdamWConfig=AdamWConfig,
    )


def ref_matmul(ref, jaxpr, mult: float = 1.0) -> float:
    """The reference's ``_jaxpr_flops`` restricted to ``dot_general`` and
    ``conv_general_dilated`` (its own rules for the two, its recursion)."""
    a = ref.analysis
    total = 0.0
    for eqn in jaxpr.eqns:
        prim = eqn.primitive.name
        if prim in ("dot_general", "conv_general_dilated"):
            total += mult * a._jaxpr_flops(SimpleNamespace(eqns=[eqn]))
        elif prim == "scan":
            body, length = eqn.params["jaxpr"].jaxpr, eqn.params["length"]
            total += ref_matmul(ref, body, mult * length)
        elif prim == "cond":
            total += max(ref_matmul(ref, b.jaxpr, mult) for b in eqn.params["branches"])
        else:
            for sub in a._sub_jaxprs(eqn.params):
                total += ref_matmul(ref, sub, mult)
    return total


def ref_step(ref, arch: str, mode: str, remat: bool = False):
    """(fn, abstract args) of the reference's step at batch B, S tokens."""
    cfg = ref.get_config(arch)
    jnp = ref.jnp
    policy = ref.policy(remat=remat)
    opt = ref.AdamWConfig(opt_dtype=opt_cfg_for(get_config(arch)).opt_dtype)
    key = ref.jax.random.PRNGKey(0)
    state = ref.jax.eval_shape(lambda: ref.model.init_train_state(cfg, key, opt))
    s = 1 if mode == "decode" else S
    batch = {}
    if cfg.input_kind == "embeds":
        dt = jnp.dtype(cfg.dtype)
        batch["embeds"] = ref.jax.ShapeDtypeStruct((B, s, cfg.d_model), dt)
    else:
        batch["tokens"] = ref.jax.ShapeDtypeStruct((B, s), jnp.int32)
    if mode == "train":
        batch["labels"] = ref.jax.ShapeDtypeStruct((B, s), jnp.int32)
        return ref.model.make_train_step(cfg, opt, policy=policy), (state, batch)
    if mode == "prefill":
        return ref.model.make_prefill_step(cfg, policy=policy), (state["params"], batch)
    batch["pos"] = ref.jax.ShapeDtypeStruct((B,), jnp.int32)
    caches = ref.jax.eval_shape(lambda: ref.model.init_caches(cfg, B, S))
    step = ref.model.make_serve_step(cfg, policy=policy)
    return step, (state["params"], caches, batch)


def scores_recompute(cfg) -> float:
    """The reference's extra ``Q K^T`` products in training: its nested
    checkpoint recomputes every (query chunk, kv chunk) block's scores in
    the kv step's backward, ``2 * B * Hq * S * S * d_qk`` an attention
    layer whatever the chunks (MLA's queries and keys are ``nope + rope``
    wide)."""
    total = 0.0
    for mixer, _ in cfg.layer_pattern:
        if mixer == ATTN:
            d_qk = cfg.resolved_head_dim
        elif mixer == MLA:
            d_qk = cfg.mla.nope_head_dim + cfg.mla.rope_head_dim
        else:
            continue
        total += 2.0 * B * cfg.n_heads * S * S * d_qk
    return total


def slstm_initial_cotangent(cfg) -> float:
    """The reference's product for the cotangent of each sLSTM layer's zero
    initial hidden state (``rec = einsum("bhd,ghde->bghe", hprev, r_h)``
    transposed to ``hprev``): ``2 * B * 4 * H * dh * dh``."""
    dh = cfg.d_model // cfg.n_heads
    n = sum(mixer == SLSTM for mixer, _ in cfg.layer_pattern)
    return n * 2.0 * B * 4 * cfg.n_heads * dh * dh


@pytest.mark.parametrize("arch", ASSIGNED)
def test_flops_match_reference(ref, arch):
    name = f"{arch}-smoke"
    cfg = get_config(name)
    for mode in MODES:
        fn, args = ref_step(ref, name, mode)
        jaxpr = ref.jax.make_jaxpr(fn)(*args).jaxpr
        want_total = ref.analysis._jaxpr_flops(jaxpr)
        want_mm = ref_matmul(ref, jaxpr)
        shape = InputShape(mode, S, B, mode)
        pol = ShardingPolicy(remat=False)
        kinds, _ = dryrun.plan_step(cfg, shape, pol, opt_cfg_for(cfg))
        check_counts(cfg, mode, kinds, want_mm, want_total)


def check_counts(cfg, mode, kinds, want_mm, want_total):
    got_mm = kinds.get("matmul", 0.0) + kinds.get("conv", 0.0)
    if mode == "train":
        got_mm += scores_recompute(cfg) + slstm_initial_cotangent(cfg)
    assert got_mm == want_mm, (mode, got_mm, want_mm)
    total = sum(kinds.values())
    assert total == pytest.approx(want_total, rel=TOTAL_RTOL), mode


@pytest.mark.parametrize("arch", ASSIGNED)
def test_train_flops_match_reference_rematerialised(ref, arch):
    """The train step at ``ShardingPolicy()`` on both sides: each group
    and each block checkpointed (prefill and decode do not read
    ``remat``).  The same two terms, at the same counts, close the
    products; the totals within 3 %."""
    name = f"{arch}-smoke"
    cfg = get_config(name)
    fn, args = ref_step(ref, name, "train", remat=True)
    jaxpr = ref.jax.make_jaxpr(fn)(*args).jaxpr
    want_total = ref.analysis._jaxpr_flops(jaxpr)
    want_mm = ref_matmul(ref, jaxpr)
    shape = InputShape("train", S, B, "train")
    kinds, _ = dryrun.plan_step(cfg, shape, ShardingPolicy(), opt_cfg_for(cfg))
    check_counts(cfg, "train", kinds, want_mm, want_total)
    plain, _ = dryrun.plan_step(
        cfg, shape, ShardingPolicy(remat=False), opt_cfg_for(cfg)
    )
    assert kinds["matmul"] > plain["matmul"]  # the recompute is counted


def test_the_two_product_differences_are_the_accounted_ones(ref):
    """Each accounted term alone is what separates the train counts of a
    config that has only it: xlstm (no attention) the sLSTM term, danube
    (no sLSTM) the scores' recompute."""
    for arch, term in (
        ("xlstm-125m-smoke", slstm_initial_cotangent),
        ("h2o-danube-3-4b-smoke", scores_recompute),
    ):
        cfg = get_config(arch)
        for remat in (False, True):
            fn, args = ref_step(ref, arch, "train", remat=remat)
            want = ref_matmul(ref, ref.jax.make_jaxpr(fn)(*args).jaxpr)
            shape = InputShape("t", S, B, "train")
            pol = ShardingPolicy(remat=remat)
            kinds, _ = dryrun.plan_step(cfg, shape, pol, opt_cfg_for(cfg))
            assert want - kinds["matmul"] == term(cfg) > 0, (arch, remat)


@pytest.mark.parametrize(
    "arch, n_layers",
    [
        ("h2o-danube-3-4b-smoke", 4),
        ("xlstm-125m-smoke", 6),
        ("moonshot-v1-16b-a3b-smoke", 4),
    ],
)
def test_group_shortcut_matches_the_full_walk(arch, n_layers):
    """Walking no group and one, times the groups, is the full walk: the
    products exactly, the totals but for the gradient norm's few scalar
    additions a parameter leaf (below 1e-7 of the whole), the saved
    activations exactly; training with and without ``remat``."""
    cfg = dataclasses.replace(get_config(arch), n_layers=n_layers)
    assert cfg.n_groups >= 2
    opt = opt_cfg_for(cfg)
    cases = [(m, ShardingPolicy()) for m in MODES]
    cases.append(("train", ShardingPolicy(remat=False)))
    for mode, pol in cases:
        shape = InputShape(mode, 32, 2, mode)
        full, saved_full = dryrun.plan_step(cfg, shape, pol, opt, group_shortcut=False)
        short, saved_short = dryrun.plan_step(cfg, shape, pol, opt)
        assert short["matmul"] == full["matmul"], mode
        assert sum(short.values()) == pytest.approx(sum(full.values()), rel=1e-7)
        assert saved_short == saved_full, mode
        if mode == "train":
            assert saved_full > 0


def test_analytic_hbm_bytes_is_the_reference(ref):
    cases = [
        dict(mode=m, param_bytes_dev=p, opt_bytes_dev=o, act_bytes_dev=a,
             cache_bytes_dev=c, io_bytes_dev=i)  # fmt: skip
        for m in MODES
        for p, o, a, c, i in ((1e9, 4e9, 3e8, 2e8, 1e6), (7.0, 0.0, 11.0, 13.0, 3.0))
    ]
    for kw in cases:
        want = ref.analysis.analytic_hbm_bytes(**kw)
        assert analysis.analytic_hbm_bytes(**kw) == want


def test_flop_counter_rules():
    """The reference's rules on single operations: a product 2 out k, a
    convolution 2 out k_spatial cin / groups (cin the weight's), its
    backward once a gradient, elementwise 1, transcendental 5, a
    reduction its input."""
    a, b = torch.ones(3, 5), torch.ones(5, 7)
    with analysis.FlopCounter() as fc:
        a @ b
        torch.exp(a)
        a + 1.0
        a.sum(0)
    assert dict(fc.by_kind) == {
        "matmul": 2.0 * 21 * 5,
        "transcendental": 5.0 * 15,
        "elementwise": 15.0,
        "reduction": 15.0,
    }
    x = torch.ones(2, 4, 9, 9, requires_grad=True)
    w = torch.ones(6, 2, 3, 3, requires_grad=True)
    with analysis.FlopCounter() as fc:
        y = torch.nn.functional.conv2d(x, w, groups=2)
        fwd = fc.by_kind["conv"]
        y.sum().backward()
    assert fwd == 2.0 * y.numel() * 9 * 2 / 2
    assert fc.by_kind["conv"] == 3 * fwd


def test_collective_model_arithmetic():
    """One FSDP leaf and the tensor-parallel boundaries, by hand."""
    mesh = {"data": 4, "model": 2}
    pol = ShardingPolicy()
    leaves = [(800.0, ("data", "model")), (100.0, (None,))]
    out = analysis.collective_bytes(
        mode="train", leaves=leaves, mesh_shape=mesh, policy=pol,
        act_bytes_per_boundary=64.0, n_boundaries=3,
    )  # fmt: skip
    held = 800.0 / 2  # after the gather over data: the model-axis shard
    assert out["all-gather"] == 2 * held * 3 / 4
    assert out["reduce-scatter"] == held * 3 / 4
    # the replicated leaf's gradient all-reduced over data, and the
    # boundaries' activations over model, two ways
    assert out["all-reduce"] == 2 * 100.0 * 3 / 4 + 2 * 64.0 * 1 / 2 * 3 * 2
    assert out["by_link"]["nvlink"] == 2 * 64.0 * 1 / 2 * 3 * 2
    assert math.isclose(out["total"], sum(out["by_link"].values()))
    local = analysis.collective_bytes(
        mode="train", leaves=leaves, mesh_shape=make_local_mesh(), policy=pol,
        act_bytes_per_boundary=64.0, n_boundaries=3,
    )  # fmt: skip
    assert local["total"] == 0.0


@pytest.mark.parametrize("mode", MODES)
def test_run_pair_each_mode(mode):
    arch = "qwen2-vl-2b-smoke"  # M-RoPE positions and embeds in
    shape = InputShape(f"smoke_{mode}", 64, 32, mode)
    local = dryrun.run_pair(arch, shape, mesh=make_local_mesh(), print_analyses=False)
    prod_mesh = make_production_mesh()
    prod = dryrun.run_pair(arch, shape, mesh=prod_mesh, print_analyses=False)
    for res in (local, prod):
        assert res["status"] == "ok" and res["shape"] == shape.name
        assert res["flops_global"] > 0 and res["useful_flops_ratio"] > 0
        terms = ("compute_s", "memory_s", "collective_s")
        assert res["roofline"]["bottleneck"] in terms
        mem = res["memory_estimate"]
        assert mem["fits"] and mem["params_bytes"] > 0
        assert (mem["act_bytes"] > 0) == (mode == "train")
        assert (mem["cache_bytes"] > 0) == (mode != "train")
    assert local["flops_global"] == prod["flops_global"]  # global, whatever the mesh
    assert local["collective_bytes_per_dev"]["total"] == 0.0
    assert prod["collective_bytes_per_dev"]["total"] > 0.0
    per_card = [r["memory_estimate"]["params_bytes"] for r in (prod, local)]
    assert per_card[0] < per_card[1]
    assert dryrun.run_pair("qwen2.5-14b", "long_500k")["status"] == "skipped"


def test_dryrun_cli_writes_one_result(tmp_path):
    out = tmp_path / "dr"
    argv = ["--arch", "xlstm-125m", "--shape", "decode_32k", "--out", str(out)]
    assert dryrun.main(argv) == 0
    (path,) = out.iterdir()
    assert path.name == "xlstm-125m__decode_32k__single.json"
    assert '"status": "ok"' in path.read_text()
