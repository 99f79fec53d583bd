"""The zoo's MoE, MLA, M-RoPE and embedding-input configs against the
reference on the CPU.

qwen3-moe-235b-a22b and moonshot-v1-16b-a3b (MoE; moonshot with shared
experts and an unrolled dense prefix layer), deepseek-v2-lite-16b (MLA,
MoE with shared experts, the dense prefix), qwen2-vl-2b (M-RoPE,
embeds in) and musicgen-medium (embeds in, LayerNorm, GELU, no rope) at
their reduced configs (2-3 layers, d_model 256, float32) take the same
inputs on both sides: the reference's params converted with
``zoo_params_from_numpy`` and numpy-seeded tokens or embeds.  The
pieces (M-RoPE's positions and bands exact, the MoE FFN and MLA at
1e-5) and the whole model (the teacher-forced forward, a prefill and 4
decode steps at the published capacity factor, 1e-4) agree; decode
reproduces the teacher-forced forward where no pair is dropped
(capacity factor 16).
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: these sizes gain nothing from more, and spinning
# OpenMP threads in parallel test workers would starve the other tests
torch.set_num_threads(1)

from zoo_config_fields import assert_reference_copy  # noqa: E402
from repro_torch.configs.base import (  # noqa: E402
    ASSIGNED,
    PORT_ONLY,
    get_config,
    list_configs,
    param_count,
)
from repro_torch.convert import (  # noqa: E402
    zoo_params_from_numpy,
    zoo_params_to_numpy,
    zoo_train_state_from_numpy,
)
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import attention, moe, rope  # noqa: E402
from repro_torch.models.blocks import block_init  # noqa: E402
from repro_torch.models.model import (  # noqa: E402
    forward,
    init_caches,
    init_params,
    logits_fn,
    make_prefill_step,
    make_serve_step,
)

ATOL = 1e-4  # float32 logits through 2-3 layers, two frameworks' sum orders
ARCHS = (
    "qwen3-moe-235b-a22b",
    "moonshot-v1-16b-a3b",
    "deepseek-v2-lite-16b",
    "qwen2-vl-2b",
    "musicgen-medium",
)


@pytest.fixture(scope="module")
def ref():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    import repro.core  # noqa: F401  (import order: see tests/test_torch_fleet.py)
    from repro.configs.base import get_config as ref_get_config
    from repro.configs.base import param_count as ref_param_count
    from repro.launch import serve as ref_serve
    from repro.models import attention as ref_attention
    from repro.models import model as ref_model
    from repro.models import moe as ref_moe
    from repro.models import rope as ref_rope

    return SimpleNamespace(
        jax=jax,
        jnp=jnp,
        get_config=ref_get_config,
        param_count=ref_param_count,
        serve=ref_serve,
        attention=ref_attention,
        model=ref_model,
        moe=ref_moe,
        rope=ref_rope,
    )


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _convert(ref, tree):
    return zoo_params_from_numpy(ref.jax.tree_util.tree_map(np.asarray, tree))


def _params(ref, arch, seed=0):
    rcfg = ref.get_config(arch + "-smoke")
    rparams = ref.model.init_params(rcfg, ref.jax.random.PRNGKey(seed))
    return rcfg, rparams, _convert(ref, rparams)


def _inputs(cfg, rng, b, s):
    """Token ids [B, S] int32, or embeds [B, S, D] float32 (numpy)."""
    if cfg.input_kind == "embeds":
        return rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    return rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def _key(cfg) -> str:
    return "embeds" if cfg.input_kind == "embeds" else "tokens"


# -- configs -----------------------------------------------------------------------
def test_configs_are_the_reference_copies(ref):
    assert set(ARCHS) <= set(list_configs())
    for arch in ARCHS:
        for name in (arch, arch + "-smoke"):
            got, want = get_config(name), ref.get_config(name)
            assert_reference_copy(got, want)
            assert param_count(got) == ref.param_count(want)
    assert param_count(get_config("deepseek-v2-lite-16b"))[0] == 15_709_372_416
    assert param_count(get_config("qwen3-moe-235b-a22b"))[0] == 235_092_836_352


def test_mamba_and_xlstm_configs_still_raise():
    """The port registers every assigned config and its own
    (``PORT_ONLY``): the Mamba and xLSTM ones and their smoke variants
    resolve (tests/test_torch_zoo_ssm.py holds them to the reference);
    only an unknown name raises."""
    assert list_configs() == sorted(ASSIGNED + PORT_ONLY)
    for name in ("jamba-1.5-large-398b", "xlstm-125m"):
        assert get_config(name).name == name
        assert get_config(name + "-smoke").name == name + "-smoke"
    with pytest.raises(KeyError, match="unknown"):
        get_config("mamba-2-780m")


# -- M-RoPE ------------------------------------------------------------------------
def test_mrope_positions_and_cos_sin_match_reference(ref, rng):
    """Positions exact; each frequency band rotated by its own coordinate
    exactly as standard RoPE rotates by that coordinate (bands split by
    ``mrope_sections`` in t, h, w order); cos/sin within 2 float32 ulps of
    the reference's (XLA's and torch's cos round differently)."""
    cfg, rcfg = get_config("qwen2-vl-2b-smoke"), ref.get_config("qwen2-vl-2b-smoke")
    got = rope.positions_for(cfg, 2, 9, offset=5)
    want = ref.rope.positions_for(rcfg, 2, 9, offset=5)
    assert got.shape == (3, 2, 9) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # distinct t/h/w coordinates, at full width and reduced
    pos3 = rng.integers(0, 5000, (3, 2, 7)).astype(np.int32)
    for c in (get_config("qwen2-vl-2b"), cfg):
        hd, theta, sec = c.resolved_head_dim, c.rope_theta, c.mrope_sections
        cos, sin = rope.mrope_cos_sin(torch.from_numpy(pos3), hd, theta, sec)
        assert cos.shape == (2, 7, hd // 2)
        bands = np.repeat(np.arange(3), sec)  # band -> coordinate
        for coord in range(3):
            c1, s1 = rope.rope_cos_sin(torch.from_numpy(pos3[coord]), hd, theta)
            cols = bands == coord
            assert torch.equal(cos[..., cols], c1[..., cols])
            assert torch.equal(sin[..., cols], s1[..., cols])
        cos_r, sin_r = ref.rope.mrope_cos_sin(ref.jnp.asarray(pos3), hd, theta, sec)
        np.testing.assert_allclose(cos.numpy(), np.asarray(cos_r), atol=2.5e-7, rtol=0)
        np.testing.assert_allclose(sin.numpy(), np.asarray(sin_r), atol=2.5e-7, rtol=0)
    with pytest.raises(ValueError, match="sections"):
        rope.mrope_cos_sin(torch.from_numpy(pos3), 64, 1e4, (8, 8, 8))


# -- the MoE FFN -------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "deepseek-v2-lite-16b"])
def test_moe_apply_matches_reference_with_drops(ref, rng, arch):
    """At the published capacity factor 1.25, with (deepseek) and without
    (qwen3) shared experts: output and router loss at 1e-5, the dispatch
    slots exact, and some pairs dropped."""
    cfg, rcfg = get_config(arch + "-smoke"), ref.get_config(arch + "-smoke")
    rp = ref.moe.moe_init(ref.jax.random.PRNGKey(4), rcfg)
    p = _convert(ref, rp)
    assert ("shared" in p) == bool(cfg.moe.n_shared_experts)
    x = rng.standard_normal((2, 24, cfg.d_model)).astype(np.float32)
    y_ref, aux_ref = ref.moe.moe_apply(rcfg, rp, ref.jnp.asarray(x))
    y, aux = moe.moe_apply(cfg, p, torch.from_numpy(x))
    np.testing.assert_allclose(_np(y), _np(y_ref), atol=1e-5, rtol=0)
    assert float(aux) == pytest.approx(float(aux_ref), rel=1e-5, abs=1e-6)
    assert aux.dtype == torch.float32

    xf = torch.from_numpy(x.reshape(-1, cfg.d_model))
    cap = moe.capacity(cfg, xf.shape[0])
    _, eidx, _ = moe._route(cfg, p["router"], xf)
    e_flat, slot, keep = moe._dispatch_indices(eidx, cfg.moe.n_experts, cap)
    _, r_slot, r_keep = ref.moe._dispatch_indices(
        ref.jnp.asarray(eidx.numpy()), cfg.moe.n_experts, cap
    )
    np.testing.assert_array_equal(slot.numpy(), np.asarray(r_slot))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(r_keep))
    assert not bool(keep.all()), "no pair dropped at capacity factor 1.25"


def test_moe_capacity_is_the_reference_formula():
    cfg = get_config("qwen3-moe-235b-a22b")
    assert moe.capacity(cfg, 4000) == 313  # ceil(8 * 4000 * 1.25 / 128)
    assert moe.capacity(cfg, 4) == 1
    cfg16 = dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=16.0)
    )
    assert moe.capacity(cfg16, 4) == 4  # every pair fits: 16 >= E / top_k


# -- MLA ---------------------------------------------------------------------------
def test_mla_expanded_and_absorbed_paths_match_reference(ref, rng):
    """A prefill of 20 tokens (expanded: per-head k/v through
    chunked_attention), then 3 decode steps (absorbed: the latent space)
    against the handed-over latent cache."""
    arch = "deepseek-v2-lite-16b-smoke"
    cfg, rcfg = get_config(arch), ref.get_config(arch)
    rp = ref.attention.mla_init(ref.jax.random.PRNGKey(5), rcfg)
    p = _convert(ref, rp)
    b, s, steps = 2, 20, 3
    x = rng.standard_normal((b, s + steps, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s + steps, dtype=np.int32), (b, s + steps))
    y_ref, c_ref = ref.attention.mla_apply(
        rcfg, rp, ref.jnp.asarray(x[:, :s]), mode="prefill",
        positions=ref.jnp.asarray(pos[:, :s]),
    )
    y, c = attention.mla_apply(
        cfg, p, torch.from_numpy(x[:, :s]), mode="prefill",
        positions=torch.from_numpy(pos[:, :s].copy()),
    )
    np.testing.assert_allclose(_np(y), _np(y_ref), atol=1e-5, rtol=0)
    assert sorted(c) == sorted(c_ref) == ["ckv", "kpos", "krope"]
    for key in c:
        np.testing.assert_allclose(_np(c[key]), _np(c_ref[key]), atol=1e-5, rtol=0)

    cache_ref = ref.attention.mla_cache_init(rcfg, b, s + steps, ref.jnp.float32)
    cache_ref = ref.jax.tree_util.tree_map(
        lambda d, q: d.at[:, :s].set(q), cache_ref, c_ref
    )
    cache = attention.mla_cache_init(cfg, b, s + steps, torch.float32, "cpu")
    for key in cache:
        cache[key][:, :s] = c[key]
    for i in range(s, s + steps):
        y_ref, cache_ref = ref.attention.mla_apply(
            rcfg, rp, ref.jnp.asarray(x[:, i : i + 1]), mode="decode",
            positions=ref.jnp.asarray(pos[:, i : i + 1]), cache=cache_ref,
        )
        y, cache = attention.mla_apply(
            cfg, p, torch.from_numpy(x[:, i : i + 1]), mode="decode",
            positions=torch.from_numpy(pos[:, i : i + 1].copy()), cache=cache,
        )
        np.testing.assert_allclose(_np(y), _np(y_ref), atol=1e-5, rtol=0)
    assert cache["kpos"][:, s + steps - 1].tolist() == [s + steps - 1] * b


def test_gqa_takes_mrope_positions(ref, rng):
    """One qwen2-vl attention layer with distinct t/h/w coordinates: the
    prefill, its cache (``kpos`` from the t coordinate) and a decode step
    at positions [3, B, 1]."""
    cfg, rcfg = get_config("qwen2-vl-2b-smoke"), ref.get_config("qwen2-vl-2b-smoke")
    rp = ref.attention.gqa_init(ref.jax.random.PRNGKey(6), rcfg)
    p = _convert(ref, rp)
    b, s = 2, 16
    x = rng.standard_normal((b, s + 1, cfg.d_model)).astype(np.float32)
    pos3 = np.sort(rng.integers(0, 40, (3, b, s + 1)), axis=-1).astype(np.int32)
    pos3[0] = np.arange(s + 1)  # t: the cache order
    y_ref, c_ref = ref.attention.gqa_apply(
        rcfg, rp, ref.jnp.asarray(x[:, :s]), mode="prefill",
        positions=ref.jnp.asarray(pos3[:, :, :s]),
    )
    y, c = attention.gqa_apply(
        cfg, p, torch.from_numpy(x[:, :s]), mode="prefill",
        positions=torch.from_numpy(pos3[:, :, :s].copy()),
    )
    np.testing.assert_allclose(_np(y), _np(y_ref), atol=1e-5, rtol=0)
    for key in ("k", "v", "kpos"):
        np.testing.assert_allclose(_np(c[key]), _np(c_ref[key]), atol=1e-5, rtol=0)
    cache_ref = ref.attention.gqa_cache_init(rcfg, b, s + 1, ref.jnp.float32)
    cache_ref = ref.jax.tree_util.tree_map(
        lambda d, q: d.at[:, :s].set(q), cache_ref, c_ref
    )
    cache = attention.gqa_cache_init(cfg, b, s + 1, torch.float32, "cpu")
    for key in cache:
        cache[key][:, :s] = c[key]
    y_ref, _ = ref.attention.gqa_apply(
        rcfg, rp, ref.jnp.asarray(x[:, s:]), mode="decode",
        positions=ref.jnp.asarray(pos3[:, :, s:]), cache=cache_ref,
    )
    y, _ = attention.gqa_apply(
        cfg, p, torch.from_numpy(x[:, s:]), mode="decode",
        positions=torch.from_numpy(pos3[:, :, s:].copy()), cache=cache,
    )
    np.testing.assert_allclose(_np(y), _np(y_ref), atol=1e-5, rtol=0)


# -- the model ---------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(ref, rng, arch):
    """The teacher-forced forward over 40 tokens at the published capacity
    factor: logits at 1e-4, the summed router loss at 1e-5."""
    rcfg, rparams, params = _params(ref, arch)
    cfg = get_config(arch + "-smoke")
    inputs = _inputs(cfg, rng, 2, 40)
    pos = rope.positions_for(cfg, 2, 40)
    h_ref, aux_ref, _ = ref.model.forward(
        rcfg, rparams, ref.jnp.asarray(inputs), ref.jnp.asarray(pos.numpy()),
        mode="train",
    )
    want = ref.model.logits_fn(rcfg, rparams, h_ref)
    h, aux, caches = forward(cfg, params, torch.from_numpy(inputs), pos, mode="train")
    assert caches is None
    np.testing.assert_allclose(
        _np(logits_fn(cfg, params, h)), _np(want), atol=ATOL, rtol=0
    )
    assert float(aux) == pytest.approx(float(aux_ref), rel=1e-5, abs=1e-6)
    assert (float(aux) > 0) == bool(cfg.moe.n_experts)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(ref, rng, arch):
    """A prefill of 40 tokens (or embeds), then 4 decode steps fed the same
    inputs on both sides, at the published capacity factor."""
    rcfg, rparams, params = _params(ref, arch, seed=1)
    cfg = get_config(arch + "-smoke")
    b, s, steps = 2, 40, 4
    inputs = _inputs(cfg, rng, b, s + steps)
    key = _key(cfg)
    last_ref, pre_ref = ref.model.make_prefill_step(rcfg)(
        rparams, {key: ref.jnp.asarray(inputs[:, :s])}
    )
    caches_ref = ref.serve._load_prefill(
        rcfg, ref.model.init_caches(rcfg, b, s + steps), pre_ref, s
    )
    last, pre = make_prefill_step(cfg)(params, {key: torch.from_numpy(inputs[:, :s])})
    np.testing.assert_allclose(_np(last), _np(last_ref), atol=ATOL, rtol=0)
    caches = serve.load_prefill(init_caches(cfg, b, s + steps, "cpu"), pre)
    assert ("prefix" in caches) == bool(cfg.first_k_dense)
    step_ref, step = ref.model.make_serve_step(rcfg), make_serve_step(cfg)
    for i in range(steps):
        x = inputs[:, s + i : s + i + 1]
        pos = np.full((b,), s + i, np.int32)
        batch_ref = {key: ref.jnp.asarray(x), "pos": ref.jnp.asarray(pos)}
        lg_ref, caches_ref = step_ref(rparams, caches_ref, batch_ref)
        batch = {key: torch.from_numpy(x), "pos": torch.from_numpy(pos)}
        lg, caches = step(params, caches, batch)
        np.testing.assert_allclose(_np(lg), _np(lg_ref), atol=ATOL, rtol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_teacher_forcing_without_drops(rng, arch):
    """Token-by-token decode from empty caches reproduces the teacher-forced
    forward (as tests/test_models.py holds the reference).  MoE runs at
    capacity factor 16, where no pair is dropped: at 1.25 the forward's
    T = 12 tokens drop differently from decode's T = 1."""
    cfg = get_config(arch + "-smoke")
    if cfg.moe.n_experts:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=16.0)
        )
    params = init_params(cfg, torch.Generator().manual_seed(1))
    s, key = 12, _key(cfg)
    inputs = torch.from_numpy(_inputs(cfg, rng, 1, s))
    pos = rope.positions_for(cfg, 1, s)
    full = logits_fn(cfg, params, forward(cfg, params, inputs, pos, mode="train")[0])
    step, caches = make_serve_step(cfg), init_caches(cfg, 1, s + 1, "cpu")
    for t in range(s):
        batch = {key: inputs[:, t : t + 1], "pos": torch.tensor([t], dtype=torch.int32)}
        lg, caches = step(params, caches, batch)
        np.testing.assert_allclose(_np(lg), _np(full[:, t]), atol=ATOL, rtol=0)


def test_prefix_params_and_caches_are_the_reference_layout(ref):
    """deepseek's unrolled dense prefix: ``prefix/l0`` (attention and a
    dense FFN of ``first_k_dense_d_ff``) beside the stacked MLA/MoE groups,
    with the reference's leaf names and shapes; the caches alike."""
    arch = "deepseek-v2-lite-16b-smoke"
    cfg = get_config(arch)
    rparams = ref.model.init_params(ref.get_config(arch), ref.jax.random.PRNGKey(0))
    got = init_params(cfg, torch.Generator().manual_seed(0))
    want = ref.jax.tree_util.tree_map(np.asarray, rparams)

    def shapes(tree):
        if isinstance(tree, dict):
            return {k: shapes(v) for k, v in tree.items()}
        return (tuple(tree.shape), str(tree.dtype).removeprefix("torch."))

    assert shapes(got) == shapes(want)
    assert got["groups"]["b0"]["ffn"]["router"].dtype == torch.float32
    caches = init_caches(cfg, 2, 10, "cpu")
    want_c = ref.model.init_caches(ref.get_config(arch), 2, 10)
    assert shapes(caches) == shapes(ref.jax.tree_util.tree_map(np.asarray, want_c))
    assert sorted(caches["groups"]["b0"]) == ["ckv", "kpos", "krope"]
    # a prefix layer is the dense block at the prefix's width
    one = block_init(cfg, "attn", "dense", torch.Generator().manual_seed(0), 512)
    assert shapes(one) == shapes(got["prefix"]["l0"])


def test_convert_carries_the_prefix_and_mixed_dtypes(ref):
    """deepseek's bf16 tree (float32 routers and norms beside bf16 experts,
    MLA and the ``prefix`` subtree) and its train state cross into the
    port leaf for leaf, dtypes kept, and back bit for bit."""
    rcfg = dataclasses.replace(
        ref.get_config("deepseek-v2-lite-16b-smoke"), dtype="bfloat16"
    )
    opt = ref.model.AdamWConfig()
    rstate = ref.model.init_train_state(rcfg, ref.jax.random.PRNGKey(0), opt)
    tree = ref.jax.tree_util.tree_map(np.asarray, rstate)
    state = zoo_train_state_from_numpy(tree)
    params = state["params"]
    assert params["groups"]["b0"]["ffn"]["router"].dtype == torch.float32
    assert params["groups"]["b0"]["ffn"]["w1"].dtype == torch.bfloat16
    assert params["groups"]["b0"]["mixer"]["w_dkv"]["w"].dtype == torch.bfloat16
    assert params["prefix"]["l0"]["ffn"]["wi"]["w"].dtype == torch.bfloat16
    assert state["opt"]["m"]["groups"]["b0"]["ffn"]["w1"].dtype == torch.float32
    back = zoo_params_to_numpy(params)
    want = ref.jax.tree_util.tree_leaves(tree["params"])
    got = ref.jax.tree_util.tree_leaves(back)
    assert len(got) == len(want)
    for g, w in zip(got, want, strict=True):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()


def test_serve_driver_greedy_ids_match_reference_on_embeds(ref):
    """The whole driver on qwen2-vl-2b (M-RoPE, embeds in): the reference's
    numpy prompt embeds, zero embeds at each decode step, identical greedy
    ids for every request."""
    arch = "qwen2-vl-2b"
    rcfg, rparams, params = _params(ref, arch, seed=2)
    cfg = get_config(arch + "-smoke")
    b, s, gen, seed = 2, 24, 6, 5
    emb = serve.prompt_embeds(cfg.d_model, b, s, seed)
    want_emb = np.random.default_rng(seed).standard_normal((b, s, cfg.d_model))
    np.testing.assert_array_equal(emb, want_emb.astype(np.float32))

    prefill = ref.jax.jit(ref.model.make_prefill_step(rcfg))
    step = ref.jax.jit(ref.model.make_serve_step(rcfg))
    last, pre = prefill(rparams, {"embeds": ref.jnp.asarray(emb)})
    caches = ref.serve._load_prefill(
        rcfg, ref.model.init_caches(rcfg, b, s + gen), pre, s
    )
    tok = ref.jnp.argmax(last, -1).astype(ref.jnp.int32)[:, None]
    want = [np.asarray(tok)]
    zeros = ref.jnp.zeros((b, 1, cfg.d_model), ref.jnp.float32)
    for i in range(gen):
        batch = {"pos": ref.jnp.full((b,), s + i, ref.jnp.int32), "embeds": zeros}
        lg, caches = step(rparams, caches, batch)
        tok = ref.jnp.argmax(lg, -1).astype(ref.jnp.int32)[:, None]
        want.append(np.asarray(tok))

    from repro_torch.models.model import Model

    out = serve.generate(Model(cfg, "cpu"), params, torch.from_numpy(emb), gen)
    np.testing.assert_array_equal(out.tokens.numpy(), np.concatenate(want, 1))
