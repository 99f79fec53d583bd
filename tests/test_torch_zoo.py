"""The model zoo's serving slice against the reference on the CPU.

Config, RoPE, GQA prefill and decode, ``forward``, the prefill and serve
steps and the whole greedy serve driver of a reduced h2o-danube-3-4b
(2 layers, d_model 256, 4 query heads on 2 kv heads, float32) take the
same inputs on both sides: the reference's params converted with
``zoo_params_from_numpy`` and numpy-seeded tokens.  Float32 logits agree
within 1e-4; the greedy ids are identical.

The sliding-window tests pin where the port differs from the reference
on purpose: a prompt longer than the window and no multiple of it.
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
from repro_torch.configs.base import get_config, param_count  # noqa: E402
from repro_torch.convert import zoo_params_from_numpy  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.rmsnorm import rmsnorm  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import attention, rope  # noqa: E402
from repro_torch.models.model import (  # noqa: E402
    Model,
    forward,
    init_caches,
    init_params,
    logits_fn,
    make_prefill_step,
    make_serve_step,
)

ARCH = "h2o-danube-3-4b"
ATOL = 1e-4  # float32 logits through 2 layers, two frameworks' sum orders


@pytest.fixture(scope="module")
def ref():
    """The reference zoo (the tests that compare against it skip where JAX
    is missing)."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    import repro.core  # noqa: F401  (import order: see tests/test_torch_fleet.py)
    from repro.configs.base import get_config as ref_get_config
    from repro.configs.base import param_count as ref_param_count
    from repro.launch import serve as ref_serve
    from repro.models import attention as ref_attention
    from repro.models import model as ref_model
    from repro.models import rope as ref_rope

    return SimpleNamespace(
        jax=jax,
        jnp=jnp,
        get_config=ref_get_config,
        param_count=ref_param_count,
        serve=ref_serve,
        attention=ref_attention,
        model=ref_model,
        rope=ref_rope,
    )


def _cfgs(ref, **kw):
    """The reduced danube with 2 kv heads (GQA 2:1), in both packages."""
    kw = {"n_kv_heads": 2, **kw}
    port = dataclasses.replace(get_config(ARCH).reduced(), **kw)
    return port, dataclasses.replace(ref.get_config(ARCH).reduced(), **kw)


def _params(ref, rcfg, seed=0):
    """Reference init -> (reference params, the same as port params)."""
    rparams = ref.model.init_params(rcfg, ref.jax.random.PRNGKey(seed))
    tree = ref.jax.tree_util.tree_map(np.asarray, rparams)
    return rparams, zoo_params_from_numpy(tree)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


# -- configs -----------------------------------------------------------------------
def test_config_is_the_reference_copy(ref):
    for name in (ARCH, ARCH + "-smoke"):
        got, want = get_config(name), ref.get_config(name)
        assert_reference_copy(got, want)
        assert param_count(got) == ref.param_count(want)
    assert param_count(get_config(ARCH))[0] == 3_961_651_200  # 3.96 B


def test_unported_configs_raise_and_say_so():
    """Every assigned config is ported (jamba included); an unknown name
    raises and says so."""
    assert get_config("jamba-1.5-large-398b").family == "hybrid"
    with pytest.raises(KeyError, match="unknown"):
        get_config("no-such-model")


# -- rope and attention ----------------------------------------------------------
def test_apply_rope_matches_reference(ref, rng):
    port_cfg, ref_cfg = _cfgs(ref)
    x = rng.standard_normal((2, 24, 4, 64)).astype(np.float32)
    pos = (np.arange(24)[None] + np.array([[0], [1000]])).astype(np.int32)
    want = ref.rope.apply_rope(
        ref.jnp.asarray(x), *ref.rope.cos_sin_for(ref_cfg, ref.jnp.asarray(pos))
    )
    cs = rope.cos_sin_for(port_cfg, torch.from_numpy(pos))
    got = rope.apply_rope(torch.from_numpy(x), *cs)
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-5, rtol=0)


def test_gqa_prefill_and_decode_match_reference(ref, rng):
    """One attention layer: a prefill of 40 tokens, then one decode step
    against the handed-over cache (prompt inside the window)."""
    port_cfg, ref_cfg = _cfgs(ref)
    rp = ref.attention.gqa_init(ref.jax.random.PRNGKey(3), ref_cfg)
    tp = zoo_params_from_numpy(ref.jax.tree_util.tree_map(np.asarray, rp))
    b, s = 2, 40
    x = rng.standard_normal((b, s + 1, port_cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s + 1, dtype=np.int32), (b, s + 1))
    y_ref, c_ref = ref.attention.gqa_apply(
        ref_cfg, rp, ref.jnp.asarray(x[:, :s]), mode="prefill",
        positions=ref.jnp.asarray(pos[:, :s]),
    )
    before = flash_attention.launches
    y, c = attention.gqa_apply(
        port_cfg, tp, torch.from_numpy(x[:, :s]), mode="prefill",
        positions=torch.from_numpy(pos[:, :s].copy()),
    )
    assert flash_attention.launches == before  # CPU: plain version
    np.testing.assert_allclose(_np(y), _np(y_ref), atol=1e-5, rtol=0)
    for key in ("k", "v", "kpos"):
        np.testing.assert_allclose(_np(c[key]), _np(c_ref[key]), atol=1e-5, rtol=0)

    # decode position s against a cache of s + 1 slots holding the prefill
    cache_ref = ref.attention.gqa_cache_init(ref_cfg, b, s + 1, ref.jnp.float32)
    cache_ref = ref.jax.tree_util.tree_map(
        lambda d, p: d.at[:, :s].set(p), cache_ref, c_ref
    )
    cache = attention.gqa_cache_init(port_cfg, b, s + 1, torch.float32, "cpu")
    for key in cache:
        cache[key][:, :s] = c[key]
    y_ref, _ = ref.attention.gqa_apply(
        ref_cfg, rp, ref.jnp.asarray(x[:, s:]), mode="decode",
        positions=ref.jnp.asarray(pos[:, s:]), cache=cache_ref,
    )
    y, _ = attention.gqa_apply(
        port_cfg, tp, torch.from_numpy(x[:, s:]), mode="decode",
        positions=torch.from_numpy(pos[:, s:].copy()), cache=cache,
    )
    np.testing.assert_allclose(_np(y), _np(y_ref), atol=1e-5, rtol=0)
    assert cache["kpos"][:, s].tolist() == [s] * b  # written in place


# -- the model ---------------------------------------------------------------------
def test_forward_matches_reference(ref, rng):
    """Teacher-forced forward over 96 tokens, past the 64-token window."""
    port_cfg, ref_cfg = _cfgs(ref)
    rparams, params = _params(ref, ref_cfg)
    toks = rng.integers(0, port_cfg.vocab_size, (2, 96)).astype(np.int32)
    pos = np.broadcast_to(np.arange(96, dtype=np.int32), (2, 96))
    h_ref, _, _ = ref.model.forward(
        ref_cfg, rparams, ref.jnp.asarray(toks), ref.jnp.asarray(pos), mode="train"
    )
    want = ref.model.logits_fn(ref_cfg, rparams, h_ref)
    before = rmsnorm.launches
    h, _, caches = forward(
        port_cfg, params, torch.from_numpy(toks), torch.from_numpy(pos.copy()),
        mode="train",
    )
    assert rmsnorm.launches == before and caches is None
    np.testing.assert_allclose(
        _np(logits_fn(port_cfg, params, h)), _np(want), atol=ATOL, rtol=0
    )


def test_prefill_and_serve_steps_match_reference(ref, rng):
    """Prefill 48 tokens, then 6 decode steps fed the same tokens on both
    sides: the last-token logits and every step's logits agree."""
    port_cfg, ref_cfg = _cfgs(ref)
    rparams, params = _params(ref, ref_cfg, seed=1)
    b, s, steps = 2, 48, 6
    toks = rng.integers(0, port_cfg.vocab_size, (b, s + steps)).astype(np.int32)

    last_ref, pre_ref = ref.model.make_prefill_step(ref_cfg)(
        rparams, {"tokens": ref.jnp.asarray(toks[:, :s])}
    )
    caches_ref = ref.serve._load_prefill(
        ref_cfg, ref.model.init_caches(ref_cfg, b, s + steps), pre_ref, s
    )
    prefill = make_prefill_step(port_cfg)
    last, pre = prefill(params, {"tokens": torch.from_numpy(toks[:, :s])})
    np.testing.assert_allclose(_np(last), _np(last_ref), atol=ATOL, rtol=0)
    caches = serve.load_prefill(init_caches(port_cfg, b, s + steps, "cpu"), pre)

    step_ref = ref.jax.jit(ref.model.make_serve_step(ref_cfg))
    step = make_serve_step(port_cfg)
    for i in range(steps):
        tok = toks[:, s + i : s + i + 1]
        pos = np.full((b,), s + i, np.int32)
        batch_ref = {"tokens": ref.jnp.asarray(tok), "pos": ref.jnp.asarray(pos)}
        lg_ref, caches_ref = step_ref(rparams, caches_ref, batch_ref)
        batch = {"tokens": torch.from_numpy(tok), "pos": torch.from_numpy(pos)}
        lg, caches = step(params, caches, batch)
        np.testing.assert_allclose(_np(lg), _np(lg_ref), atol=ATOL, rtol=0)


def test_serve_driver_greedy_ids_match_reference(ref):
    """The whole driver, prefill + 8 greedy steps, as the reference's
    ``_transformer_main`` runs it: identical token ids for every request."""
    port_cfg, ref_cfg = _cfgs(ref)
    rparams, params = _params(ref, ref_cfg, seed=2)
    b, s, gen, seed = 3, 20, 8, 5
    toks = serve.prompt_tokens(port_cfg.vocab_size, b, s, seed)

    # the reference's driver loop (launch/serve.py::_transformer_main)
    prefill = ref.jax.jit(ref.model.make_prefill_step(ref_cfg))
    step = ref.jax.jit(ref.model.make_serve_step(ref_cfg))
    last, pre = prefill(rparams, {"tokens": ref.jnp.asarray(toks, ref.jnp.int32)})
    caches = ref.serve._load_prefill(
        ref_cfg, ref.model.init_caches(ref_cfg, b, s + gen), pre, s
    )
    tok = ref.jnp.argmax(last, -1).astype(ref.jnp.int32)[:, None]
    want = [np.asarray(tok)]
    for i in range(gen):
        batch = {"pos": ref.jnp.full((b,), s + i, ref.jnp.int32), "tokens": tok}
        lg, caches = step(rparams, caches, batch)
        tok = ref.jnp.argmax(lg, -1).astype(ref.jnp.int32)[:, None]
        want.append(np.asarray(tok))
    want = np.concatenate(want, 1)

    model = Model(port_cfg, device="cpu")
    prompt = torch.tensor(toks, dtype=torch.int32)
    out = serve.generate(model, params, prompt, gen)
    assert out.tokens.shape == (b, gen + 1)
    assert out.logits.shape == (gen, b, port_cfg.vocab_size)
    np.testing.assert_array_equal(out.tokens.numpy(), want)


def test_serve_cli_runs_on_the_cpu(capsys):
    assert serve.main(
        ["--arch", ARCH + "-smoke", "--batch", "2", "--prompt-len", "70",
         "--gen", "3", "--device", "cpu"]
    ) == 0
    out = capsys.readouterr().out
    assert "prefill [2x70]" in out and "decoded 3 tokens x 2 reqs" in out


def test_serve_cli_fleet_serves_on_the_cpu(capsys):
    """``--fleet`` (named when it was refused) now serves the localization
    fleet on the CPU: a hot swap, no new act shapes after warmup."""
    argv = ["--fleet", "--device", "cpu", "--requests", "8", "--max-batch", "4"]
    assert serve.main([*argv, "--train-steps", "2"]) == 0
    out = capsys.readouterr().out
    assert "served 8 requests" in out and "recompiles_after_warmup=0" in out
    assert "hot swaps=1" in out and "compiled buckets=[1, 2, 4]" in out
    with pytest.raises(SystemExit) as exc:
        serve.main(["--fleet", "--arch", ARCH + "-smoke"])
    assert exc.value.code == 2
    assert "exactly one of --fleet or --arch" in capsys.readouterr().err


def test_load_prefill_raises_on_a_mismatched_leaf():
    cfg = get_config(ARCH + "-smoke")
    pre = init_caches(cfg, 2, 10, "cpu")
    with pytest.raises(ValueError, match="does not fit"):
        serve.load_prefill(init_caches(cfg, 1, 20, "cpu"), pre)  # batch 2 into 1
    ok = serve.load_prefill(init_caches(cfg, 2, 20, "cpu"), pre)
    assert ok["groups"]["b0"]["k"].shape[2] == 20


# -- the sliding-window handoff ----------------------------------------------------
SWA = {"sliding_window": 8}
SWA_PROMPT, SWA_STEPS = 12, 4  # 12 > 8 and 12 % 8 != 0


def _decode_vs_forward(model_fns, params, toks):
    """Max |decode logits - teacher-forced logits| over the decode steps
    after a prefill of SWA_PROMPT tokens."""
    forward_fn, prefill, step, caches_for, load, arr = model_fns
    b = toks.shape[0]
    full = forward_fn(params, arr(toks))  # [B, S + steps, V]
    _, pre = prefill(params, {"tokens": arr(toks[:, :SWA_PROMPT])})
    caches = load(caches_for(b, SWA_PROMPT + SWA_STEPS), pre)
    worst = 0.0
    for i in range(SWA_STEPS):
        p = SWA_PROMPT + i
        pos = arr(np.full((b,), p, np.int32))
        batch = {"tokens": arr(toks[:, p : p + 1]), "pos": pos}
        lg, caches = step(params, caches, batch)
        worst = max(worst, float(np.abs(_np(lg) - _np(full[:, p])).max()))
    return worst


def test_swa_decode_after_long_prompt_matches_forward(rng):
    """Prompt 12 > window 8: the handed-over cache puts position p in slot
    p % 8, so decode reproduces the teacher-forced forward."""
    cfg = dataclasses.replace(get_config(ARCH + "-smoke"), n_kv_heads=2, **SWA)
    params = init_params(cfg, torch.Generator().manual_seed(0))
    toks = rng.integers(0, cfg.vocab_size, (2, SWA_PROMPT + SWA_STEPS)).astype(np.int32)

    def full(params, t):
        pos = rope.positions_for(cfg, t.shape[0], t.shape[1])
        return logits_fn(cfg, params, forward(cfg, params, t, pos, mode="train")[0])

    fns = (
        full,
        make_prefill_step(cfg),
        make_serve_step(cfg),
        lambda b, n: init_caches(cfg, b, n, "cpu"),
        serve.load_prefill,
        torch.from_numpy,
    )
    assert _decode_vs_forward(fns, params, toks) <= ATOL
    pre = make_prefill_step(cfg)(params, {"tokens": torch.from_numpy(toks[:, :12])})[1]
    assert pre["groups"]["b0"]["kpos"][0, 0].tolist() == [8, 9, 10, 11, 4, 5, 6, 7]


def test_reference_swa_handoff_is_off_for_such_prompts(ref, rng):
    """The reference fails the same check: its prefill hands the last 8
    keys over at slots 0..7, and decode (slot p % 8) then overwrites keys
    still inside the window.  This is why the port rolls the handoff."""
    _, ref_cfg = _cfgs(ref, **SWA)
    rparams, _ = _params(ref, ref_cfg)
    n = SWA_PROMPT + SWA_STEPS
    toks = rng.integers(0, ref_cfg.vocab_size, (2, n)).astype(np.int32)
    jnp = ref.jnp

    def full(params, t):
        pos = ref.rope.positions_for(ref_cfg, t.shape[0], t.shape[1])
        h = ref.model.forward(ref_cfg, params, t, pos, mode="train")[0]
        return ref.model.logits_fn(ref_cfg, params, h)

    fns = (
        full,
        ref.model.make_prefill_step(ref_cfg),
        ref.model.make_serve_step(ref_cfg),
        lambda b, n: ref.model.init_caches(ref_cfg, b, n),
        lambda c, p: ref.serve._load_prefill(ref_cfg, c, p, SWA_PROMPT),
        jnp.asarray,
    )
    assert _decode_vs_forward(fns, rparams, toks) > 0.1
