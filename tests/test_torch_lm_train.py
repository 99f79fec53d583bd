"""The model zoo's LM train step against the reference on the CPU.

``chunked_attention``, ``chunked_xent``, the loss's gradients, C's
backward (``RMSNorm``), the one-tree AdamW and three ``train_step``s at
``microbatches`` 1 and 2 take the same inputs on both sides: the
reference's init converted with ``zoo_train_state_from_numpy`` and
numpy-seeded tokens, at the reduced configs of h2o-danube-3-4b,
qwen2.5-14b and starcoder2-15b (2 layers, d_model 256, float32).  The
reference runs its default XLA path (``attn_impl="xla"``), which is what
the port's ``attn_impl="chunked"`` ports.  Also: D refuses a gradient,
and ``launch.train`` prints the reference's lines.
"""

import re
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: these sizes gain nothing from more, and spinning
# OpenMP threads in parallel test workers would starve the other tests
torch.set_num_threads(1)

from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    zoo_params_from_numpy,
    zoo_train_state_from_numpy,
)
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.rmsnorm import RMSNorm, rmsnorm, rmsnorm_plain  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import attention  # noqa: E402
from repro_torch.models.model import (  # noqa: E402
    Model,
    chunked_xent,
    forward,
    make_loss_fn,
    make_train_step,
)
from repro_torch.optim.adamw import (  # noqa: E402
    AdamWConfig,
    tree_adamw_init,
    tree_adamw_update,
    tree_leaves,
)

ARCHS = ("h2o-danube-3-4b", "qwen2.5-14b", "starcoder2-15b")


@pytest.fixture(scope="module")
def ref():
    """The reference zoo (the tests that compare against it skip where JAX
    is missing)."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    import repro.core  # noqa: F401  (import order: see tests/test_torch_fleet.py)
    from repro.configs.base import get_config as ref_get_config
    from repro.kernels.rmsnorm.ref import rmsnorm_ref
    from repro.launch import train as ref_train
    from repro.models import attention as ref_attention
    from repro.models import model as ref_model
    from repro.models.sharding import ShardingPolicy
    from repro.optim import adamw as ref_adamw

    return SimpleNamespace(
        jax=jax,
        jnp=jnp,
        get_config=ref_get_config,
        rmsnorm_ref=rmsnorm_ref,
        train=ref_train,
        attention=ref_attention,
        model=ref_model,
        policy=ShardingPolicy,
        adamw=ref_adamw,
    )


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _state(ref, arch, seed=0, opt_dtype="float32"):
    """The reference's train state of ``arch``-smoke, and the same state
    converted into the port."""
    rcfg = ref.get_config(arch + "-smoke")
    opt = ref.adamw.AdamWConfig(opt_dtype=opt_dtype)
    rstate = ref.model.init_train_state(rcfg, ref.jax.random.PRNGKey(seed), opt)
    tree = ref.jax.tree_util.tree_map(np.asarray, rstate)
    return rcfg, rstate, zoo_train_state_from_numpy(tree)


def _batch(rng, vocab, b, s):
    """Tokens and labels (five of row 0's labels masked) as numpy."""
    toks = rng.integers(0, vocab, (b, s + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[0, :5] = -1
    return toks[:, :-1].copy(), labels


def _assert_leaves_close(got, want_tree, ref, rtol):
    """``got`` (tensors in the reference's leaf order) against the leaves of
    ``want_tree``, every leaf present: |got - want| <= rtol * max|want|."""
    want_paths = ref.jax.tree_util.tree_flatten_with_path(want_tree)[0]
    assert len(got) == len(want_paths)
    for g, (path, w) in zip(got, want_paths, strict=True):
        w = _np(w)
        assert g.shape == w.shape, path
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(_np(g) - w).max())
        assert err <= rtol * scale, (path, err, scale)


# -- attention, cross entropy, norm ------------------------------------------------
@pytest.mark.parametrize(
    "b, s, hq, hkv, d, window, softcap, q_chunk, kv_chunk",
    [
        (2, 48, 4, 2, 16, None, 0.0, 16, 24),
        (1, 64, 4, 1, 8, 20, 0.0, 16, 32),  # window cuts inside and across chunks
        (2, 32, 2, 2, 16, 12, 30.0, 8, 16),  # softcap, no GQA
    ],
)
def test_chunked_attention_and_grads_match_reference(
    ref, rng, b, s, hq, hkv, d, window, softcap, q_chunk, kv_chunk
):
    q = rng.standard_normal((b, s, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    g = rng.standard_normal((b, s, hq, d)).astype(np.float32)
    kw = dict(
        causal=True,
        window=window,
        scale=d**-0.5,
        q_chunk=q_chunk,
        kv_chunk=kv_chunk,
        softcap=softcap,
    )
    jnp = ref.jnp

    def ref_fn(q, k, v):
        return jnp.sum(ref.attention.chunked_attention(q, k, v, **kw) * g)

    args = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = ref.attention.chunked_attention(*args, **kw)
    want_grads = ref.jax.grad(ref_fn, argnums=(0, 1, 2))(*args)
    qt, kt, vt = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    got = attention.chunked_attention(qt, kt, vt, **kw)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=0)
    got_grads = torch.autograd.grad((got * torch.from_numpy(g)).sum(), (qt, kt, vt))
    for gg, wg in zip(got_grads, want_grads, strict=True):
        np.testing.assert_allclose(_np(gg), _np(wg), atol=1e-5, rtol=0)
    with pytest.raises(ValueError, match="no multiple"):
        attention.chunked_attention(qt, kt, vt, **dict(kw, q_chunk=s - 1))


def test_chunked_xent_matches_reference(ref, rng):
    rcfg, rstate, state = _state(ref, ARCHS[0])
    cfg = get_config(ARCHS[0] + "-smoke")
    b, s, chunk = 2, 48, 16
    hidden = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    _, labels = _batch(rng, cfg.vocab_size, b, s)
    nll_ref, n_ref = ref.model.chunked_xent(
        rcfg,
        rstate["params"],
        ref.jnp.asarray(hidden),
        ref.jnp.asarray(labels),
        policy=ref.policy(loss_chunk=chunk),
    )
    nll, n = chunked_xent(
        cfg,
        state["params"],
        torch.from_numpy(hidden),
        torch.from_numpy(labels),
        loss_chunk=chunk,
    )
    assert float(n) == float(n_ref) == b * s - 5
    assert float(nll) == pytest.approx(float(nll_ref), rel=1e-6)


@pytest.mark.parametrize("shape", [(8, 64), (2, 6, 96)])
def test_rmsnorm_backward_matches_autograd_and_reference(ref, rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    scale = rng.standard_normal(shape[-1]).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    eps = 1e-5

    def grads(fn):
        xt = torch.tensor(x, requires_grad=True)
        st = torch.tensor(scale, requires_grad=True)
        y = fn(xt, st)
        return y, torch.autograd.grad((y * torch.from_numpy(g)).sum(), (xt, st))

    y, (dx, ds) = grads(lambda a, b: RMSNorm.apply(a, b, eps))
    y_plain, (dx_plain, ds_plain) = grads(lambda a, b: rmsnorm_plain(a, b, eps))
    jnp = ref.jnp
    dx_ref, ds_ref = ref.jax.grad(
        lambda a, b: jnp.sum(ref.rmsnorm_ref(a, b, eps=eps) * g), argnums=(0, 1)
    )(jnp.asarray(x), jnp.asarray(scale))
    assert torch.equal(y, y_plain)  # the forward is the wrapper's
    for got, want in ((dx, dx_plain), (ds, ds_plain), (dx, dx_ref), (ds, ds_ref)):
        np.testing.assert_allclose(_np(got), _np(want), atol=1e-6, rtol=1e-6)


def test_rmsnorm_forward_counts_no_launch_on_the_cpu(rng):
    x = torch.tensor(rng.standard_normal((4, 32)), dtype=torch.float32)
    scale = torch.ones(32, requires_grad=True)
    before = rmsnorm.launches
    RMSNorm.apply(x, scale, 1e-5).sum().backward()
    assert rmsnorm.launches == before and scale.grad is not None


def test_flash_attention_refuses_a_gradient(rng):
    q = torch.tensor(rng.standard_normal((1, 8, 2, 8)), dtype=torch.float32)
    k = torch.tensor(rng.standard_normal((1, 8, 1, 8)), dtype=torch.float32)
    with pytest.raises(RuntimeError, match="no backward"):
        flash_attention(q.requires_grad_(), k, k)
    with torch.no_grad():  # serving: no gradient asked for
        assert flash_attention(q, k, k).shape == q.shape
    # the train path through the kernel (attn_impl="kernel") raises too
    cfg = get_config(ARCHS[0] + "-smoke")
    params = Model(cfg, "cpu").init_params(0)
    toks = torch.tensor(rng.integers(0, cfg.vocab_size, (1, 17)), dtype=torch.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    with pytest.raises(RuntimeError, match="no backward"):
        make_train_step(cfg, AdamWConfig(), attn_impl="kernel")(
            {"params": params, "opt": tree_adamw_init(AdamWConfig(), params)}, batch
        )


# -- the loss, the optimizer and the step ------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_grads_match_reference(ref, rng, arch):
    rcfg, rstate, state = _state(ref, arch)
    cfg = get_config(arch + "-smoke")
    toks, labels = _batch(rng, cfg.vocab_size, 2, 48)
    rbatch = {"tokens": ref.jnp.asarray(toks), "labels": ref.jnp.asarray(labels)}
    (total_ref, m_ref), grads_ref = ref.jax.value_and_grad(
        ref.model.make_loss_fn(rcfg), has_aux=True
    )(rstate["params"], rbatch)

    live = state["params"]
    leaves = tree_leaves(live)
    for t in leaves:
        t.requires_grad_(True)
    batch = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)}
    before = rmsnorm.launches, flash_attention.launches
    total, metrics = make_loss_fn(cfg)(live, batch)
    grads = torch.autograd.grad(total, leaves)
    assert (rmsnorm.launches, flash_attention.launches) == before  # CPU: plain
    assert float(total.detach()) == pytest.approx(float(total_ref), rel=1e-5)
    assert float(metrics["n_tokens"]) == float(m_ref["n_tokens"]) == 2 * 48 - 5
    assert float(metrics["aux"]) == 0.0
    _assert_leaves_close(list(grads), grads_ref, ref, 1e-5)


@pytest.mark.parametrize("opt_dtype", ["float32", "bfloat16"])
def test_tree_adamw_update_matches_reference(ref, rng, opt_dtype):
    """Two updates, each from the reference's state of the moment (the
    second from non-zero moments): params and float32 moments within 1e-6,
    bfloat16 moments within one bf16 ulp of the reference's (one rounding
    of float32 values an ulp or so apart; across several steps an ulp can
    grow where ``b1 * m`` and ``(1 - b1) * g`` cancel)."""
    _, rstate, _ = _state(ref, ARCHS[1], opt_dtype=opt_dtype)
    cfg = AdamWConfig(opt_dtype=opt_dtype, warmup_steps=2)
    rcfg_opt = ref.adamw.AdamWConfig(opt_dtype=opt_dtype, warmup_steps=2)
    rparams, ropt = rstate["params"], rstate["opt"]
    for step in range(2):
        state = zoo_train_state_from_numpy(
            ref.jax.tree_util.tree_map(np.asarray, {"params": rparams, "opt": ropt})
        )
        g_np = ref.jax.tree_util.tree_map(
            lambda p: rng.standard_normal(p.shape).astype(np.float32) * 0.05, rparams
        )
        rparams, ropt, rgn = ref.adamw.adamw_update(
            rcfg_opt, rparams, ref.jax.tree_util.tree_map(ref.jnp.asarray, g_np), ropt
        )
        params, opt, gn = tree_adamw_update(
            cfg, state["params"], zoo_params_from_numpy(g_np), state["opt"]
        )
        assert int(opt["count"]) == int(ropt["count"]) == step + 1
        assert float(gn) == pytest.approx(float(rgn), rel=1e-6)
        got_p = tree_leaves(params)
        for got, want in zip(got_p, ref.jax.tree_util.tree_leaves(rparams)):
            np.testing.assert_allclose(_np(got), _np(want), atol=1e-6, rtol=0)
        for name in ("m", "v"):
            got_l = tree_leaves(opt[name])
            want_l = ref.jax.tree_util.tree_leaves(ropt[name])
            for got, want in zip(got_l, want_l, strict=True):
                assert got.dtype == getattr(torch, opt_dtype)
                want = _np(want)
                if opt_dtype == "float32":
                    np.testing.assert_allclose(_np(got), want, atol=1e-6, rtol=0)
                    continue
                # one bf16 ulp: 2**-7 of the value's binade
                e = np.floor(np.log2(np.maximum(np.abs(want), 1e-30)))
                assert np.all(np.abs(_np(got) - want) <= 2.0 ** (e - 7))


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_match_reference(ref, arch, microbatches):
    """Three steps from the reference's init on the same batches: loss and
    grad_norm within 1e-5 relative each step, params within 1e-4 (the
    first AdamW steps are sign-like: a near-zero gradient can move an
    element by up to 2 lr on a rounding)."""
    rcfg, rstate, state = _state(ref, arch, seed=1)
    cfg = get_config(arch + "-smoke")
    opt = ref.adamw.AdamWConfig()
    policy = ref.policy(microbatches=microbatches)
    rstep = ref.jax.jit(ref.model.make_train_step(rcfg, opt, policy=policy))
    step = make_train_step(cfg, AdamWConfig(), microbatches=microbatches)
    rng = np.random.default_rng(7)
    before = rmsnorm.launches, flash_attention.launches
    for _ in range(3):
        toks, labels = _batch(rng, cfg.vocab_size, 4, 32)
        rstate, rm = rstep(
            rstate, {"tokens": ref.jnp.asarray(toks), "labels": ref.jnp.asarray(labels)}
        )
        batch = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)}
        state, m = step(state, batch)
        assert sorted(m) == sorted(rm) == sorted(
            ["loss", "aux", "n_tokens", "total", "grad_norm"]
        )
        assert float(m["n_tokens"]) == float(rm["n_tokens"]) == 4 * 32 - 5
        for key in ("loss", "total", "grad_norm"):
            assert float(m[key]) == pytest.approx(float(rm[key]), rel=1e-5), key
    assert (rmsnorm.launches, flash_attention.launches) == before
    assert int(state["opt"]["count"]) == 3
    got = tree_leaves(state["params"])
    want = ref.jax.tree_util.tree_leaves(rstate["params"])
    assert len(got) == len(want)
    for g, w in zip(got, want, strict=True):
        np.testing.assert_allclose(_np(g), _np(w), atol=1e-4, rtol=0)


def test_train_step_microbatches_take_interleaved_rows(rng):
    """``microbatches=2`` sums the losses of rows (0, 2) and (1, 3): its
    loss is the mean of those two microbatches' losses."""
    cfg = get_config(ARCHS[0] + "-smoke")
    params = Model(cfg, "cpu").init_params(3)
    toks, labels = _batch(rng, cfg.vocab_size, 4, 16)
    batch = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)}
    loss_fn = make_loss_fn(cfg)
    with torch.no_grad():
        want = [
            float(loss_fn(params, {k: v[i::2] for k, v in batch.items()})[1]["loss"])
            for i in (0, 1)
        ]
    state = {"params": params, "opt": tree_adamw_init(AdamWConfig(), params)}
    _, m = make_train_step(cfg, AdamWConfig(), microbatches=2)(state, batch)
    assert float(m["loss"]) == pytest.approx(sum(want) / 2, rel=1e-6)


# -- the driver ----------------------------------------------------------------------
def test_train_cli_prints_the_reference_lines(ref, tmp_path, capsys):
    argv = ["--arch", "h2o-danube-3-4b-smoke", "--steps", "3", "--batch", "2"]
    argv += ["--seq", "64"]
    ckpt = str(tmp_path / "p.npz")
    assert train.main([*argv, "--device", "cpu", "--ckpt", ckpt]) == 0
    out = capsys.readouterr().out.splitlines()
    ref.train.main(argv)
    ref_out = capsys.readouterr().out.splitlines()
    assert out[0] == ref_out[0] == "h2o-danube-3-4b-smoke: 1.57M params, 2L d=256"
    step = r"step +\d+ loss=\d+\.\d{4} gnorm=\d+\.\d{3}"
    for lines in (out, ref_out):
        assert [re.fullmatch(step, ln) is not None for ln in lines[1:4]] == [True] * 3
        assert re.fullmatch(r"3 steps in \d+\.\d+s \(\d+ tok/s\)", lines[4])
    assert out[5] == f"saved params -> {ckpt}"
    # the losses are the port's own init's (no bits of the reference's)
    losses = [float(re.search(r"loss=(\S+)", ln).group(1)) for ln in out[1:4]]
    assert all(np.isfinite(losses))
    # xlstm (mLSTM and sLSTM blocks) trains through the same CLI
    argv = ["--arch", "xlstm-125m-smoke", "--steps", "2", "--batch", "2"]
    argv += ["--seq", "32"]
    assert train.main([*argv, "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    ref.train.main(argv)
    ref_out = capsys.readouterr().out.splitlines()
    assert out[0] == ref_out[0] and out[0].startswith("xlstm-125m-smoke: ")
    for lines in (out, ref_out):
        assert [re.fullmatch(step, ln) is not None for ln in lines[1:3]] == [True] * 2
        assert re.fullmatch(r"2 steps in \d+\.\d+s \(\d+ tok/s\)", lines[3])


def test_forward_train_mode_matches_between_attention_impls(rng):
    """The chunked and the kernel (plain on the CPU) attentions compute one
    function: the teacher-forced forwards agree."""
    cfg = get_config(ARCHS[1] + "-smoke")
    params = Model(cfg, "cpu").init_params(0)
    toks = torch.tensor(rng.integers(0, cfg.vocab_size, (2, 40)), dtype=torch.int32)
    pos = torch.arange(40, dtype=torch.int32).expand(2, 40)
    with torch.no_grad():
        a = forward(cfg, params, toks, pos, mode="train", attn_impl="chunked")[0]
        b = forward(cfg, params, toks, pos, mode="train", attn_impl="kernel")[0]
    np.testing.assert_allclose(_np(a), _np(b), atol=1e-5, rtol=0)
    with pytest.raises(ValueError, match="attn_impl"):
        forward(cfg, params, toks, pos, mode="train", attn_impl="xla")
