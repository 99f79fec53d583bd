"""The LM train step and the drivers on the zoo's MoE, MLA, M-RoPE and
embedding-input configs, against the reference on the CPU.

qwen3-moe-235b-a22b, moonshot-v1-16b-a3b, deepseek-v2-lite-16b,
qwen2-vl-2b and musicgen-medium at their reduced configs (float32) take
the reference's init, converted with ``zoo_train_state_from_numpy``, and
numpy-seeded batches: the loss's gradients (routers included), three
``train_step``s at ``microbatches`` 1 and 2 (qwen2-vl with M-RoPE
positions ``[3, B, S]`` in the batch, split along their batch axis), and
``launch.train`` / ``launch.serve`` on the embeds configs with the
reference's init patched in, printing the reference CLI's losses and ids.
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
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.models.model import (  # noqa: E402
    Model,
    make_loss_fn,
    make_train_step,
)
from repro_torch.optim.adamw import (  # noqa: E402
    AdamWConfig,
    tree_adamw_init,
    tree_leaves,
)

ARCHS = (
    "qwen3-moe-235b-a22b",
    "moonshot-v1-16b-a3b",
    "deepseek-v2-lite-16b",
    "qwen2-vl-2b",
    "musicgen-medium",
)
EMBEDS_ARCHS = ("qwen2-vl-2b", "musicgen-medium")


@pytest.fixture(scope="module")
def ref():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    import repro.core  # noqa: F401  (import order: see tests/test_torch_fleet.py)
    from repro.configs.base import get_config as ref_get_config
    from repro.launch import serve as ref_serve
    from repro.launch import train as ref_train
    from repro.models import model as ref_model
    from repro.models.sharding import ShardingPolicy
    from repro.optim import adamw as ref_adamw

    return SimpleNamespace(
        jax=jax,
        jnp=jnp,
        get_config=ref_get_config,
        serve=ref_serve,
        train=ref_train,
        model=ref_model,
        policy=ShardingPolicy,
        adamw=ref_adamw,
    )


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _state(ref, arch, seed=0):
    rcfg = ref.get_config(arch + "-smoke")
    opt = ref.adamw.AdamWConfig()
    rstate = ref.model.init_train_state(rcfg, ref.jax.random.PRNGKey(seed), opt)
    tree = ref.jax.tree_util.tree_map(np.asarray, rstate)
    return rcfg, rstate, zoo_train_state_from_numpy(tree)


def _batch(cfg, rng, b, s):
    """A numpy batch: tokens or embeds, labels (five of row 0's masked),
    and for M-RoPE distinct t/h/w positions [3, B, S]."""
    labels = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    labels[0, :5] = -1
    if cfg.input_kind == "embeds":
        batch = {"embeds": rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)}
    else:
        batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    batch["labels"] = labels
    if cfg.rope == "mrope":
        t = np.broadcast_to(np.arange(s), (b, s))
        hw = np.sort(rng.integers(0, s, (2, b, s)), axis=-1)
        batch["positions"] = np.concatenate([t[None], hw]).astype(np.int32)
    return batch


def _to(batch, lib):
    return {k: lib(v) for k, v in batch.items()}


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "qwen2-vl-2b"])
def test_loss_fn_grads_match_reference(ref, rng, arch):
    """Loss and router loss 1e-5 relative; every gradient leaf (each
    router's, the prefix's, MLA's) within 1e-5 of its largest magnitude."""
    rcfg, rstate, state = _state(ref, arch)
    cfg = get_config(arch + "-smoke")
    batch = _batch(cfg, rng, 2, 32)
    (total_ref, m_ref), grads_ref = ref.jax.value_and_grad(
        ref.model.make_loss_fn(rcfg), has_aux=True
    )(rstate["params"], _to(batch, ref.jnp.asarray))
    live = state["params"]
    leaves = tree_leaves(live)
    for t in leaves:
        t.requires_grad_(True)
    total, metrics = make_loss_fn(cfg)(live, _to(batch, torch.from_numpy))
    grads = torch.autograd.grad(total, leaves, materialize_grads=True)
    assert float(total.detach()) == pytest.approx(float(total_ref), rel=1e-5)
    aux = float(metrics["aux"].detach())
    assert aux == pytest.approx(float(m_ref["aux"]), rel=1e-5)
    assert (aux > 0) == bool(cfg.moe.n_experts)
    want_paths = ref.jax.tree_util.tree_flatten_with_path(grads_ref)[0]
    assert len(grads) == len(want_paths)
    for g, (path, w) in zip(grads, want_paths, strict=True):
        w = _np(w)
        assert g.shape == w.shape, path
        scale = max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(_np(g) - w).max()) <= 1e-5 * scale, path


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_match_reference(ref, arch, microbatches):
    """Three steps from the reference's init on the same batches: loss, aux,
    total and grad_norm within 1e-5 relative each step, params within 1e-4
    after the third (as tests/test_torch_lm_train.py holds the dense
    configs)."""
    rcfg, rstate, state = _state(ref, arch, seed=1)
    cfg = get_config(arch + "-smoke")
    opt = ref.adamw.AdamWConfig()
    policy = ref.policy(microbatches=microbatches)
    rstep = ref.jax.jit(ref.model.make_train_step(rcfg, opt, policy=policy))
    step = make_train_step(cfg, AdamWConfig(), microbatches=microbatches)
    rng = np.random.default_rng(7)
    for _ in range(3):
        batch = _batch(cfg, rng, 4, 32)
        rstate, rm = rstep(rstate, _to(batch, ref.jnp.asarray))
        state, m = step(state, _to(batch, torch.from_numpy))
        assert float(m["n_tokens"]) == float(rm["n_tokens"]) == 4 * 32 - 5
        for key in ("loss", "aux", "total", "grad_norm"):
            want = float(rm[key])
            assert float(m[key]) == pytest.approx(want, rel=1e-5, abs=1e-7), key
    got = tree_leaves(state["params"])
    want = ref.jax.tree_util.tree_leaves(rstate["params"])
    assert len(got) == len(want)
    for g, w in zip(got, want, strict=True):
        np.testing.assert_allclose(_np(g), _np(w), atol=1e-4, rtol=0)


def test_mrope_positions_split_with_the_batch(rng):
    """At ``microbatches=2`` microbatch ``i`` takes rows ``i, i+2`` of the
    embeds, the labels and the batch axis of M-RoPE's [3, B, S]
    positions: the step's loss is the mean of those two losses."""
    cfg = get_config("qwen2-vl-2b-smoke")
    params = Model(cfg, "cpu").init_params(3)
    batch = _to(_batch(cfg, rng, 4, 16), torch.from_numpy)
    loss_fn = make_loss_fn(cfg)

    def rows(key, x, i):
        return x[:, i::2] if key == "positions" else x[i::2]

    with torch.no_grad():
        halves = [{k: rows(k, v, i) for k, v in batch.items()} for i in (0, 1)]
        want = [float(loss_fn(params, half)[1]["loss"]) for half in halves]
    state = {"params": params, "opt": tree_adamw_init(AdamWConfig(), params)}
    _, m = make_train_step(cfg, AdamWConfig(), microbatches=2)(state, batch)
    assert float(m["loss"]) == pytest.approx(sum(want) / 2, rel=1e-6)


def test_reference_splits_2d_positions_along_the_sequence(ref, rng):
    """The reference's microbatch split reshapes any ``positions`` along
    axis 1 (``src/repro/models/model.py``): for [B, S] ones that is the
    sequence, not the batch, so the microbatch's [B, S/k] positions meet
    its [B/k, S] tokens and the step raises.  The port splits [B, S]
    positions with the batch: its step equals the one without them."""
    arch = "h2o-danube-3-4b"
    rcfg, rstate, state = _state(ref, arch)
    cfg = get_config(arch + "-smoke")
    toks = rng.integers(0, cfg.vocab_size, (4, 32)).astype(np.int32)
    pos = np.broadcast_to(np.arange(32, dtype=np.int32), (4, 32)).copy()
    batch = {"tokens": toks, "labels": toks, "positions": pos}
    rstep = ref.model.make_train_step(
        rcfg, ref.adamw.AdamWConfig(), policy=ref.policy(microbatches=2)
    )
    with pytest.raises(TypeError, match="incompatible shapes"):
        ref.jax.jit(rstep)(rstate, _to(batch, ref.jnp.asarray))

    step = make_train_step(cfg, AdamWConfig(), microbatches=2)
    params = state["params"]
    metrics = []
    for b in (batch, {k: v for k, v in batch.items() if k != "positions"}):
        p = {"params": _clone(params), "opt": tree_adamw_init(AdamWConfig(), params)}
        metrics.append(step(p, _to(b, torch.from_numpy))[1])
    for key in ("loss", "grad_norm"):
        assert float(metrics[0][key]) == float(metrics[1][key])


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


# -- the drivers on embeds configs ---------------------------------------------------
@pytest.mark.parametrize("arch", EMBEDS_ARCHS)
def test_train_cli_prints_the_reference_losses(ref, capsys, monkeypatch, arch):
    """``launch.train`` with the reference's init patched in: the same
    parameter count line and, step by step, the reference CLI's losses and
    grad norms (as printed, to a unit of the last digit)."""
    seed, argv = 0, ["--arch", arch + "-smoke", "--steps", "3", "--batch", "2"]
    argv += ["--seq", "32", "--seed", "0"]
    rcfg = ref.get_config(arch + "-smoke")
    opt = ref.adamw.AdamWConfig()
    rstate = ref.model.init_train_state(rcfg, ref.jax.random.PRNGKey(seed), opt)
    tree = ref.jax.tree_util.tree_map(np.asarray, rstate)
    monkeypatch.setattr(
        Model, "init_train_state", lambda self, s: zoo_train_state_from_numpy(tree)
    )
    assert train.main([*argv, "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    ref.train.main(argv)
    ref_out = capsys.readouterr().out.splitlines()
    assert out[0] == ref_out[0]
    step = re.compile(r"step +(\d+) loss=(\S+) gnorm=(\S+)")
    got = [step.fullmatch(ln).groups() for ln in out[1:4]]
    want = [step.fullmatch(ln).groups() for ln in ref_out[1:4]]
    for g, w in zip(got, want, strict=True):
        assert g[0] == w[0]
        assert float(g[1]) == pytest.approx(float(w[1]), abs=1.5e-4)
        assert float(g[2]) == pytest.approx(float(w[2]), abs=1.5e-3)


@pytest.mark.parametrize("arch", EMBEDS_ARCHS)
def test_serve_cli_prints_the_reference_ids(ref, capsys, monkeypatch, arch):
    """``launch.serve --arch`` with the reference's init patched in prints
    the reference CLI's sample ids: the same numpy prompt embeds, zero
    embeds at each decode step, the same greedy tokens."""
    argv = ["--arch", arch + "-smoke", "--batch", "2", "--prompt-len", "24"]
    argv += ["--gen", "5", "--seed", "3"]
    rcfg = ref.get_config(arch + "-smoke")
    rparams = ref.model.init_params(rcfg, ref.jax.random.PRNGKey(3))
    tree = ref.jax.tree_util.tree_map(np.asarray, rparams)
    monkeypatch.setattr(
        Model, "init_params", lambda self, s: zoo_params_from_numpy(tree)
    )
    assert serve.main([*argv, "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert ref.serve.main(argv) == 0
    ref_out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("prefill [2x24] in ")
    assert ref_out[0].startswith("prefill [2x24] in ")
    ids = [ln for ln in out if ln.startswith("sample token ids:")]
    assert ids == [ln for ln in ref_out if ln.startswith("sample token ids:")]
