"""The recurrent mixers (``repro_torch.models.ssm``: Mamba, mLSTM, sLSTM)
against the reference's ``repro.models.ssm`` on the CPU.

jamba-1.5-large-398b's and xlstm-125m's reduced configs (d_model 256,
float32; mLSTM's chunk set to Mamba's 16 on both sides) take the same
inputs on both sides: the reference's init converted with
``zoo_params_from_numpy`` and numpy-seeded activations.  Each mixer is
held to the reference in train, prefill and decode modes (3 decode steps
from the prefill's state) at sequence lengths that give 1 chunk (16), 3
chunks (48) and 37 chunks of 1 (37, a prime), and through its train-mode
gradient (Mamba and mLSTM checkpoint a chunk at a time): all within
1e-5 of each output's largest magnitude.  The port's chunked Mamba scan
also equals the naive per-step recurrence, as
``tests/test_ssm_oracle.py`` holds the reference's.
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: these sizes gain nothing from more, and spinning
# OpenMP threads in parallel test workers would starve the other tests
torch.set_num_threads(1)

from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.convert import zoo_params_from_numpy  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.optim.adamw import tree_leaves  # noqa: E402

RTOL = 1e-5  # float32 through one mixer, two frameworks' sum orders
MIXERS = {
    "mamba": "jamba-1.5-large-398b-smoke",
    "mlstm": "xlstm-125m-smoke",
    "slstm": "xlstm-125m-smoke",
}


@pytest.fixture(scope="module")
def ref():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    import repro.core  # noqa: F401  (import order: see tests/test_torch_fleet.py)
    from repro.configs.base import get_config as ref_get_config
    from repro.models import ssm as ref_ssm

    return SimpleNamespace(jax=jax, jnp=jnp, get_config=ref_get_config, ssm=ref_ssm)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, what=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= RTOL * scale, f"{what}: max|d|={err}, max={scale}"


def _cfg(name):
    """The reduced config with mLSTM chunked like Mamba (16)."""
    cfg = name if not isinstance(name, str) else get_config(name)
    return dataclasses.replace(cfg, xlstm=dataclasses.replace(cfg.xlstm, chunk=16))


def _mixer(ref, kind, seed=0):
    """(port cfg, reference cfg, port params, reference params)."""
    name = MIXERS[kind]
    cfg, rcfg = _cfg(name), _cfg(ref.get_config(name))
    rp = getattr(ref.ssm, f"{kind}_init")(ref.jax.random.PRNGKey(seed), rcfg)
    p = zoo_params_from_numpy(ref.jax.tree_util.tree_map(np.asarray, rp))
    return cfg, rcfg, p, rp


# -- pieces ------------------------------------------------------------------------
@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv1d_matches_reference(ref, rng, with_state):
    """The output within 1e-5; the new state exactly the reference's slice
    (the last K-1 rows of state + x)."""
    x = rng.standard_normal((2, 9, 12)).astype(np.float32)
    w = rng.standard_normal((12, 4)).astype(np.float32)
    b = rng.standard_normal(12).astype(np.float32)
    st = rng.standard_normal((2, 3, 12)).astype(np.float32) if with_state else None
    y_ref, s_ref = ref.ssm.causal_conv1d(
        *map(ref.jnp.asarray, (x, w, b)), None if st is None else ref.jnp.asarray(st)
    )
    y, s = ssm.causal_conv1d(
        *map(torch.from_numpy, (x, w, b)), None if st is None else torch.from_numpy(st)
    )
    _close(y, y_ref, "y")
    np.testing.assert_array_equal(_np(s), _np(s_ref))
    # one token at a time through the state is the whole sequence at once
    state, outs = torch.from_numpy(st) if with_state else None, []
    for t in range(9):
        y_t, state = ssm.causal_conv1d(
            torch.from_numpy(x[:, t : t + 1]), torch.from_numpy(w),
            torch.from_numpy(b), state,
        )  # fmt: skip
        outs.append(y_t)
    _close(torch.cat(outs, 1), y, "stepwise")


def test_best_chunk_is_the_reference_formula(ref):
    for s_len in (1, 7, 16, 37, 48, 96, 100, 1000, 1032):
        for chunk in (1, 16, 50, 64):
            assert ssm._best_chunk(s_len, chunk) == ref.ssm._best_chunk(s_len, chunk)
    assert ssm._best_chunk(1000, 64) == 50  # jamba's prefill: 20 chunks
    assert ssm._best_chunk(37, 16) == 1


def test_state_inits_match_reference(ref):
    """Shapes and dtypes of every state leaf as the reference's; Mamba's
    and mLSTM's carried states float32 beside a bf16 conv state; mLSTM's
    stabiliser -1e30 (finite), sLSTM's n 1 and m 0."""
    for kind in MIXERS:
        cfg = get_config(MIXERS[kind])
        rcfg = ref.get_config(MIXERS[kind])
        got = getattr(ssm, f"{kind}_state_init")(cfg, 3, torch.bfloat16, "cpu")
        want = getattr(ref.ssm, f"{kind}_state_init")(rcfg, 3, ref.jnp.bfloat16)
        assert sorted(got) == sorted(want)
        for key in got:
            assert tuple(got[key].shape) == want[key].shape, (kind, key)
            assert str(got[key].dtype).removeprefix("torch.") == str(want[key].dtype)
            np.testing.assert_array_equal(_np(got[key]), _np(want[key]))
    m = ssm.mlstm_state_init(get_config(MIXERS["mlstm"]), 2, torch.float32, "cpu")
    assert m["conv"].dtype == torch.float32
    assert bool((m["m"] == np.float32(-1e30)).all())
    s = ssm.slstm_state_init(get_config(MIXERS["slstm"]), 2, torch.float32, "cpu")
    assert float(s["n"].min()) == 1.0 and float(s["m"].abs().max()) == 0.0
    assert ssm.mamba_state_init(get_config(MIXERS["mamba"]), 2, torch.bfloat16, "cpu")[
        "ssm"
    ].dtype == torch.float32


@pytest.mark.parametrize("kind", list(MIXERS))
def test_init_is_the_reference_layout(ref, kind):
    """The port's own init: the reference's leaf names, shapes and dtypes
    (bf16 config: ``a_log`` and ``d_skip`` stay float32); Mamba's
    ``a_log`` is log(1..N) on every channel, as the reference's."""
    name = MIXERS[kind]
    cfg = dataclasses.replace(get_config(name), dtype="bfloat16")
    rcfg = dataclasses.replace(ref.get_config(name), dtype="bfloat16")
    got = getattr(ssm, f"{kind}_init")(cfg, torch.Generator().manual_seed(0))
    want = getattr(ref.ssm, f"{kind}_init")(ref.jax.random.PRNGKey(0), rcfg)

    def layout(tree):
        if isinstance(tree, dict):
            return {k: layout(v) for k, v in tree.items()}
        return tuple(tree.shape), str(tree.dtype).removeprefix("torch.")

    assert layout(got) == layout(ref.jax.tree_util.tree_map(np.asarray, want))
    if kind == "mamba":
        assert got["a_log"].dtype == got["d_skip"].dtype == torch.float32
        # within 2 float32 ulps: XLA's log and torch's round differently
        np.testing.assert_allclose(
            _np(got["a_log"]), _np(want["a_log"]), atol=2.5e-7, rtol=0
        )


# -- the mixers --------------------------------------------------------------------
@pytest.mark.parametrize("s_len", [16, 48, 37])  # 1, 3 and 37 chunks
@pytest.mark.parametrize("kind", list(MIXERS))
def test_mixer_matches_reference_in_every_mode(ref, rng, kind, s_len):
    """Train and prefill over ``s_len`` tokens, the prefill's state leaf
    for leaf, then 3 decode steps from that state on both sides."""
    cfg, rcfg, p, rp = _mixer(ref, kind)
    apply, ref_apply = getattr(ssm, f"{kind}_apply"), getattr(ref.ssm, f"{kind}_apply")
    steps = 3
    u = rng.standard_normal((2, s_len + steps, cfg.d_model)).astype(np.float32)
    head = u[:, :s_len]
    y_ref, _ = ref_apply(rcfg, rp, ref.jnp.asarray(head), mode="train")
    with torch.no_grad():
        y, st = apply(cfg, p, torch.from_numpy(head), mode="train")
    assert st is None
    _close(y, y_ref, "train")

    y_ref, st_ref = ref_apply(rcfg, rp, ref.jnp.asarray(head), mode="prefill")
    with torch.no_grad():
        y, st = apply(cfg, p, torch.from_numpy(head), mode="prefill")
    _close(y, y_ref, "prefill")
    assert sorted(st) == sorted(st_ref)
    for key in st:
        assert st[key].dtype == torch.float32, key
        _close(st[key], st_ref[key], f"prefill state {key}")

    for i in range(steps):
        x = u[:, s_len + i : s_len + i + 1]
        y_ref, st_ref = ref_apply(
            rcfg, rp, ref.jnp.asarray(x), mode="decode", state=st_ref
        )
        with torch.no_grad():
            y, st = apply(cfg, p, torch.from_numpy(x), mode="decode", state=st)
        _close(y, y_ref, f"decode {i}")
        for key in st:
            _close(st[key], st_ref[key], f"decode {i} state {key}")


@pytest.mark.parametrize("kind", list(MIXERS))
def test_train_mode_gradients_match_reference(ref, rng, kind):
    """The gradient of ``sum(y * r)`` over 48 tokens (3 chunks, each
    checkpointed on the port's side) for every parameter and the input."""
    cfg, rcfg, p, rp = _mixer(ref, kind, seed=2)
    apply, ref_apply = getattr(ssm, f"{kind}_apply"), getattr(ref.ssm, f"{kind}_apply")
    u = rng.standard_normal((2, 48, cfg.d_model)).astype(np.float32)
    r = rng.standard_normal((2, 48, cfg.d_model)).astype(np.float32)

    def ref_loss(params, x):
        return (ref_apply(rcfg, params, x, mode="train")[0] * r).sum()

    g_ref, gu_ref = ref.jax.grad(ref_loss, argnums=(0, 1))(rp, ref.jnp.asarray(u))
    leaves = tree_leaves(p)
    for t in leaves:
        t.requires_grad_(True)
    x = torch.from_numpy(u).requires_grad_(True)
    loss = (apply(cfg, p, x, mode="train")[0] * torch.from_numpy(r)).sum()
    grads = torch.autograd.grad(loss, [*leaves, x])
    want = ref.jax.tree_util.tree_leaves(g_ref)
    assert len(grads) == len(want) + 1
    for g, w in zip(grads, [*want, gu_ref], strict=True):
        assert float(g.abs().max()) > 0
        _close(g, w, "grad")


@pytest.mark.parametrize("s_len,chunk", [(16, 4), (24, 8), (7, 16), (37, 37)])
def test_mamba_chunked_scan_matches_naive(rng, s_len, chunk):
    """The chunked scan (the port's log-depth scan inside a chunk) against
    the literal recurrence h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t,
    computed in float64: 1e-5 relative."""
    b, di, n = 2, 8, 4
    dt = rng.random((b, s_len, di)) * 0.5
    b_seq = rng.standard_normal((b, s_len, n))
    c_seq = rng.standard_normal((b, s_len, n))
    xf = rng.standard_normal((b, s_len, di))
    a = -(rng.random((di, n)) + 0.1)
    h = np.zeros((b, di, n))
    ys = []
    for t in range(s_len):
        da = np.exp(dt[:, t, :, None] * a[None])
        h = da * h + (dt[:, t] * xf[:, t])[..., None] * b_seq[:, t, None, :]
        ys.append(np.einsum("bdn,bn->bd", h, c_seq[:, t]))
    args = [torch.tensor(v, dtype=torch.float32) for v in (dt, b_seq, c_seq, xf, a)]
    y, h_last = ssm._selective_scan_chunked(*args, chunk, remat=False)
    _close(y, np.stack(ys, 1), "y")
    _close(h_last, h, "h")
