"""The zoo's Mamba and xLSTM configs against the reference on the CPU.

jamba-1.5-large-398b (Mamba, attention without rope, MoE and dense
FFNs) and xlstm-125m (mLSTM and sLSTM blocks with no FFN) at their
reduced configs (3 and 2 layers, d_model 256, float32) take the same
inputs on both sides: the reference's params converted with
``zoo_params_from_numpy`` and numpy-seeded tokens.  The teacher-forced
forward, a prefill and 4 decode steps (recurrent states handed over),
and 3 train steps at microbatches 1 and 2 agree with the reference;
decode reproduces the port's own teacher-forced forward; the configs and
their parameter counts are the reference's; the convert keeps float32
SSM leaves beside bf16 weights; ``serve.setup`` cuts jamba's 8-layer
pattern to the depth it is given; the serving CLI prints the reference
CLI's greedy ids on xlstm.
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
    ATTN,
    FFN_DENSE,
    FFN_MOE,
    MAMBA,
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
from repro_torch.models import rope  # noqa: E402
from repro_torch.models.model import (  # noqa: E402
    Model,
    forward,
    init_caches,
    init_params,
    logits_fn,
    make_prefill_step,
    make_serve_step,
    make_train_step,
)
from repro_torch.optim.adamw import AdamWConfig, tree_leaves  # noqa: E402

ATOL = 1e-4  # float32 logits through 2-3 layers, two frameworks' sum orders
ARCHS = ("jamba-1.5-large-398b", "xlstm-125m")


@pytest.fixture(scope="module")
def ref():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    import repro.core  # noqa: F401  (import order: see tests/test_torch_fleet.py)
    from repro.configs.base import get_config as ref_get_config
    from repro.configs.base import param_count as ref_param_count
    from repro.launch import serve as ref_serve
    from repro.models import model as ref_model
    from repro.models.sharding import ShardingPolicy
    from repro.optim import adamw as ref_adamw

    return SimpleNamespace(
        jax=jax,
        jnp=jnp,
        get_config=ref_get_config,
        param_count=ref_param_count,
        serve=ref_serve,
        model=ref_model,
        policy=ShardingPolicy,
        adamw=ref_adamw,
    )


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _state(ref, arch, seed=0):
    """(reference cfg, reference train state, the port's converted one)."""
    rcfg = ref.get_config(arch + "-smoke")
    opt = ref.adamw.AdamWConfig()
    rstate = ref.model.init_train_state(rcfg, ref.jax.random.PRNGKey(seed), opt)
    tree = ref.jax.tree_util.tree_map(np.asarray, rstate)
    return rcfg, rstate, zoo_train_state_from_numpy(tree)


def _tokens(cfg, rng, b, s):
    return rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


# -- configs -----------------------------------------------------------------------
def test_configs_are_the_reference_copies(ref):
    assert set(ARCHS) <= set(list_configs())
    for arch in ARCHS:
        for name in (arch, arch + "-smoke"):
            got, want = get_config(name), ref.get_config(name)
            assert_reference_copy(got, want)
            assert param_count(got) == ref.param_count(want)
    assert param_count(get_config("jamba-1.5-large-398b"))[0] == 398_551_859_200
    assert param_count(get_config("xlstm-125m"))[0] == 164_643_840


def test_setup_cuts_jamba_to_the_first_layers_of_its_pattern(monkeypatch):
    """``setup(n_layers=4)`` keeps the first half of one 8-layer Jamba
    block (every block kind), widths untouched; the reference's
    ``param_count`` on the cut config is 23.02 B at full width.  Drawn
    here at reduced widths with the full pattern (the real one is 46 GB)."""
    full = get_config("jamba-1.5-large-398b")
    want = ((MAMBA, FFN_MOE), (MAMBA, FFN_DENSE), (MAMBA, FFN_MOE), (ATTN, FFN_DENSE))
    cut = serve.cut_depth(full, 4)
    assert cut.pattern == want and cut.layer_pattern == want
    assert (cut.d_model, cut.n_heads, cut.moe) == (full.d_model, full.n_heads, full.moe)
    assert param_count(cut)[0] == 23_021_207_552
    assert serve.cut_depth(full, 16).pattern == full.pattern  # two whole blocks
    narrow = dataclasses.replace(full.reduced(), pattern=full.pattern, n_layers=8)
    monkeypatch.setattr(serve, "get_config", lambda name: narrow)
    model, params, prompt = serve.setup(full.name, 2, 16, 0, "cpu", n_layers=4)
    assert model.cfg.pattern == want and model.cfg.n_groups == 1
    assert sorted(params["groups"]) == ["b0", "b1", "b2", "b3"]
    assert "a_log" in params["groups"]["b0"]["mixer"]
    assert "wq" in params["groups"]["b3"]["mixer"]
    assert prompt.shape == (2, 16)
    out = serve.generate(model, params, prompt, 3)
    assert bool(torch.isfinite(out.logits).all())


# -- the model ---------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(ref, rng, arch):
    """The teacher-forced forward over 40 tokens at the published capacity
    factor: logits at 1e-4, jamba's summed router loss at 1e-5."""
    rcfg, rstate, state = _state(ref, arch)
    rparams, params = rstate["params"], state["params"]
    cfg = get_config(arch + "-smoke")
    toks = _tokens(cfg, rng, 2, 40)
    pos = rope.positions_for(cfg, 2, 40)
    h_ref, aux_ref, _ = ref.model.forward(
        rcfg, rparams, ref.jnp.asarray(toks), ref.jnp.asarray(pos.numpy()),
        mode="train",
    )  # fmt: skip
    want = ref.model.logits_fn(rcfg, rparams, h_ref)
    with torch.no_grad():
        h, aux, caches = forward(cfg, params, torch.from_numpy(toks), pos, mode="train")
    assert caches is None
    np.testing.assert_allclose(
        _np(logits_fn(cfg, params, h)), _np(want), atol=ATOL, rtol=0
    )
    assert float(aux) == pytest.approx(float(aux_ref), rel=1e-5, abs=1e-6)
    assert (float(aux) > 0) == bool(cfg.moe.n_experts)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(ref, rng, arch):
    """A prefill of 40 tokens (its recurrent states handed to decode as the
    reference's ``_load_prefill`` hands them), then 4 decode steps fed the
    same tokens on both sides."""
    rcfg, rstate, state = _state(ref, arch, seed=1)
    rparams, params = rstate["params"], state["params"]
    cfg = get_config(arch + "-smoke")
    b, s, steps = 2, 40, 4
    toks = _tokens(cfg, rng, b, s + steps)
    last_ref, pre_ref = ref.model.make_prefill_step(rcfg)(
        rparams, {"tokens": ref.jnp.asarray(toks[:, :s])}
    )
    caches_ref = ref.serve._load_prefill(
        rcfg, ref.model.init_caches(rcfg, b, s + steps), pre_ref, s
    )
    with torch.no_grad():
        prompt = {"tokens": torch.from_numpy(toks[:, :s])}
        last, pre = make_prefill_step(cfg)(params, prompt)
    np.testing.assert_allclose(_np(last), _np(last_ref), atol=ATOL, rtol=0)
    caches = serve.load_prefill(init_caches(cfg, b, s + steps, "cpu"), pre)
    step_ref, step = ref.model.make_serve_step(rcfg), make_serve_step(cfg)
    for i in range(steps):
        x = toks[:, s + i : s + i + 1]
        pos = np.full((b,), s + i, np.int32)
        batch_ref = {"tokens": ref.jnp.asarray(x), "pos": ref.jnp.asarray(pos)}
        lg_ref, caches_ref = step_ref(rparams, caches_ref, batch_ref)
        batch = {"tokens": torch.from_numpy(x), "pos": torch.from_numpy(pos)}
        with torch.no_grad():
            lg, caches = step(params, caches, batch)
        np.testing.assert_allclose(_np(lg), _np(lg_ref), atol=ATOL, rtol=0)
    # the states decode wrote in place are the reference's after 4 steps
    got = zoo_params_to_numpy(caches["groups"])
    want = ref.jax.tree_util.tree_map(np.asarray, caches_ref["groups"])
    for key in got:
        if "kpos" in got[key]:
            continue  # jamba's attention cache: its logits hold it above
        for leaf in got[key]:
            scale = max(float(np.abs(_np(want[key][leaf])).max()), 1.0)
            err = float(np.abs(_np(got[key][leaf]) - _np(want[key][leaf])).max())
            assert err <= 1e-5 * scale, (key, leaf, err)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_teacher_forcing(rng, arch):
    """Token-by-token decode from empty caches reproduces the port's own
    teacher-forced forward at 1e-4; jamba's MoE at capacity factor 16,
    where no pair is dropped."""
    cfg = get_config(arch + "-smoke")
    if cfg.moe.n_experts:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=16.0)
        )
    params = init_params(cfg, torch.Generator().manual_seed(1))
    s = 20
    toks = torch.from_numpy(_tokens(cfg, rng, 2, s))
    pos = rope.positions_for(cfg, 2, s)
    with torch.no_grad():
        full = logits_fn(cfg, params, forward(cfg, params, toks, pos, mode="train")[0])
        step, caches = make_serve_step(cfg), init_caches(cfg, 2, s + 1, "cpu")
        for t in range(s):
            batch = {"tokens": toks[:, t : t + 1], "pos": torch.full((2,), t)}
            lg, caches = step(params, caches, batch)
            np.testing.assert_allclose(_np(lg), _np(full[:, t]), atol=ATOL, rtol=0)


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_match_reference(ref, arch, microbatches):
    """Three steps from the reference's init on the same batches: loss, aux,
    total and grad_norm within 1e-5 relative each step, params within 1e-4
    after the third (as tests/test_torch_lm_train_moe.py holds the MoE
    configs)."""
    rcfg, rstate, state = _state(ref, arch, seed=2)
    cfg = get_config(arch + "-smoke")
    opt = ref.adamw.AdamWConfig()
    policy = ref.policy(microbatches=microbatches)
    rstep = ref.jax.jit(ref.model.make_train_step(rcfg, opt, policy=policy))
    step = make_train_step(cfg, AdamWConfig(), microbatches=microbatches)
    rng = np.random.default_rng(7)
    for _ in range(3):
        labels = _tokens(cfg, rng, 4, 32)
        labels[0, :5] = -1
        batch = {"tokens": _tokens(cfg, rng, 4, 32), "labels": labels}
        rstate, rm = rstep(rstate, {k: ref.jnp.asarray(v) for k, v in batch.items()})
        state, m = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
        assert float(m["n_tokens"]) == float(rm["n_tokens"]) == 4 * 32 - 5
        for key in ("loss", "aux", "total", "grad_norm"):
            want = float(rm[key])
            assert float(m[key]) == pytest.approx(want, rel=1e-5, abs=1e-7), key
    got = tree_leaves(state["params"])
    want = ref.jax.tree_util.tree_leaves(rstate["params"])
    assert len(got) == len(want)
    for g, w in zip(got, want, strict=True):
        np.testing.assert_allclose(_np(g), _np(w), atol=1e-4, rtol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_convert_keeps_the_ssm_leaves(ref, arch):
    """A bf16 tree: Mamba's ``a_log`` and ``d_skip`` stay float32 beside
    bf16 weights, sLSTM's ``r_h`` keeps its ``[G, 4, H, dh, dh]`` layout
    (no transpose), the AdamW moments cover every leaf in float32, and
    the params come back bit for bit."""
    rcfg = dataclasses.replace(ref.get_config(arch + "-smoke"), dtype="bfloat16")
    rstate = ref.model.init_train_state(
        rcfg, ref.jax.random.PRNGKey(0), ref.adamw.AdamWConfig()
    )
    tree = ref.jax.tree_util.tree_map(np.asarray, rstate)
    state = zoo_train_state_from_numpy(tree)
    groups = state["params"]["groups"]
    if arch.startswith("jamba"):
        mixer = groups["b0"]["mixer"]
        assert mixer["a_log"].dtype == mixer["d_skip"].dtype == torch.float32
        assert mixer["in_proj"]["w"].dtype == torch.bfloat16
        np.testing.assert_array_equal(
            mixer["a_log"].numpy(), tree["params"]["groups"]["b0"]["mixer"]["a_log"]
        )
    else:
        r_h = groups["b1"]["mixer"]["r_h"]
        cfg = get_config(arch + "-smoke")
        dh = cfg.d_model // cfg.n_heads
        assert tuple(r_h.shape) == (1, 4, cfg.n_heads, dh, dh)
        assert r_h.dtype == torch.bfloat16
        assert sorted(groups["b0"]) == ["mixer", "norm1"]  # no FFN, no norm2
    params = tree_leaves(state["params"])
    for key in ("m", "v"):
        moments = tree_leaves(state["opt"][key])
        assert [t.shape for t in moments] == [t.shape for t in params]
        assert {t.dtype for t in moments} == {torch.float32}
    back = ref.jax.tree_util.tree_leaves(zoo_params_to_numpy(state["params"]))
    want = ref.jax.tree_util.tree_leaves(tree["params"])
    assert len(back) == len(want)
    for g, w in zip(back, want, strict=True):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()


def test_serve_cli_greedy_ids_match_reference_on_xlstm(ref, capsys, monkeypatch):
    """``launch.serve`` on xlstm-125m-smoke with the reference's init
    patched in on both sides prints the reference CLI's greedy ids (the
    recurrent states handed from the prefill to 6 decode steps).  The
    train CLI on xlstm: tests/test_torch_lm_train.py."""
    arch = "xlstm-125m-smoke"
    rparams = ref.model.init_params(ref.get_config(arch), ref.jax.random.PRNGKey(0))
    params = zoo_params_from_numpy(ref.jax.tree_util.tree_map(np.asarray, rparams))
    monkeypatch.setattr(Model, "init_params", lambda self, seed: params)
    monkeypatch.setattr(ref.serve, "init_params", lambda cfg, key: rparams)
    argv = ["--arch", arch, "--batch", "2", "--prompt-len", "24", "--gen", "6"]
    assert serve.main([*argv, "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert ref.serve.main(argv) == 0
    ref_out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("prefill [2x24] in ")
    assert out[-1] == ref_out[-1] and out[-1].startswith("sample token ids:")
