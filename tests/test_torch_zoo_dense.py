"""qwen2.5-14b and starcoder2-15b, the zoo's other dense GQA configs,
against the reference on the CPU, and the stacked init.

Both configs are ``(ATTN, FFN_DENSE)`` like h2o-danube-3-4b but run the
code danube does not: the q/k/v biases (both), LayerNorm and the tanh
GELU MLP with biases (starcoder2), no window.  Their reduced configs (2
layers, d_model 256, float32) take the reference's params, converted,
and numpy-seeded tokens: the teacher-forced forward, then a prefill and
4 decode steps, agree within the zoo's 1e-4.

``init_params`` allocates each stacked ``[G, ...]`` leaf once and draws
group ``g`` into slice ``[g]``: the same bits as drawing every group and
stacking them, in the same order of generator draws.
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
    get_config,
    list_configs,
    param_count,
)
from repro_torch.convert import zoo_params_from_numpy  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models.blocks import block_init  # noqa: E402
from repro_torch.models.layers import embed_init, norm_init  # noqa: E402
from repro_torch.models.model import (  # noqa: E402
    forward,
    init_caches,
    init_params,
    logits_fn,
    make_prefill_step,
    make_serve_step,
)

ATOL = 1e-4  # float32 logits through 2 layers, two frameworks' sum orders
ARCHS = ("qwen2.5-14b", "starcoder2-15b")


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

    return SimpleNamespace(
        jax=jax,
        jnp=jnp,
        get_config=ref_get_config,
        param_count=ref_param_count,
        serve=ref_serve,
        model=ref_model,
    )


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _params(ref, arch, seed=0):
    rcfg = ref.get_config(arch + "-smoke")
    rparams = ref.model.init_params(rcfg, ref.jax.random.PRNGKey(seed))
    tree = ref.jax.tree_util.tree_map(np.asarray, rparams)
    return rcfg, rparams, zoo_params_from_numpy(tree)


def test_configs_are_the_reference_copies(ref):
    """The reference's ten and the port's own four are registered; each of
    the ten is the reference's copy (its keys; the port's own fields at
    their defaults)."""
    assert list_configs() == sorted(
        [
            "deepseek-v2-lite-16b",
            "h2o-danube-3-4b",
            "jamba-1.5-large-398b",
            "moonshot-v1-16b-a3b",
            "musicgen-medium",
            "qwen2-vl-2b",
            "qwen2.5-14b",
            "qwen3-moe-235b-a22b",
            "starcoder2-15b",
            "xlstm-125m",
            "kimi-linear-48b-a3b",
            "kimi-linear-48b-a3b-ep4",
            "xing4.0-29b-a4b",
            "xing4.0-29b-a4b-ep4",
        ]
    )
    for arch in ASSIGNED:
        for name in (arch, arch + "-smoke"):
            assert_reference_copy(get_config(name), ref.get_config(name))
    for arch in ARCHS:
        for name in (arch, arch + "-smoke"):
            got, want = get_config(name), ref.get_config(name)
            assert_reference_copy(got, want)
            assert param_count(got) == ref.param_count(want)
    assert param_count(get_config("qwen2.5-14b"))[0] == 14_769_192_960
    assert param_count(get_config("starcoder2-15b"))[0] == 15_955_132_416


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(ref, rng, arch):
    rcfg, rparams, params = _params(ref, arch)
    cfg = get_config(arch + "-smoke")
    toks = rng.integers(0, cfg.vocab_size, (2, 80)).astype(np.int32)
    pos = np.broadcast_to(np.arange(80, dtype=np.int32), (2, 80))
    h_ref, _, _ = ref.model.forward(
        rcfg, rparams, ref.jnp.asarray(toks), ref.jnp.asarray(pos), mode="train"
    )
    want = ref.model.logits_fn(rcfg, rparams, h_ref)
    tt, pt = torch.from_numpy(toks), torch.from_numpy(pos.copy())
    h, _, _ = forward(cfg, params, tt, pt, mode="train")
    np.testing.assert_allclose(
        _np(logits_fn(cfg, params, h)), _np(want), atol=ATOL, rtol=0
    )


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(ref, rng, arch):
    """A prefill of 40 tokens, then 4 decode steps fed the same tokens."""
    rcfg, rparams, params = _params(ref, arch, seed=1)
    cfg = get_config(arch + "-smoke")
    b, s, steps = 2, 40, 4
    toks = rng.integers(0, cfg.vocab_size, (b, s + steps)).astype(np.int32)
    last_ref, pre_ref = ref.model.make_prefill_step(rcfg)(
        rparams, {"tokens": ref.jnp.asarray(toks[:, :s])}
    )
    caches_ref = ref.serve._load_prefill(
        rcfg, ref.model.init_caches(rcfg, b, s + steps), pre_ref, s
    )
    prompt = {"tokens": torch.from_numpy(toks[:, :s])}
    last, pre = make_prefill_step(cfg)(params, prompt)
    np.testing.assert_allclose(_np(last), _np(last_ref), atol=ATOL, rtol=0)
    caches = serve.load_prefill(init_caches(cfg, b, s + steps, "cpu"), pre)
    step_ref, step = ref.model.make_serve_step(rcfg), make_serve_step(cfg)
    for i in range(steps):
        tok = toks[:, s + i : s + i + 1]
        pos = np.full((b,), s + i, np.int32)
        batch_ref = {"tokens": ref.jnp.asarray(tok), "pos": ref.jnp.asarray(pos)}
        lg_ref, caches_ref = step_ref(rparams, caches_ref, batch_ref)
        batch = {"tokens": torch.from_numpy(tok), "pos": torch.from_numpy(pos)}
        lg, caches = step(params, caches, batch)
        np.testing.assert_allclose(_np(lg), _np(lg_ref), atol=ATOL, rtol=0)


def _old_init(cfg, generator):
    """The init as it was: every group drawn as its own tree, then stacked."""
    params = {
        "embed": embed_init(cfg, generator),
        "final_norm": norm_init(cfg, cfg.d_model, generator.device),
    }
    groups = [
        {
            f"b{j}": block_init(cfg, mixer, ffn, generator)
            for j, (mixer, ffn) in enumerate(cfg.pattern)
        }
        for _ in range(cfg.n_groups)
    ]

    def stack(trees):
        if isinstance(trees[0], dict):
            return {k: stack([t[k] for t in trees]) for k in trees[0]}
        return torch.stack(trees)

    params["groups"] = stack(groups)
    return params


@pytest.mark.parametrize("arch", ["h2o-danube-3-4b", *ARCHS])
def test_stacked_init_is_bit_for_bit_the_old_one(arch):
    cfg = dataclasses.replace(get_config(arch + "-smoke"), n_layers=3)
    got = init_params(cfg, torch.Generator().manual_seed(11))
    want = _old_init(cfg, torch.Generator().manual_seed(11))

    def check(a, b):
        if isinstance(b, dict):
            assert a.keys() == b.keys()
            for k in b:
                check(a[k], b[k])
        else:
            assert a.dtype == b.dtype and a.is_contiguous()
            assert torch.equal(a, b)

    check(got, want)
    assert got["groups"]["b0"]["ffn"]["wi"]["w"].shape[0] == 3


def test_stacked_caches_are_the_reference_layout(ref):
    cfg = get_config("qwen2.5-14b-smoke")
    caches = init_caches(cfg, 2, 10, "cpu")
    want = ref.model.init_caches(ref.get_config("qwen2.5-14b-smoke"), 2, 10)
    for name in ("k", "v", "kpos"):
        got = caches["groups"]["b0"][name]
        want_leaf = np.asarray(want["groups"]["b0"][name])
        np.testing.assert_array_equal(got.numpy(), want_leaf)
    # one tensor a leaf: writing group 0 leaves group 1 alone
    caches["groups"]["b0"]["kpos"][0].fill_(3)
    assert int(caches["groups"]["b0"]["kpos"][1].max()) == -1
