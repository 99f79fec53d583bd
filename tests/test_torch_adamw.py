"""The port's stacked AdamW against the reference's ``adamw_update`` run
per slot, with the DQN's optimizer settings (``clip_norm=10``, no decay,
no warmup).  Tolerance 1e-6: the per-agent gradient norm is summed in a
different order by XLA and PyTorch, which moves the clip scale and the
update by a few float32 ulps.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: these sizes gain nothing from more, and spinning
# OpenMP threads in parallel test workers would starve the other tests
torch.set_num_threads(1)
jax = pytest.importorskip("jax")

import repro.core  # noqa: E402, F401  (the reference's own import order)
from repro.configs.adfll_dqn import DQNConfig as JaxDQNConfig  # noqa: E402
from repro.optim.adamw import adamw_init as jax_adamw_init  # noqa: E402
from repro.optim.adamw import adamw_update as jax_adamw_update  # noqa: E402
from repro.rl.dqn import dqn_init as jax_dqn_init  # noqa: E402
from repro.rl.fleet import make_dqn_opt_cfg as jax_opt_cfg  # noqa: E402
from repro_torch.configs.adfll_dqn import DQNConfig  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    adamw_state_to_numpy,
    dqn_params_from_numpy,
    dqn_params_to_numpy,
)
from repro_torch.optim.adamw import adamw_init, adamw_update  # noqa: E402
from repro_torch.rl.dqn import dqn_init  # noqa: E402
from repro_torch.rl.fleet import make_dqn_opt_cfg  # noqa: E402

N = 3
KW = dict(box_size=(6, 6, 6), conv_features=(4, 8), hidden=(16,))


def _stack(trees):
    return jax.tree_util.tree_map(lambda *xs: np.stack(xs), *trees)


def _grads(rng, like, scales):
    """Per-slot random gradients; slot i scaled by ``scales[i]``."""
    return [
        jax.tree_util.tree_map(
            lambda x, s=s: (s * rng.standard_normal(x.shape)).astype(np.float32), like
        )
        for s in scales
    ]


def _norm(tree) -> float:
    return float(
        np.sqrt(sum(np.sum(np.square(x)) for x in jax.tree_util.tree_leaves(tree)))
    )


@pytest.mark.parametrize("n_updates", [1, 5])
def test_stacked_adamw_matches_reference_per_slot(n_updates):
    jcfg, cfg = JaxDQNConfig(**KW), DQNConfig(**KW)
    jopt, opt_cfg = jax_opt_cfg(jcfg), make_dqn_opt_cfg(cfg)
    assert jopt.clip_norm == opt_cfg.clip_norm == 10.0
    rng = np.random.default_rng(0)
    ref_p = [
        jax.tree_util.tree_map(np.asarray, jax_dqn_init(jax.random.PRNGKey(i), jcfg))
        for i in range(N)
    ]
    ref_o = [jax_adamw_init(jopt, p) for p in ref_p]
    params = dqn_params_from_numpy(_stack(ref_p))
    opt = adamw_init(params)
    clipped = False
    for _ in range(n_updates):
        # slot 1's gradient norm is far above clip_norm: the clip is active
        gs = _grads(rng, ref_p[0], scales=(0.01, 5.0, 0.3))
        clipped |= _norm(gs[1]) > 10.0
        for i in range(N):
            ref_p[i], ref_o[i], _ = jax_adamw_update(jopt, ref_p[i], gs[i], ref_o[i])
        params, opt, gnorm = adamw_update(
            opt_cfg, params, dqn_params_from_numpy(_stack(gs)), opt
        )
        np.testing.assert_allclose(
            gnorm.numpy(), [_norm(g) for g in gs], rtol=1e-5, atol=0
        )
    assert clipped
    got_p = dqn_params_to_numpy(params)
    got_o = adamw_state_to_numpy(opt)
    want_p = _stack([jax.tree_util.tree_map(np.asarray, p) for p in ref_p])
    want_m = _stack([jax.tree_util.tree_map(np.asarray, o["m"]) for o in ref_o])
    want_v = _stack([jax.tree_util.tree_map(np.asarray, o["v"]) for o in ref_o])
    for got, want in ((got_p, want_p), (got_o["m"], want_m), (got_o["v"], want_v)):
        leaves = zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want))
        for a, b in leaves:
            np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)
    assert got_o["count"].tolist() == [n_updates] * N
    assert [int(o["count"]) for o in ref_o] == [n_updates] * N


def test_adamw_leaves_inputs_untouched():
    cfg = DQNConfig(**KW)
    gen = torch.Generator().manual_seed(0)
    p = {k: {n: t[None] for n, t in v.items()} for k, v in dqn_init(cfg, gen).items()}
    before = {k: {n: t.clone() for n, t in v.items()} for k, v in p.items()}
    g = {k: {n: torch.ones_like(t) for n, t in v.items()} for k, v in p.items()}
    opt = adamw_init(p)
    new_p, new_opt, _ = adamw_update(make_dqn_opt_cfg(cfg), p, g, opt)
    for k in p:
        for n in p[k]:
            assert torch.equal(p[k][n], before[k][n])
            assert not torch.equal(new_p[k][n], p[k][n])
    assert int(opt["count"][0]) == 0 and int(new_opt["count"][0]) == 1
