"""The port's DQN forward against the reference's, from one set of params.

Both sides get the reference's init (JAX threefry bits cannot be drawn in
torch), converted with ``repro_torch.convert``, and the same numpy
inputs.  Tolerance 1e-5: float32 convolutions and matmuls summed in a
different order by XLA:CPU and PyTorch's CPU kernels.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: these sizes gain nothing from more, and spinning
# OpenMP threads in parallel test workers would starve the other tests
torch.set_num_threads(1)
jax = pytest.importorskip("jax")

from repro.configs.adfll_dqn import DQNConfig as JaxDQNConfig  # noqa: E402
from repro.rl.dqn import dqn_apply as jax_dqn_apply  # noqa: E402
from repro.rl.dqn import dqn_init as jax_dqn_init  # noqa: E402
from repro_torch.configs.adfll_dqn import DQNConfig  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    dqn_params_from_numpy,
    dqn_params_to_numpy,
)
from repro_torch.rl.dqn import dqn_apply, dqn_apply_stacked, dqn_init  # noqa: E402

CONFIGS = {
    # the full width the repo supports: 8^3 box, convs (8, 16, 32)
    "default": {},
    # 6 -> 3 -> 2: the second conv sees an odd size and pads (1, 1)
    "box6": dict(box_size=(6, 6, 6), conv_features=(4, 8), hidden=(32,)),
    # odd from the start: 5 -> 3 -> 2
    "box5": dict(box_size=(5, 5, 5), conv_features=(4, 8), hidden=(16, 8)),
}


def _pair(**kw):
    return JaxDQNConfig(**kw), DQNConfig(**kw)


def _jax_params(jcfg, seed):
    return jax.tree_util.tree_map(
        np.asarray, jax_dqn_init(jax.random.PRNGKey(seed), jcfg)
    )


def _inputs(cfg, b, seed):
    rng = np.random.default_rng(seed)
    obs = rng.random((b, *cfg.box_size)).astype(np.float32)
    loc = rng.random((b, 3)).astype(np.float32)
    return obs, loc


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_dqn_apply_matches_reference(name):
    jcfg, cfg = _pair(**CONFIGS[name])
    tree = _jax_params(jcfg, seed=1)
    obs, loc = _inputs(cfg, 16, seed=2)
    ref = np.asarray(jax_dqn_apply(jcfg, tree, obs, loc))
    got = dqn_apply(
        cfg, dqn_params_from_numpy(tree), torch.from_numpy(obs), torch.from_numpy(loc)
    )
    assert got.shape == ref.shape == (16, cfg.n_actions)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=0)


def test_dqn_apply_padding_trap():
    """Symmetric padding (``conv3d(padding=1)``) is not the reference: it
    gives the same output sizes on shifted windows.  The port's
    asymmetric SAME pad is what makes the parity hold."""
    jcfg, cfg = _pair()
    tree = _jax_params(jcfg, seed=3)
    obs, loc = _inputs(cfg, 4, seed=4)
    ref = np.asarray(jax_dqn_apply(jcfg, tree, obs, loc))
    p = dqn_params_from_numpy(tree)
    conv3d = torch.nn.functional.conv3d
    x = torch.from_numpy(obs)[:, None]
    for i in range(len(cfg.conv_features)):
        x = torch.relu(conv3d(x, p[f"conv{i}"]["w"], p[f"conv{i}"]["b"], 2, 1))
    lh = torch.relu(torch.from_numpy(loc) @ p["loc"]["w"] + p["loc"]["b"])
    x = torch.cat([x.flatten(1), lh], -1)
    for i in range(3):
        x = x @ p[f"fc{i}"]["w"] + p[f"fc{i}"]["b"]
        x = torch.relu(x) if i < 2 else x
    assert np.abs(x.numpy() - ref).max() > 1e-3
    got = dqn_apply(cfg, p, torch.from_numpy(obs), torch.from_numpy(loc))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("name", ["default", "box5"])
def test_stacked_forward_matches_per_agent(name):
    """Lane i of the grouped-conv/bmm forward is agent i's own forward.
    Tolerance 1e-6: grouped and single convolutions may pick different
    CPU algorithms (summation order)."""
    jcfg, cfg = _pair(**CONFIGS[name])
    trees = [_jax_params(jcfg, seed=10 + i) for i in range(3)]
    stacked = dqn_params_from_numpy(
        jax.tree_util.tree_map(lambda *xs: np.stack(xs), *trees)
    )
    obs = np.stack([_inputs(cfg, 8, seed=20 + i)[0] for i in range(3)])
    loc = np.stack([_inputs(cfg, 8, seed=20 + i)[1] for i in range(3)])
    q = dqn_apply_stacked(cfg, stacked, torch.from_numpy(obs), torch.from_numpy(loc))
    assert q.shape == (3, 8, cfg.n_actions)
    for i, tree in enumerate(trees):
        one = dqn_apply(
            cfg,
            dqn_params_from_numpy(tree),
            torch.from_numpy(obs[i]),
            torch.from_numpy(loc[i]),
        )
        np.testing.assert_allclose(q[i].numpy(), one.numpy(), atol=1e-6, rtol=0)


@pytest.mark.parametrize("stacked", [False, True])
def test_conversion_round_trip_is_exact(stacked):
    jcfg, _ = _pair()
    tree = _jax_params(jcfg, seed=5)
    if stacked:
        tree = jax.tree_util.tree_map(lambda x: np.stack([x, 2 * x]), tree)
    p = dqn_params_from_numpy(tree)
    lead = (2,) if stacked else ()
    assert p["conv0"]["w"].shape == (*lead, 8, 1, 3, 3, 3)  # OIDHW
    back = dqn_params_to_numpy(p)
    flat_a = jax.tree_util.tree_leaves(tree)
    flat_b = jax.tree_util.tree_leaves(back)
    assert len(flat_a) == len(flat_b)
    for a, b in zip(flat_a, flat_b):
        assert a.shape == b.shape and np.array_equal(a, b)


def test_own_init_distribution():
    """The port's own init: the reference's shapes, zero biases, and a
    truncated normal on [-2, 2] x scale (std of that law = 0.8796 x scale)."""
    jcfg, cfg = _pair()
    ref = _jax_params(jcfg, seed=0)
    p = dqn_init(cfg, torch.Generator().manual_seed(0))
    back = dqn_params_to_numpy(p)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(ref)
    for (layer, leaves), (_, ref_leaves) in zip(
        sorted(back.items()), sorted(ref.items())
    ):
        assert leaves["w"].shape == ref_leaves["w"].shape
        assert not leaves["b"].any()
        w = leaves["w"]
        fan_in = w.shape[3] * 27 if layer.startswith("conv") else w.shape[0]
        scale = fan_in**-0.5
        assert np.abs(w).max() <= 2 * scale * (1 + 1e-6)
        if w.size >= 4096:
            assert abs(w.std() / scale - 0.8796) < 0.05
    again = dqn_params_to_numpy(dqn_init(cfg, torch.Generator().manual_seed(0)))
    leaves = jax.tree_util.tree_leaves
    assert all(np.array_equal(a, b) for a, b in zip(leaves(back), leaves(again)))


def test_configs_are_verbatim_copies():
    """The port keeps its own copy of the configs; field for field the
    same defaults as the reference's."""
    from repro.configs.adfll_dqn import ADFLLConfig as JaxADFLLConfig
    from repro_torch.configs.adfll_dqn import ADFLLConfig

    assert dataclasses.asdict(DQNConfig()) == dataclasses.asdict(JaxDQNConfig())
    assert dataclasses.asdict(ADFLLConfig()) == dataclasses.asdict(JaxADFLLConfig())
