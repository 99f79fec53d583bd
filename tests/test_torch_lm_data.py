"""The LM training slice's host side against the reference: the synthetic
token streams and LM task ERBs (numpy copies: identical), and checkpoints
that cross between the packages both ways (keys equal, values bit for bit,
bfloat16 leaves included)."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
jax = pytest.importorskip("jax")

import repro.core  # noqa: E402,F401  (the reference's own import order)
from repro.checkpoint import ckpt as ref_ckpt  # noqa: E402
from repro.configs.base import get_config as ref_get_config  # noqa: E402
from repro.data import pipeline as ref_pipeline  # noqa: E402
from repro.models import model as ref_model  # noqa: E402
from repro.optim.adamw import AdamWConfig as RefAdamWConfig  # noqa: E402
from repro_torch.checkpoint import restore_pytree, save_pytree  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    zoo_params_to_numpy,
    zoo_train_state_from_numpy,
)
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.launch.specs import opt_cfg_for  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402


@pytest.mark.parametrize("style", [0, 3])
def test_token_batches_are_the_reference_stream(style):
    kw = dict(vocab_size=97, seq_len=33, batch_size=3, seed=5)
    cfg, rcfg = pipeline.TokenStreamConfig(**kw), ref_pipeline.TokenStreamConfig(**kw)
    ours = pipeline.token_batches(cfg, style)
    theirs = ref_pipeline.token_batches(rcfg, style)
    for _ in range(4):
        a, b = next(ours), next(theirs)
        assert a.keys() == b.keys() == {"tokens", "labels"}
        for k in a:
            assert a[k].dtype == b[k].dtype == np.int32
            np.testing.assert_array_equal(a[k], b[k])
    shards = pipeline.federated_shards(cfg, 3)
    ref_shards = ref_pipeline.federated_shards(rcfg, 3)
    for a, b in zip(shards, ref_shards, strict=True):
        np.testing.assert_array_equal(next(a)["tokens"], next(b)["tokens"])


def test_lm_task_erb_is_the_reference_erb():
    kw = dict(vocab_size=64, seq_len=16, batch_size=2, seed=1)
    cfg, rcfg = pipeline.TokenStreamConfig(**kw), ref_pipeline.TokenStreamConfig(**kw)
    erb = pipeline.lm_task_erb(cfg, 2, 3, source_agent=4, round_idx=1)
    ref = ref_pipeline.lm_task_erb(rcfg, 2, 3, source_agent=4, round_idx=1)
    assert (erb.capacity, erb.size, erb.cursor) == (ref.capacity, ref.size, ref.cursor)
    assert erb.capacity == 6
    for k in ("tokens", "labels"):
        np.testing.assert_array_equal(erb.data[k], ref.data[k])
    m, rm = erb.meta, ref.meta
    assert (m.source_agent, m.round_idx, m.size) == (4, 1, 6)
    assert (rm.source_agent, rm.round_idx, rm.size) == (4, 1, 6)
    assert dataclasses.astuple(m.task) == dataclasses.astuple(rm.task)
    assert m.erb_id.startswith("LMERB")


def _ref_state(opt_dtype):
    rcfg = ref_get_config("qwen2.5-14b-smoke")
    opt = RefAdamWConfig(opt_dtype=opt_dtype)
    return ref_model.init_train_state(rcfg, jax.random.PRNGKey(2), opt)


def _equal_bits(port_tree, ref_tree):
    """Every leaf of the port's tree equal bit for bit to the reference's."""
    flat = jax.tree_util.tree_flatten_with_path(ref_tree)[0]
    got = jax.tree_util.tree_leaves(zoo_params_to_numpy(port_tree))
    assert len(got) == len(flat)
    for g, (path, w) in zip(got, flat, strict=True):
        w = np.asarray(w)
        assert g.shape == w.shape, path
        assert g.tobytes() == w.tobytes(), path


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoints_cross_load_both_ways(tmp_path, dtype):
    """A bf16 model (params and moments) and a float32 one: the reference's
    file restores into the port, the port's into the reference, keys equal,
    values bit for bit."""
    rstate = _ref_state("bfloat16" if dtype == "bfloat16" else "float32")
    if dtype == "bfloat16":
        rstate = jax.tree_util.tree_map(
            lambda x: x.astype(jax.numpy.bfloat16) if x.dtype == np.float32 else x,
            rstate,
        )
    # give the moments values: an init's are zero
    rstate["opt"]["m"] = jax.tree_util.tree_map(lambda p: p * 3, rstate["params"])
    state = zoo_train_state_from_numpy(jax.tree_util.tree_map(np.asarray, rstate))
    like = jax.tree_util.tree_map(lambda x: x, rstate)

    theirs, ours = str(tmp_path / "ref.npz"), str(tmp_path / "port")
    ref_ckpt.save_pytree(theirs, rstate)
    save_pytree(ours, state)
    assert (tmp_path / "port").exists() and not (tmp_path / "port.npz").exists()
    with np.load(theirs) as a, np.load(ours) as b:
        assert sorted(a.files) == sorted(b.files)
        assert "params|groups|b0|mixer|wq|b" in b.files
    # reference file -> port
    zeros = {
        "params": _zeros_like(state["params"]),
        "opt": {
            "m": _zeros_like(state["opt"]["m"]),
            "v": _zeros_like(state["opt"]["v"]),
            "count": torch.zeros((), dtype=torch.int32),
        },
    }
    got = restore_pytree(theirs, zeros)
    _equal_bits(got["params"], rstate["params"])
    _equal_bits(got["opt"]["m"], rstate["opt"]["m"])
    _equal_bits(got["opt"]["v"], rstate["opt"]["v"])
    assert int(got["opt"]["count"]) == int(rstate["opt"]["count"])
    # port file -> reference
    back = ref_ckpt.restore_pytree(ours, like)
    leaves = zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(rstate))
    for a, b in leaves:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    with pytest.raises(ValueError, match="shape mismatch"):
        restore_pytree(ours, {"params": {"final_norm": {"scale": torch.zeros(3)}}})


def _zeros_like(tree):
    if isinstance(tree, dict):
        return {k: _zeros_like(v) for k, v in tree.items()}
    return torch.zeros_like(tree)


def test_opt_cfg_for_is_the_reference_rule():
    from repro.launch.specs import opt_cfg_for as ref_opt_cfg_for

    for name in ("h2o-danube-3-4b", "qwen2.5-14b", "starcoder2-15b"):
        got = opt_cfg_for(get_config(name))
        want = ref_opt_cfg_for(ref_get_config(name))
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.opt_dtype == "float32"
    # the reference's rule: bf16 moments above 1e11 parameters
    big = dataclasses.replace(get_config("qwen2.5-14b"), n_layers=400)
    assert opt_cfg_for(big).opt_dtype == "bfloat16"
    cfg = get_config("h2o-danube-3-4b-smoke")
    state = Model(cfg, "cpu", opt_cfg=opt_cfg_for(big)).init_train_state(0)
    assert state["opt"]["m"]["embed"]["tok"].dtype == torch.bfloat16
    assert state["params"]["embed"]["tok"].dtype == torch.float32
