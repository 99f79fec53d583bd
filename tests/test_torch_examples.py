"""The port's examples (``examples/torch_*.py``) against the reference's,
on the CPU, from the reference's inits converted into the port.

- quickstart: the zoo section's loss and router loss after one train
  step of qwen3-moe-235b-a22b-smoke, and the decode logits after it,
  within 1e-4 of the reference's; the ADFLL section's two agent losses
  within 1e-5 (the fleet slots start from the reference's init,
  ``test_torch_baselines.reference_init``); the kernel section.
- federated_lm: three heterogeneous agents, two rounds of 2 steps each
  (the reference's own ``main`` with its ``STEPS_PER_ROUND`` set to 2,
  the same numpy sampling on both sides): the per-style loss table
  within 1e-4 relative.
- train_lm_125m at xlstm-125m-smoke: the checkpoint it writes loads in
  the reference's ``checkpoint/ckpt.py`` into the reference's params.
- adfll_deployment: the summary of a fast ``plane_erb_only`` run.
"""

import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: these sizes gain nothing from more, and spinning
# OpenMP threads in parallel test workers would starve the other tests
torch.set_num_threads(1)
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import repro.core  # noqa: E402,F401  (the reference's own import order)
from repro.configs.adfll_dqn import DQNConfig as JaxDQNConfig  # noqa: E402
from repro.configs.base import get_config as ref_get_config  # noqa: E402
from repro.core.erb import TaskTag as JaxTaskTag  # noqa: E402
from repro.core.hub import Hub as JaxHub  # noqa: E402
from repro.core.network import Network as JaxNetwork  # noqa: E402
from repro.core.plane import WeightPlane as JaxWeightPlane  # noqa: E402
from repro.core.plane import staleness_alphas as jax_staleness_alphas  # noqa: E402
from repro.models import model as ref_model  # noqa: E402
from repro.rl.agent import DQNAgent as JaxDQNAgent  # noqa: E402
from repro.rl.env import LandmarkEnv as JaxLandmarkEnv  # noqa: E402
from repro.rl.synth import make_volume as jax_make_volume  # noqa: E402
from repro_torch.convert import zoo_train_state_from_numpy  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from test_torch_baselines import reference_init  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


def load_example(name: str):
    """An ``examples/<name>.py`` file as a module (its ``main`` not run)."""
    path = ROOT / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"_example_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def ref_state_numpy(arch: str, seed: int, opt_dtype: str) -> dict:
    """The reference's LM train state ``init_train_state(cfg, PRNGKey(seed))``
    as numpy."""
    from repro.optim.adamw import AdamWConfig

    cfg = ref_get_config(arch)
    state = ref_model.init_train_state(
        cfg, jax.random.PRNGKey(seed), AdamWConfig(opt_dtype=opt_dtype)
    )
    return jax.tree_util.tree_map(np.asarray, state)


def test_quickstart_zoo_matches_reference(monkeypatch):
    qs = load_example("torch_quickstart")
    arch = "qwen3-moe-235b-a22b-smoke"
    # the reference's section 1, line for line
    cfg = ref_get_config(arch)
    model = ref_model.build_model(cfg)
    state = model.init_train_state(jax.random.PRNGKey(0))
    init = jax.tree_util.tree_map(np.asarray, state)
    rng = np.random.default_rng(0)
    batch = {
        "tokens": jnp.asarray(rng.integers(0, cfg.vocab_size, (2, 64)), jnp.int32),
        "labels": jnp.asarray(rng.integers(0, cfg.vocab_size, (2, 64)), jnp.int32),
    }
    state, metrics = jax.jit(model.train_step)(state, batch)
    caches = ref_model.init_caches(cfg, 2, 16)
    logits, _ = jax.jit(model.serve_step)(
        state["params"],
        caches,
        {"tokens": jnp.zeros((2, 1), jnp.int32), "pos": jnp.zeros((2,), jnp.int32)},
    )

    monkeypatch.setattr(
        Model,
        "init_train_state",
        lambda self, seed: zoo_train_state_from_numpy(init, self.device),
    )
    out = qs.zoo(CPU)
    assert out["loss"] == pytest.approx(float(metrics["loss"]), abs=1e-4)
    assert out["aux"] == pytest.approx(float(metrics["aux"]), abs=1e-4)
    got = out["logits"].numpy()
    assert got.shape == logits.shape
    assert np.abs(got - np.asarray(logits)).max() < 1e-4


def reference_agents() -> dict:
    """The reference quickstart's section 2, line for line."""
    dqn = JaxDQNConfig(
        volume_shape=(16, 16, 16),
        box_size=(6, 6, 6),
        conv_features=(4,),
        hidden=(32,),
        max_episode_steps=12,
        batch_size=16,
    )
    task_a = JaxTaskTag("t1", "axial", "HGG")
    task_b = JaxTaskTag("t2", "coronal", "LGG")
    net = JaxNetwork(hubs=[JaxHub(0)])
    net.attach_agent(0)
    net.attach_agent(1)
    a0 = JaxDQNAgent(0, dqn, seed=0)
    a1 = JaxDQNAgent(1, dqn, seed=1)
    vol, lm = jax_make_volume(task_a, 0, n=16)
    kw = dict(erb_capacity=512, share_size=64, train_steps=20)
    shared, loss0 = a0.train_round(JaxLandmarkEnv(vol, lm, dqn), task_a, (), **kw)
    net.agent_push(0, shared)
    incoming = net.agent_pull(1, a1.seen_erb_ids)
    vol, lm = jax_make_volume(task_b, 1, n=16)
    _, loss = a1.train_round(JaxLandmarkEnv(vol, lm, dqn), task_b, incoming, **kw)
    net.register_plane(JaxWeightPlane(max_versions=2))
    net.agent_push(0, a0.snapshot_params(sim_time=1.0), plane="weights")
    snaps = net.agent_pull(1, a1.seen_snap_ids, plane="weights")
    alphas = jax_staleness_alphas(snaps, a1.rounds_done, alpha=0.5, flag="poly")
    n = a1.mix_params(snaps, alphas)
    return {"loss0": loss0, "loss": loss, "n_incoming": len(incoming), "n_mixed": n}


def test_quickstart_agents_match_reference(monkeypatch):
    qs = load_example("torch_quickstart")
    want = reference_agents()
    reference_init(monkeypatch)
    got = qs.adfll(CPU)
    assert got["n_incoming"] == want["n_incoming"] == 1
    assert got["n_mixed"] == want["n_mixed"] == 1
    assert got["loss0"] == pytest.approx(want["loss0"], abs=1e-5)
    assert got["loss"] == pytest.approx(want["loss"], abs=1e-5)


def test_quickstart_main_on_the_cpu(capsys):
    qs = load_example("torch_quickstart")
    out = qs.main(["--device", "cpu"])
    # on the CPU the wrapper runs the plain version: no launch, no error
    assert out["kernels"] == {"err": 0.0, "scalar_launches": 0}
    lines = capsys.readouterr().out.splitlines()
    assert [x.split(" ")[0] for x in lines] == ["[zoo]"] * 2 + ["[adfll]"] * 2 + [
        "[kernels]",
        "done.",
    ]


def test_federated_lm_table_matches_reference(monkeypatch):
    ref_ex = load_example("federated_lm")
    port_ex = load_example("torch_federated_lm")
    steps = 2
    table = []

    def recording_eval(cfg, loss_fn, params, style, _eval=ref_ex.eval_style):
        table.append(_eval(cfg, loss_fn, params, style))
        return table[-1]

    monkeypatch.setattr(ref_ex, "STEPS_PER_ROUND", steps)
    monkeypatch.setattr(ref_ex, "eval_style", recording_eval)
    ref_ex.main()

    def ref_init(cfg, generator, opt):
        arch = cfg.name
        state = ref_state_numpy(arch, generator.initial_seed(), opt.opt_dtype)
        return zoo_train_state_from_numpy(state, generator.device)

    monkeypatch.setattr(port_ex, "init_train_state", ref_init)
    out = port_ex.main(["--steps", str(steps), "--device", "cpu"])
    n = len(port_ex.ARCHS)
    want = np.asarray(table).reshape(n, n)
    got = np.asarray(out["table"])
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert out["n_incoming"] == [2, 2, 2]
    assert all(np.isfinite(out["losses"]))


def test_train_lm_125m_checkpoint_loads_in_the_reference(tmp_path, capsys):
    from repro.checkpoint.ckpt import restore_pytree

    ex = load_example("torch_train_lm_125m")
    path = tmp_path / "xlstm.npz"
    argv = ["--arch", "xlstm-125m-smoke", "--steps", "2", "--batch", "2"]
    argv += ["--seq", "32", "--device", "cpu", "--ckpt", str(path)]
    assert ex.main(argv) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("xlstm-125m-smoke:")
    assert lines[-1].startswith("saved params")
    cfg = ref_get_config("xlstm-125m-smoke")
    like = jax.eval_shape(lambda: ref_model.init_params(cfg, jax.random.PRNGKey(0)))
    restored = restore_pytree(str(path), like)
    leaves = jax.tree_util.tree_leaves(restored)
    assert len(leaves) == len(jax.tree_util.tree_leaves(like))
    with np.load(path) as data:
        assert len(data.files) == len(leaves)
    assert all(np.isfinite(np.asarray(x, np.float32)).all() for x in leaves)


def test_adfll_deployment_prints_the_summary(capsys):
    ex = load_example("torch_adfll_deployment")
    out = ex.main(["--scenario", "plane_erb_only", "--fast", "--device", "cpu"])
    text = capsys.readouterr().out
    assert "scenario plane_erb_only: sim makespan" in text
    assert out["best"] in out["means"] and out["makespan"] > 0
    assert all(f"  {name:8s} mean distance error" in text for name in out["means"])


def test_examples_import_no_jax_or_reference():
    """Checked in a fresh process by ``tests/test_torch_isolation.py``; here
    that each example names only the port."""
    for name in ("quickstart", "adfll_deployment", "federated_lm", "train_lm_125m"):
        src = (ROOT / "examples" / f"torch_{name}.py").read_text()
        imports = [x for x in src.splitlines() if x.startswith(("import ", "from "))]
        named = [
            x for x in imports if " jax" in x or "repro." in x or x.endswith(" repro")
        ]
        assert imports and not named
    assert "jax" in sys.modules  # this file's reference side
