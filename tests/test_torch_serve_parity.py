"""The port's serving plane against the reference's on the CPU.

Both sides get the same params (the reference's ``dqn_init`` per seed,
stacked, converted with ``repro_torch.convert.dqn_params_from_numpy``,
which passes the stacked axis through) and the same requests (each side's
own ``synthetic_requests`` of one seed: volumes, starts, landmarks and
agents identical).  Then:

* ``ActSteps``: q within 1e-5 (two frameworks' convolution and matmul
  sum orders), the same actions;
* ``LocalizationService`` over 12 requests and a hot swap: every
  request's final voxel, tick count and pinned version identical;
* ``serve_localization --fast`` from the reference's init (the port's
  fleet slots seeded as ``tests/test_torch_baselines.py`` does): the
  same collection and training, the hot-swapped version's params within
  1e-5, so ``mean_dist_err`` within 1e-6 and the serve summary's
  ``n_requests``, ``n_ticks``, ``n_swaps``, ``versions_served`` and
  ``recompiles`` equal.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: these sizes gain nothing from more, and spinning
# OpenMP threads in parallel test workers would starve the other tests
torch.set_num_threads(1)
jax = pytest.importorskip("jax")

import repro.core  # noqa: E402,F401  (the reference's own import order)
from repro import experiments as jax_experiments  # noqa: E402
from repro import serve as jax_serve  # noqa: E402
from repro.configs.adfll_dqn import DQNConfig as JaxDQNConfig  # noqa: E402
from repro.experiments import systems as jax_systems  # noqa: E402
from repro.rl.dqn import dqn_init as jax_dqn_init  # noqa: E402
from repro.rl.fleet import make_act_steps as jax_make_act_steps  # noqa: E402
from repro_torch import serve as port_serve  # noqa: E402
from repro_torch.configs.adfll_dqn import DQNConfig  # noqa: E402
from repro_torch.convert import dqn_params_from_numpy  # noqa: E402
from repro_torch.experiments import systems as port_systems  # noqa: E402
from repro_torch.experiments.runner import run  # noqa: E402
from repro_torch.rl.fleet import make_act_steps  # noqa: E402
from test_torch_baselines import _params_close, reference_init  # noqa: E402

# the reference's tests/test_serve.py widths
KW = dict(
    volume_shape=(16, 16, 16),
    box_size=(6, 6, 6),
    conv_features=(4,),
    hidden=(32,),
    max_episode_steps=12,
    batch_size=16,
    eps_decay_steps=100,
)
CFG, JCFG = DQNConfig(**KW), JaxDQNConfig(**KW)


def _ref_stacked(n_agents: int, seed: int = 0) -> dict:
    """The reference's init per seed, stacked [N, ...] as numpy."""
    params = [jax_dqn_init(jax.random.PRNGKey(seed + i), JCFG) for i in range(n_agents)]
    return jax.tree_util.tree_map(lambda *xs: np.stack(xs), *params)


def _both_requests(n: int, seed: int = 0, n_agents: int = 2):
    """Each side's own stream of one seed, held identical field by field."""
    ref = jax_serve.synthetic_requests(
        jax_serve.TrafficSpec(n_requests=n, seed=seed), JCFG, n_agents=n_agents
    )
    port = port_serve.synthetic_requests(
        port_serve.TrafficSpec(n_requests=n, seed=seed), CFG, n_agents=n_agents
    )
    for a, b in zip(ref, port, strict=True):
        np.testing.assert_array_equal(a.volume, b.volume)
        np.testing.assert_array_equal(a.start, b.start)
        np.testing.assert_array_equal(a.landmark, b.landmark)
        assert (a.agent_id, a.max_steps) == (b.agent_id, b.max_steps)
    return ref, port


def test_act_steps_match_the_reference():
    rng = np.random.default_rng(0)
    tree = _ref_stacked(6)  # a 2-slot ring of 3 agents
    b = 16
    slot = rng.integers(0, 6, b).astype(np.int32)
    obs = rng.standard_normal((b, *CFG.box_size)).astype(np.float32)
    loc = rng.random((b, 3)).astype(np.float32)
    ref_steps = jax_make_act_steps(JCFG)
    want_a, want_q = ref_steps.act(
        jax.tree_util.tree_map(jax.numpy.asarray, tree), slot, obs, loc
    )
    got_a, got_q = make_act_steps(CFG, "cpu").act(
        dqn_params_from_numpy(tree),
        torch.from_numpy(slot),
        torch.from_numpy(obs),
        torch.from_numpy(loc),
    )
    np.testing.assert_allclose(got_q.numpy(), np.asarray(want_q), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got_a.numpy(), np.asarray(want_a))


def _two_versions(module, tree0, tree1, convert):
    versions = [convert(tree0), convert(tree1)]
    state = {"i": 0}

    def source():
        p = versions[state["i"] % 2]
        state["i"] += 1
        return p

    return module.ParamPublisher(source)


def _serve_with_a_swap(module, cfg, requests, publisher, **kw):
    """6 requests admitted on v0 and ticked once, then v1 published and 6
    more submitted; drained.  Returns (final voxel, ticks, version) per
    request, and the report."""
    service = module.LocalizationService(
        cfg, publisher=publisher, max_batch=4, n_version_slots=2, max_staleness=1, **kw
    )
    ids = [service.submit(r) for r in requests[:6]]
    service.tick()
    publisher.publish()
    ids += [service.submit(r) for r in requests[6:]]
    report = service.drain()
    out = [
        (
            tuple(int(v) for v in service.results[i].final_loc),
            service.results[i].n_ticks,
            service.results[i].version,
        )
        for i in ids
    ]
    return out, report


def test_service_matches_the_reference_across_a_hot_swap():
    ref_req, port_req = _both_requests(12)
    tree0, tree1 = _ref_stacked(2, seed=0), _ref_stacked(2, seed=9)
    want, ref_report = _serve_with_a_swap(
        jax_serve,
        JCFG,
        ref_req,
        _two_versions(jax_serve, tree0, tree1, lambda t: t),
    )
    got, port_report = _serve_with_a_swap(
        port_serve,
        CFG,
        port_req,
        _two_versions(port_serve, tree0, tree1, dqn_params_from_numpy),
        device="cpu",
    )
    assert got == want
    assert {v for *_, v in got} == {0, 1}
    for key in ("n_ticks", "n_swaps", "n_deferred_swaps", "n_stall_ticks"):
        assert getattr(port_report, key) == getattr(ref_report, key), key
    assert port_report.batch_sizes == ref_report.batch_sizes
    assert port_report.versions_served == ref_report.versions_served


def _keep_system(monkeypatch, cls) -> list:
    """Record the system whose ``run()`` the runner calls."""
    kept, run_ = [], cls.run

    def recording(self):
        kept.append(self)
        return run_(self)

    monkeypatch.setattr(cls, "run", recording)
    return kept


def test_serve_localization_matches_the_reference(monkeypatch):
    reference_init(monkeypatch)
    ref_sys = _keep_system(monkeypatch, jax_systems.ServeSystem)
    port_sys = _keep_system(monkeypatch, port_systems.ServeSystem)
    want = jax_experiments.run("serve_localization", fast=True)
    got = run("serve_localization", fast=True, device="cpu")
    # the version the second wave served: one round of training apart
    (ref,), (port,) = ref_sys, port_sys
    v_ref, v_port = ref.session.publisher.latest, port.session.publisher.latest
    assert v_port.version == v_ref.version == 1
    assert v_port.train_steps == v_ref.train_steps == 16
    _params_close(v_port.params, v_ref.params, atol=1e-5)
    assert abs(got.mean_dist_err - want.mean_dist_err) <= 1e-6
    assert got.task_errors.keys() == want.task_errors.keys() == {"Serve"}
    for task, err in want.task_errors["Serve"].items():
        assert abs(got.task_errors["Serve"][task] - err) <= 1e-6
    assert (got.system, got.n_rounds) == (want.system, want.n_rounds) == ("serve", 2)
    g, w = got.extra["serve"], want.extra["serve"]
    for key in ("n_requests", "n_ticks", "n_swaps", "versions_served", "recompiles"):
        assert g[key] == w[key], key
    assert g["n_requests"] == 32 and g["n_swaps"] == 1 and g["recompiles"] == 0
    assert g["mean_dist_err"] == pytest.approx(w["mean_dist_err"], abs=1e-6)
