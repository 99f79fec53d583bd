"""Registry-width runs of the port against the reference on the CPU.

``run(name, fast=True)`` on both sides, the port's fleet slots starting
from the reference's init (``test_torch_baselines.reference_init``):
``mean_dist_err`` and ``n_rounds`` agree within 1e-4.  These are the
Table 1 comparison's two ends at the registry's own widths — Agent M
(``baseline_sequential``, 8 rounds of 20 steps) and the ADFLL
deployment (``paper_fig2``, 12 rounds over 4 agents and 3 hubs) — so
the port's number for either is the reference's number.
"""

import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: these sizes gain nothing from more, and spinning
# OpenMP threads in parallel test workers would starve the other tests
torch.set_num_threads(1)
pytest.importorskip("jax")

import repro.core  # noqa: E402, F401  (the reference's own import order)
from repro.experiments import runner as jax_runner  # noqa: E402
from repro_torch.experiments.runner import run  # noqa: E402
from test_torch_baselines import reference_init  # noqa: E402


@pytest.mark.parametrize("name", ["baseline_sequential", "paper_fig2"])
def test_registry_run_matches_reference(name, monkeypatch):
    reference_init(monkeypatch)
    ref = jax_runner.run(name, fast=True)
    port = run(name, fast=True, device="cpu")
    assert port.n_rounds == ref.n_rounds
    assert abs(port.mean_dist_err - ref.mean_dist_err) <= 1e-4
    assert port.task_errors.keys() == ref.task_errors.keys()
