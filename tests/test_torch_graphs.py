"""The port's one CUDA-graph helper (``repro_torch.kernels.graphs``) on
the CPU: its kernel list and its launch accounting.  Capture and replay
need a card (``tests/test_torch_cuda_paths.py``)."""

import importlib
import pkgutil

import pytest

torch = pytest.importorskip("torch")

import repro_torch.kernels  # noqa: E402
from repro_torch.kernels import graphs  # noqa: E402


def test_kernel_list_holds_every_counted_wrapper():
    """Every wrapper under ``repro_torch/kernels/`` with a ``launches``
    counter is in :data:`graphs.KERNELS`, so a replay advances it: a new
    kernel cannot land uncounted."""
    counted = []
    for info in pkgutil.iter_modules(repro_torch.kernels.__path__):
        mod = importlib.import_module(f"repro_torch.kernels.{info.name}")
        counted += [
            obj
            for obj in vars(mod).values()
            if isinstance(getattr(obj, "launches", None), int)
            and getattr(obj, "__module__", None) == mod.__name__
        ]
    assert len(counted) == len(graphs.KERNELS) == 7
    assert set(counted) == set(graphs.KERNELS)


def test_launch_counts_and_advance_round_trip():
    """A snapshot of counters set by hand, routes included, taken back
    off them leaves every counter at zero, and added again restores it."""
    saved = graphs.launch_counts()
    try:
        for i, k in enumerate(graphs.KERNELS):
            k.launches = 10 * i + 3
            for j, route in enumerate(getattr(k, "launches_by_route", {})):
                k.launches_by_route[route] = 7 * i + j + 1
        snap = graphs.launch_counts()
        assert any(routes for _, routes in snap)
        graphs.advance(snap, -1)
        assert all(
            n == 0 and set(routes.values()) <= {0}
            for n, routes in graphs.launch_counts()
        )
        graphs.advance(snap)
        assert graphs.launch_counts() == snap
    finally:
        graphs.advance(graphs.launch_counts(), -1)
        graphs.advance(saved)
