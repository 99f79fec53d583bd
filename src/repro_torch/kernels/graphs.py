"""CUDA-graph capture and replay for the port (the fleet engine's chunk,
the zoo's decode step), on one capture stream a device for the process:
cuBLAS keeps a workspace for each stream it ran on, for the life of the
process.  A capture launches nothing, so it takes the launches its
recording counted back off :data:`KERNELS`' counters, and each replay
adds them again.  Callers keep their static operands, keys, memory pools
and when to capture."""

from __future__ import annotations

import gc
from typing import NamedTuple

import torch

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.fused_td import fused_td
from repro_torch.kernels.kda_chunk import kda_chunk
from repro_torch.kernels.kda_step import kda_step
from repro_torch.kernels.mhc import mhc
from repro_torch.kernels.replay_gather import replay_gather
from repro_torch.kernels.rmsnorm import rmsnorm

KERNELS = (replay_gather, fused_td, rmsnorm, flash_attention, kda_step, kda_chunk, mhc)
_STREAMS: dict[int, torch.cuda.Stream] = {}  # by device index


def launch_counts() -> list:
    """Each of :data:`KERNELS`' ``launches`` and ``launches_by_route``."""
    return [(k.launches, dict(getattr(k, "launches_by_route", {}))) for k in KERNELS]


def advance(counts: list, sign: int = 1) -> None:
    """Add ``sign`` x ``counts`` to :data:`KERNELS`' launch counters."""
    for k, (n, routes) in zip(KERNELS, counts, strict=True):
        k.launches += sign * n
        for r, m in routes.items():
            k.launches_by_route[r] += sign * m


def _stream(device: torch.device) -> torch.cuda.Stream:
    index = torch.cuda.current_device() if device.index is None else device.index
    if index not in _STREAMS:
        _STREAMS[index] = torch.cuda.Stream(index)
    return _STREAMS[index]


def warm_up(fn, device: torch.device):
    """``fn()`` run once on ``device``'s capture stream, ordered after
    and before the current stream's work (the warm-up capture asks for)."""
    stream, current = _stream(device), torch.cuda.current_stream(device)
    stream.wait_stream(current)
    with torch.cuda.device(device), torch.cuda.stream(stream):
        out = fn()
    current.wait_stream(stream)
    return out


class Graph(NamedTuple):
    """A recorded ``fn()``, the outputs each replay writes, its launches."""

    graph: torch.cuda.CUDAGraph
    outputs: object
    launches: list
    device: torch.device


def capture(fn, device: torch.device, pool) -> Graph:
    """Record ``fn()`` on ``device``'s capture stream into memory pool
    ``pool`` (``torch.cuda.graph_pool_handle()``)."""
    before = launch_counts()
    graph = torch.cuda.CUDAGraph()
    # no garbage collection while capturing: a collection that frees another
    # graph destroys it mid-capture, which the capture does not survive
    collecting = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.device(device), torch.cuda.graph(
            graph, pool=pool, stream=_stream(device)
        ):
            outputs = fn()
    finally:
        if collecting:
            gc.enable()
    launches = [
        (n - n0, {r: m - r0[r] for r, m in routes.items()})
        for (n, routes), (n0, r0) in zip(launch_counts(), before, strict=True)
    ]
    advance(launches, -1)
    return Graph(graph, outputs, launches, device)


def replay(graph: Graph):
    """Replay ``graph``; returns its outputs, which the next replay
    overwrites."""
    with torch.cuda.device(graph.device):
        graph.graph.replay()
    advance(graph.launches)
    return graph.outputs
