"""Production mesh shapes and the H100's roofline constants.

The port of the reference's ``repro/launch/mesh.py``, which targets a TPU
v5e pod.  Here a mesh is its shape, an ordered ``{axis: size}`` dict
(``models/sharding.py`` reads nothing else), planned for H100 nodes:
eight cards joined by NVLink carry ``model`` (tensor parallelism inside a
node), the network between nodes carries ``data`` and ``pod``.

The constants are spec-sheet figures of the H100 SXM5 80GB (NVIDIA's data
sheet, dense rates, at the full 700 W power limit), not measurements:
the planner's figures are estimates from them.

:func:`device_mesh` builds torch's ``DeviceMesh`` of a shape over the
process group this process already joined (``launch/train.py
--production-mesh`` on ``{data 32, model 8}``);
:func:`one_rank_device_mesh` joins this process alone to a process group
and gives the ``(data, model)`` ``DeviceMesh`` of one rank that
``Model(mesh=)`` runs on where one card is all there is.
"""

from __future__ import annotations

import os
import tempfile
from collections.abc import Iterator
from contextlib import contextmanager

import torch
import torch.distributed as dist


def make_production_mesh(*, multi_pod: bool = False) -> dict[str, int]:
    """32 nodes of 8 cards = 256 cards; 2 pods = 512 cards multi-pod."""
    if multi_pod:
        return {"pod": 2, "data": 32, "model": 8}
    return {"data": 32, "model": 8}


def make_local_mesh() -> dict[str, int]:
    """One card, with the production axis names."""
    return {"data": 1, "model": 1}


def device_mesh(shape: dict[str, int], device_type: str = "cuda"):
    """``init_device_mesh`` over the process group already joined, with
    ``shape``'s axes in order (``{"data": 32, "model": 8}`` for
    production); its size must be the world's."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(
        device_type, tuple(shape.values()), mesh_dim_names=tuple(shape)
    )


@contextmanager
def one_rank_device_mesh(device_type: str = "cuda") -> Iterator:
    """A ``(data 1, model 1)`` ``DeviceMesh`` of this process alone: a
    one-rank process group (NCCL on ``cuda``, gloo on ``cpu``) joined
    through a file in a temporary directory, destroyed on exit."""
    from torch.distributed.device_mesh import init_device_mesh

    backend = "nccl" if device_type == "cuda" else "gloo"
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            backend,
            init_method=f"file://{os.path.join(tmp, 'rendezvous')}",
            rank=0,
            world_size=1,
        )
        try:
            names = ("data", "model")
            yield init_device_mesh(device_type, (1, 1), mesh_dim_names=names)
        finally:
            dist.destroy_process_group()


# H100 SXM5 80GB spec-sheet figures (per card) — roofline denominators.
PEAK_FLOPS_BF16 = 989e12  # FLOP/s, dense bf16 on the tensor cores
HBM_BW = 3.35e12  # B/s, HBM3
NVLINK_BW = 450e9  # B/s per direction, collectives on the model axis
NETWORK_BW = 50e9  # B/s per card (400 Gb/s InfiniBand), data and pod axes
HBM_BYTES = 80e9  # device memory


def device_memory_bytes() -> float:
    """The card's memory when one is present, else the spec sheet's 80 GB."""
    if torch.cuda.is_available():
        return float(torch.cuda.get_device_properties(0).total_memory)
    return HBM_BYTES


__all__ = [
    "HBM_BW",
    "HBM_BYTES",
    "NETWORK_BW",
    "NVLINK_BW",
    "PEAK_FLOPS_BF16",
    "device_memory_bytes",
    "device_mesh",
    "make_local_mesh",
    "make_production_mesh",
    "one_rank_device_mesh",
]
