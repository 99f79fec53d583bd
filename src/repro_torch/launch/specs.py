"""Shape-level stand-ins, with their sharding specs, for every model input.

The port of the reference's ``repro/launch/specs.py``.  Where the
reference builds ``ShapeDtypeStruct`` trees, these build trees of
``meta`` tensors at the global shapes and dtypes (the model's own init
and cache builders run on ``meta``: nothing is drawn or allocated, so
jamba's 398 B parameters cost nothing to shape), each leaf paired with
its spec as a :class:`Sharded`.  With a mesh shape of ``None`` every spec
is ``None`` (replicated: one card).  :func:`bytes_per_device` sizes a
tree per card.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.configs.base import InputShape, ModelConfig, param_count
from repro_torch.models import model as model_lib
from repro_torch.models.model import META, meta_params
from repro_torch.models.layers import torch_dtype
from repro_torch.models.sharding import (
    ShardingPolicy,
    axis_size,
    cache_shardings,
    tree_pspecs,
)
from repro_torch.optim.adamw import AdamWConfig, tree_adamw_init

class Sharded(NamedTuple):
    """A ``meta`` tensor at a global shape and its per-dimension spec."""

    tensor: torch.Tensor
    spec: tuple | None


def opt_cfg_for(cfg: ModelConfig) -> AdamWConfig:
    """bf16 moments above 1e11 parameters (the reference's rule, sized for
    its sharded TPU memory), f32 moments below."""
    total, _ = param_count(cfg)
    dtype = "bfloat16" if total > 1e11 else "float32"
    return AdamWConfig(opt_dtype=dtype)


def _pair(tensors, specs):
    if isinstance(tensors, dict):
        return {
            k: _pair(v, None if specs is None else specs[k]) for k, v in tensors.items()
        }
    return Sharded(tensors, specs)


def tensors(tree):
    """The ``meta`` tensors of a :class:`Sharded` tree (same nesting)."""
    if isinstance(tree, dict):
        return {k: tensors(v) for k, v in tree.items()}
    return tree.tensor


def state_specs(
    cfg: ModelConfig,
    mesh: dict[str, int] | None,
    policy: ShardingPolicy,
    opt_cfg: AdamWConfig,
):
    """``{"params", "opt"}`` of the train state: moments sharded like the
    params, the count replicated."""
    params = meta_params(cfg)
    opt = tree_adamw_init(opt_cfg, params)
    if mesh is None:
        return _pair({"params": params, "opt": opt}, None)
    specs = {
        "params": tree_pspecs(params, mesh, policy, cfg),
        "opt": {
            "m": tree_pspecs(opt["m"], mesh, policy, cfg),
            "v": tree_pspecs(opt["v"], mesh, policy, cfg),
            "count": (),
        },
    }
    return _pair({"params": params, "opt": opt}, specs)


def params_specs(cfg: ModelConfig, mesh: dict[str, int] | None, policy: ShardingPolicy):
    params = meta_params(cfg)
    specs = None if mesh is None else tree_pspecs(params, mesh, policy, cfg)
    return _pair(params, specs)


def cache_specs(
    cfg: ModelConfig,
    batch: int,
    seq_len: int,
    mesh: dict[str, int] | None,
    policy: ShardingPolicy,
):
    caches = model_lib.init_caches(cfg, batch, seq_len, META)
    specs = None if mesh is None else cache_shardings(caches, mesh, policy)
    return _pair(caches, specs)


def batch_pspec(mesh: dict[str, int] | None, policy: ShardingPolicy, b: int):
    if mesh is None:
        return None
    batch = tuple(a for a in policy.batch_axes if a in mesh)
    if not batch or b % math.prod(mesh[a] for a in batch) != 0:
        # fall back: try fewer axes, else replicate
        batch = tuple(a for a in batch if b % mesh[a] == 0)[:1]
    if not batch:
        return None
    return batch if len(batch) > 1 else batch[0]


def input_specs(
    cfg: ModelConfig,
    shape: InputShape,
    mesh: dict[str, int] | None,
    policy: ShardingPolicy,
) -> dict[str, Sharded]:
    """The step's batch for one (arch x input-shape) pair: tokens or
    embeds, labels in training, M-RoPE positions; decode's one token and
    its position (the cache comes from :func:`cache_specs`)."""
    b = shape.global_batch
    s = shape.seq_len if shape.mode in ("train", "prefill") else 1
    bspec = batch_pspec(mesh, policy, b)

    def sds(shape_, dtype, *spec):
        return Sharded(
            torch.zeros(shape_, dtype=dtype, device=META),
            None if mesh is None else tuple(spec),
        )

    batch = {}
    if cfg.input_kind == "embeds":
        dt = torch_dtype(cfg.dtype)
        batch["embeds"] = sds((b, s, cfg.d_model), dt, bspec, None, None)
    else:
        batch["tokens"] = sds((b, s), torch.int32, bspec, None)
    if shape.mode == "train":
        batch["labels"] = sds((b, s), torch.int32, bspec, None)
    if shape.mode in ("train", "prefill"):
        if cfg.rope == "mrope":
            batch["positions"] = sds((3, b, s), torch.int32, None, bspec, None)
    else:
        batch["pos"] = sds((b,), torch.int32, bspec)
    return batch


def _leaves(tree) -> list[Sharded]:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def shard_shape(shape, spec, mesh: dict[str, int] | None) -> tuple[int, ...]:
    """The per-card shape of a leaf: each sharded dimension divided (rounded
    up) by the devices its axes span."""
    if spec is None or mesh is None:
        return tuple(shape)
    return tuple(
        -(-size // axis_size(mesh, spec[i] if i < len(spec) else None))
        for i, size in enumerate(shape)
    )


def bytes_per_device(tree, mesh: dict[str, int] | None) -> float:
    """Bytes one card holds of a :class:`Sharded` tree."""
    total = 0.0
    for leaf in _leaves(tree):
        t = leaf.tensor
        total += math.prod(shard_shape(t.shape, leaf.spec, mesh)) * t.element_size()
    return total


__all__ = [
    "META",
    "Sharded",
    "batch_pspec",
    "bytes_per_device",
    "cache_specs",
    "input_specs",
    "meta_params",
    "opt_cfg_for",
    "params_specs",
    "shard_shape",
    "state_specs",
    "tensors",
]
