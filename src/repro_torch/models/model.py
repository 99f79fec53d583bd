"""Model assembly for serving: init, caches, forward, prefill and decode.

The port of the reference's ``models/model.py`` (serving members only:
the train step, ``chunked_xent`` and the loss wait for the zoo's training
slice).  The parameter layout is the reference's: the per-group leaves are
stacked on a leading ``[G, ...]`` axis, so converting reference params is
a dtype change, and ``forward`` loops over the groups in Python where the
reference scans.  There is no mesh or sharding policy: one card holds the
whole model.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import rope as rope_lib
from repro_torch.models.blocks import block_apply, block_cache_init, block_init
from repro_torch.models.layers import (
    embed_apply,
    embed_init,
    norm_apply,
    norm_init,
    torch_dtype,
    unembed_apply,
)


def _stack(trees: list) -> Any:
    """Stack a list of same-shaped nested dicts of tensors leaf by leaf."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _index(tree: Any, g: int) -> Any:
    """Leaf ``[g]`` of every tensor of a nested dict (views, not copies)."""
    if isinstance(tree, dict):
        return {k: _index(v, g) for k, v in tree.items()}
    return tree[g]


def _check_layout(cfg: ModelConfig) -> None:
    if cfg.first_k_dense:
        raise NotImplementedError(
            f"{cfg.name}: unrolled dense prefix layers (first_k_dense) are not "
            "ported yet; they come with the zoo slice of deepseek-v2-lite"
        )


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def init_params(cfg: ModelConfig, generator: torch.Generator) -> dict[str, Any]:
    """Fresh params on the generator's device, with the reference's names,
    shapes and init scales (its distributions, not its bits)."""
    _check_layout(cfg)
    params: dict[str, Any] = {
        "embed": embed_init(cfg, generator),
        "final_norm": norm_init(cfg, cfg.d_model, generator.device),
    }
    groups = [
        {
            f"b{j}": block_init(cfg, mixer, ffn, generator)
            for j, (mixer, ffn) in enumerate(cfg.pattern)
        }
        for _ in range(cfg.n_groups)
    ]
    params["groups"] = _stack(groups)
    return params


def cache_len_for(cfg: ModelConfig, seq_len: int) -> int:
    if cfg.sliding_window is not None:
        return min(seq_len, cfg.sliding_window)
    return seq_len


def init_caches(cfg: ModelConfig, batch: int, seq_len: int, device) -> dict[str, Any]:
    """Empty decode caches for ``seq_len`` tokens (ring-buffer length for
    SWA models), stacked ``[G, ...]`` like the params."""
    _check_layout(cfg)
    dtype = torch_dtype(cfg.dtype)
    clen = cache_len_for(cfg, seq_len)
    one = {
        f"b{j}": block_cache_init(cfg, mixer, batch, clen, dtype, device)
        for j, (mixer, _) in enumerate(cfg.pattern)
    }
    return {"groups": _stack([one] * cfg.n_groups)}


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------
def forward(
    cfg: ModelConfig,
    params: dict[str, Any],
    inputs: torch.Tensor,
    positions: torch.Tensor,
    *,
    mode: str,
    caches: dict[str, Any] | None = None,
):
    """inputs: tokens [B,S] int or embeds [B,S,D]; positions [B,S].

    Returns (hidden [B,S,D], caches): in prefill mode the caches to hand
    to decode, in decode mode ``caches`` written in place, in train mode
    (the teacher-forced forward) None.  (The reference also returns MoE's
    router loss; the dense blocks ported so far have none.)"""
    _check_layout(cfg)
    if inputs.dtype in (torch.int32, torch.int64):
        x = embed_apply(params["embed"], inputs)
    else:
        x = inputs.to(torch_dtype(cfg.dtype))
    handed = {f"b{j}": [] for j in range(len(cfg.pattern))}
    for g in range(cfg.n_groups):
        gp = _index(params["groups"], g)
        for j, (mixer, ffn) in enumerate(cfg.pattern):
            c = _index(caches["groups"][f"b{j}"], g) if caches is not None else None
            x, nc = block_apply(
                cfg,
                gp[f"b{j}"],
                x,
                mixer=mixer,
                ffn=ffn,
                mode=mode,
                positions=positions,
                cache=c,
            )
            handed[f"b{j}"].append(nc)
    x = norm_apply(cfg, params["final_norm"], x)
    if mode == "prefill":
        return x, {"groups": {k: _stack(v) for k, v in handed.items()}}
    return x, caches


def logits_fn(cfg: ModelConfig, params: dict[str, Any], hidden: torch.Tensor):
    return unembed_apply(cfg, params["embed"], hidden)


# ---------------------------------------------------------------------------
# steps
# ---------------------------------------------------------------------------
def make_prefill_step(cfg: ModelConfig):
    """(params, batch{tokens|embeds[, positions]}) -> (last logits [B, V],
    caches to hand to decode)."""

    def prefill_step(params, batch):
        inputs = batch.get("tokens", batch.get("embeds"))
        b, s = inputs.shape[:2]
        positions = batch.get("positions")
        if positions is None:
            positions = rope_lib.positions_for(cfg, b, s, device=inputs.device)
        hidden, caches = forward(cfg, params, inputs, positions, mode="prefill")
        last = logits_fn(cfg, params, hidden[:, -1:])
        return last[:, 0], caches

    return prefill_step


def make_serve_step(cfg: ModelConfig):
    """One decode step: (params, caches, batch{tokens|embeds, pos [B]}) ->
    (logits [B, V], caches).  The caches are written in place and
    returned."""

    def serve_step(params, caches, batch):
        inputs = batch.get("tokens", batch.get("embeds"))
        positions = batch["pos"][:, None]
        hidden, new_caches = forward(
            cfg, params, inputs, positions, mode="decode", caches=caches
        )
        return logits_fn(cfg, params, hidden)[:, 0], new_caches

    return serve_step


class Model:
    """The serving members of the functional API, bound to a config and a
    device (``None`` = the CUDA card; raises without one)."""

    def __init__(self, cfg: ModelConfig, device: str | torch.device | None = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.prefill_step = make_prefill_step(cfg)
        self.serve_step = make_serve_step(cfg)

    def init_params(self, seed: int) -> dict[str, Any]:
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return init_params(self.cfg, gen)

    def init_caches(self, batch: int, seq_len: int) -> dict[str, Any]:
        return init_caches(self.cfg, batch, seq_len, self.device)


__all__ = [
    "Model",
    "cache_len_for",
    "forward",
    "init_caches",
    "init_params",
    "logits_fn",
    "make_prefill_step",
    "make_serve_step",
]
