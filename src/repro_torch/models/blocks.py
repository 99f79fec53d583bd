"""Decoder block: a (mixer, ffn) pair from the config's pattern.

The port of the reference's ``models/blocks.py``: the GQA, MLA, Mamba,
mLSTM and sLSTM mixers, and the dense, MoE or no FFN.  A block without
an FFN (xLSTM's, whose mixers carry their own projections) has no
second norm either, as in the reference.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import (
    ATTN,
    FFN_DENSE,
    FFN_MOE,
    FFN_NONE,
    MAMBA,
    MLA,
    MLSTM,
    SLSTM,
    ModelConfig,
)
from repro_torch.models import attention, ssm
from repro_torch.models.layers import mlp_apply, mlp_init, norm_apply, norm_init
from repro_torch.models.moe import moe_apply, moe_init

_MIXER_INIT = {
    ATTN: attention.gqa_init,
    MLA: attention.mla_init,
    MAMBA: ssm.mamba_init,
    MLSTM: ssm.mlstm_init,
    SLSTM: ssm.slstm_init,
}
# the recurrent mixers: their decode cache is a state of fixed size
_STATE_INIT = {
    MAMBA: ssm.mamba_state_init,
    MLSTM: ssm.mlstm_state_init,
    SLSTM: ssm.slstm_state_init,
}
_RECURRENT_APPLY = {
    MAMBA: ssm.mamba_apply,
    MLSTM: ssm.mlstm_apply,
    SLSTM: ssm.slstm_apply,
}
FFNS = (FFN_DENSE, FFN_MOE, FFN_NONE)


def _check_kinds(mixer: str, ffn: str) -> None:
    if mixer not in _MIXER_INIT or ffn not in FFNS:
        raise ValueError(f"unknown block kind ({mixer}, {ffn})")


def block_init(
    cfg: ModelConfig,
    mixer: str,
    ffn: str,
    generator: torch.Generator,
    d_ff: int | None = None,
) -> dict:
    _check_kinds(mixer, ffn)
    dev = generator.device
    p = {
        "norm1": norm_init(cfg, cfg.d_model, dev),
        "mixer": _MIXER_INIT[mixer](cfg, generator),
    }
    if ffn == FFN_DENSE:
        p["norm2"] = norm_init(cfg, cfg.d_model, dev)
        p["ffn"] = mlp_init(cfg, cfg.d_model, d_ff or cfg.d_ff, generator)
    elif ffn == FFN_MOE:
        p["norm2"] = norm_init(cfg, cfg.d_model, dev)
        p["ffn"] = moe_init(cfg, generator)
    return p


def block_cache_init(
    cfg: ModelConfig, mixer: str, batch: int, cache_len: int, dtype, device
) -> dict[str, torch.Tensor]:
    """The mixer's decode cache: an attention's kv cache of ``cache_len``
    slots, a recurrent mixer's state (no length)."""
    _check_kinds(mixer, FFN_DENSE)
    if mixer == ATTN:
        return attention.gqa_cache_init(cfg, batch, cache_len, dtype, device)
    if mixer == MLA:
        return attention.mla_cache_init(cfg, batch, cache_len, dtype, device)
    return _STATE_INIT[mixer](cfg, batch, dtype, device)


def block_apply(
    cfg: ModelConfig,
    p: dict,
    x: torch.Tensor,
    *,
    mixer: str,
    ffn: str,
    mode: str,
    positions: torch.Tensor,
    cache: dict[str, torch.Tensor] | None = None,
    attn_impl: str = "kernel",
    mesh=None,
    batch_axes: tuple[str, ...] = ("data",),
    tp: bool = True,
):
    """Returns (x, new_cache, aux): ``aux`` is the MoE router's loss (a
    float32 scalar), None for a dense FFN or none.  ``mesh``,
    ``batch_axes``, ``tp``: an MoE FFN's expert parallelism
    (:func:`moe_apply`); every other part runs whole on each rank.  ``new_cache``: an
    attention mixer's cache as :func:`attention.gqa_apply` returns it
    (decode writes it in place), a recurrent mixer's new state (new
    tensors; the caller keeps it).  ``attn_impl``: see
    :func:`attention.gqa_apply` (MLA always attends through
    ``chunked_attention``)."""
    _check_kinds(mixer, ffn)
    h = norm_apply(cfg, p["norm1"], x)
    if mixer == ATTN:
        y, new_cache = attention.gqa_apply(
            cfg,
            p["mixer"],
            h,
            mode=mode,
            positions=positions,
            cache=cache,
            attn_impl=attn_impl,
        )
    elif mixer == MLA:
        y, new_cache = attention.mla_apply(
            cfg, p["mixer"], h, mode=mode, positions=positions, cache=cache
        )
    else:
        y, new_cache = _RECURRENT_APPLY[mixer](
            cfg, p["mixer"], h, mode=mode, state=cache
        )
    x = x + y
    if ffn == FFN_NONE:
        return x, new_cache, None
    h = norm_apply(cfg, p["norm2"], x)
    if ffn == FFN_DENSE:
        return x + mlp_apply(cfg, p["ffn"], h), new_cache, None
    y, aux = moe_apply(
        cfg, p["ffn"], h, mesh=mesh, batch_axes=batch_axes, mode=mode, tp=tp
    )
    return x + y, new_cache, aux


__all__ = ["block_apply", "block_cache_init", "block_init"]
