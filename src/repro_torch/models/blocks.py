"""Decoder block: a (mixer, ffn) pair from the config's pattern.

The port of the reference's ``models/blocks.py`` for the GQA and MLA
mixers and the dense and MoE FFNs.  Mamba, mLSTM and sLSTM wait for the
zoo slice that ports ``models/ssm.py`` and raise ``NotImplementedError``
here.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ATTN, FFN_DENSE, FFN_MOE, MLA, ModelConfig
from repro_torch.models import attention
from repro_torch.models.layers import mlp_apply, mlp_init, norm_apply, norm_init
from repro_torch.models.moe import moe_apply, moe_init


def _check_kinds(mixer: str, ffn: str) -> None:
    if mixer not in (ATTN, MLA) or ffn not in (FFN_DENSE, FFN_MOE):
        raise NotImplementedError(
            f"block ({mixer}, {ffn}) is not ported yet: Mamba, mLSTM and sLSTM "
            "(models/ssm.py) come with ROADMAP queue 1 item 3.6"
        )


def block_init(
    cfg: ModelConfig,
    mixer: str,
    ffn: str,
    generator: torch.Generator,
    d_ff: int | None = None,
) -> dict:
    _check_kinds(mixer, ffn)
    dev = generator.device
    mixer_init = attention.gqa_init if mixer == ATTN else attention.mla_init
    p = {"norm1": norm_init(cfg, cfg.d_model, dev), "mixer": mixer_init(cfg, generator)}
    p["norm2"] = norm_init(cfg, cfg.d_model, dev)
    if ffn == FFN_DENSE:
        p["ffn"] = mlp_init(cfg, cfg.d_model, d_ff or cfg.d_ff, generator)
    else:
        p["ffn"] = moe_init(cfg, generator)
    return p


def block_cache_init(
    cfg: ModelConfig, mixer: str, batch: int, cache_len: int, dtype, device
) -> dict[str, torch.Tensor]:
    _check_kinds(mixer, FFN_DENSE)
    cache_init = attention.gqa_cache_init if mixer == ATTN else attention.mla_cache_init
    return cache_init(cfg, batch, cache_len, dtype, device)


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
):
    """Returns (x, new_cache, aux): ``aux`` is the MoE router's loss (a
    float32 scalar), None for a dense FFN.  ``attn_impl``: see
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
    else:
        y, new_cache = attention.mla_apply(
            cfg, p["mixer"], h, mode=mode, positions=positions, cache=cache
        )
    x = x + y
    h = norm_apply(cfg, p["norm2"], x)
    if ffn == FFN_DENSE:
        return x + mlp_apply(cfg, p["ffn"], h), new_cache, None
    y, aux = moe_apply(cfg, p["ffn"], h)
    return x + y, new_cache, aux


__all__ = ["block_apply", "block_cache_init", "block_init"]
