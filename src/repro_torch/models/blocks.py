"""Decoder block: a (mixer, ffn) pair from the config's pattern.

The port of the reference's ``models/blocks.py`` for ``(ATTN,
FFN_DENSE)``, the block of every dense GQA config.  The other mixers (MLA,
Mamba, mLSTM, sLSTM) and MoE FFNs wait for the zoo slices that port them
and raise ``NotImplementedError`` here.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ATTN, FFN_DENSE, ModelConfig
from repro_torch.models import attention
from repro_torch.models.layers import mlp_apply, mlp_init, norm_apply, norm_init


def _check_kinds(mixer: str, ffn: str) -> None:
    if (mixer, ffn) != (ATTN, FFN_DENSE):
        raise NotImplementedError(
            f"block ({mixer}, {ffn}) is not ported yet: repro_torch runs "
            f"({ATTN}, {FFN_DENSE}) blocks only; the model zoo's later slices "
            "port MoE, MLA, Mamba and xLSTM (ROADMAP queue 1)"
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
    return {
        "norm1": norm_init(cfg, cfg.d_model, dev),
        "mixer": attention.gqa_init(cfg, generator),
        "norm2": norm_init(cfg, cfg.d_model, dev),
        "ffn": mlp_init(cfg, cfg.d_model, d_ff or cfg.d_ff, generator),
    }


def block_cache_init(
    cfg: ModelConfig, mixer: str, batch: int, cache_len: int, dtype, device
) -> dict[str, torch.Tensor]:
    _check_kinds(mixer, FFN_DENSE)
    return attention.gqa_cache_init(cfg, batch, cache_len, dtype, device)


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
    """Returns (x, new_cache).  (The reference also returns MoE's router
    loss; a dense FFN has none.)  ``attn_impl``: see
    :func:`attention.gqa_apply`."""
    _check_kinds(mixer, ffn)
    h = norm_apply(cfg, p["norm1"], x)
    y, new_cache = attention.gqa_apply(
        cfg,
        p["mixer"],
        h,
        mode=mode,
        positions=positions,
        cache=cache,
        attn_impl=attn_impl,
    )
    x = x + y
    x = x + mlp_apply(cfg, p["ffn"], norm_apply(cfg, p["norm2"], x))
    return x, new_cache


__all__ = ["block_apply", "block_cache_init", "block_init"]
