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
from repro_torch.models.moe import moe_apply, moe_init, moe_stream
from repro_torch.models.sharding import axis_size
from repro_torch.models.spmd import enter, leave, use, use_tree

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
    cfg: ModelConfig,
    mixer: str,
    batch: int,
    cache_len: int,
    dtype,
    device,
    n_kv: int | None = None,
) -> dict[str, torch.Tensor]:
    """The mixer's decode cache: an attention's kv cache of ``cache_len``
    slots (``n_kv`` kv heads, default all), a recurrent mixer's state (no
    length)."""
    _check_kinds(mixer, FFN_DENSE)
    if mixer == ATTN:
        return attention.gqa_cache_init(cfg, batch, cache_len, dtype, device, n_kv)
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
    layout=None,
    path: str = "",
):
    """Returns (x, new_cache, aux): ``aux`` is the MoE router's loss (a
    float32 scalar), None for a dense FFN or none.  ``new_cache``: an
    attention mixer's cache as :func:`attention.gqa_apply` returns it
    (decode writes it in place), a recurrent mixer's new state (new
    tensors; the caller keeps it).  ``attn_impl``: see
    :func:`attention.gqa_apply` (MLA always attends through
    ``chunked_attention``).

    ``layout`` (``models/spmd.py::Layout``): the block on a mesh, ``x``
    this rank's part of the stream and ``p`` its blocks of the params at
    ``path`` ("groups/b0", "prefix/l0").  The norms run on the rank's
    rows (``[B/d, S/m, D]`` when the stream is sequence-sharded); the
    sequence is all-gathered into the mixer and the FFN; attention and
    the dense FFN run tensor parallel where their widths divide over
    ``model`` (:func:`attention_region`, :func:`mlp_region`); the MoE
    takes the stream as it is (``moe.moe_stream``); the mixers the port
    does not split run whole on each rank."""
    _check_kinds(mixer, ffn)
    if layout is not None:
        return _block_on_mesh(
            cfg, p, x, mixer=mixer, ffn=ffn, mode=mode, positions=positions,
            cache=cache, attn_impl=attn_impl, L=layout, path=path,
        )  # fmt: skip
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
        y, new_cache = _whole_mixer(cfg, mixer, p["mixer"], h, mode, positions, cache)
    x = x + y
    if ffn == FFN_NONE:
        return x, new_cache, None
    h = norm_apply(cfg, p["norm2"], x)
    if ffn == FFN_DENSE:
        return x + mlp_apply(cfg, p["ffn"], h), new_cache, None
    y, aux = moe_apply(cfg, p["ffn"], h, mode=mode)
    return x + y, new_cache, aux


def _whole_mixer(cfg, mixer, p, h, mode, positions, cache):
    if mixer == MLA:
        return attention.mla_apply(
            cfg, p, h, mode=mode, positions=positions, cache=cache
        )
    return _RECURRENT_APPLY[mixer](cfg, p, h, mode=mode, state=cache)


# ---------------------------------------------------------------------------
# the block on a (data, model) mesh
# ---------------------------------------------------------------------------
def _width(L, path: str, w: torch.Tensor, dim: int) -> int:
    """The global size of ``dim`` of leaf ``path``, from its block."""
    return w.shape[dim] * axis_size(L.axes, L.specs[path][dim])


def attention_plan(cfg: ModelConfig, L):
    """This rank's heads in a tensor-parallel attention: ``(q heads (first,
    count), kv heads (first, count) of the kv weights or None for all of
    them, kv_map)`` (``attention.select_kv``), or None where the
    attention runs whole on each rank.  Where the kv heads divide over
    ``model`` too, a rank's q heads attend with its own block of them;
    otherwise every rank computes all kv heads and its q heads attend
    with the contiguous range their groups cover (starcoder2-15b's 48/4
    at model 8: one; qwen2-vl-2b-smoke's 4/2 at model 4: one).  A split
    of the q heads that cuts a kv group unevenly runs whole."""
    q = L.block(cfg.n_heads)
    if q is None:
        return None
    kv = L.block(cfg.n_kv_heads)
    if kv is not None:
        return q, kv, None
    nq, g = q[1], cfg.n_heads // cfg.n_kv_heads

    def kv_range(q0):
        lo, hi = q0 // g, (q0 + nq - 1) // g
        n = hi - lo + 1
        even = not nq % n and all(
            (q0 + i) // g == lo + i // (nq // n) for i in range(nq)
        )
        return range(lo, hi + 1) if even else None

    # every rank's cut even, or all run whole (the same collectives)
    if any(kv_range(r * nq) is None for r in range(L.n_model)):
        return None
    return q, None, kv_range(q[0])


def attention_region(cfg, p, h, L, path, *, mode, positions, cache, attn_impl):
    """GQA on the stream ``h``: the rank's q heads and their kv heads
    (``wq``/``wk``/``wv`` column blocks, ``wo`` a row block, its output
    partial sums summed back onto the stream), or the whole attention on
    each rank when the heads do not divide over ``model``."""
    plan = attention_plan(cfg, L)
    tp = plan is not None
    qb, kvb, kv_map = plan if tp else (None, None, None)
    vary = L.vary_tp if tp else L.vary_whole
    hd = cfg.resolved_head_dim
    pp = {}
    for name, heads in (("wq", qb), ("wk", kvb), ("wv", kvb), ("wo", qb)):
        pp[name] = {}
        for leaf, t in p[name].items():
            block = None
            if heads is not None:
                dim = 0 if (leaf == "b" or name == "wo") else 1
                block = (dim, heads[0] * hd, heads[1] * hd)
            pp[name][leaf] = use(L, t, f"{path}/{name}/{leaf}", vary, block)
    y, new_cache = attention.gqa_apply(
        cfg, pp, enter(h, L, tp), mode=mode, positions=positions, cache=cache,
        attn_impl=attn_impl, kv_map=kv_map,
    )  # fmt: skip
    return leave(y, L, tp), new_cache


def mlp_region(cfg, p, h, L, path):
    """The dense FFN on the stream ``h``: column-parallel ``wi``/``wg``
    (and ``wi``'s bias), row-parallel ``wo`` whose partial sums are
    summed back onto the stream, ``wo``'s bias added once after; whole on
    each rank when ``d_ff`` does not divide over ``model``."""
    blk = L.block(_width(L, f"{path}/wi/w", p["wi"]["w"], 1))
    tp = blk is not None
    vary = L.vary_tp if tp else L.vary_whole
    pp = {}
    for name, sub in p.items():
        pp[name] = {}
        for leaf, t in sub.items():
            if name == "wo" and leaf == "b":
                continue  # added on the stream, after the reduction
            block = None
            if tp:
                block = (0 if (name == "wo" or leaf == "b") else 1, *blk)
            pp[name][leaf] = use(L, t, f"{path}/{name}/{leaf}", vary, block)
    y = leave(mlp_apply(cfg, pp, enter(h, L, tp)), L, tp)
    if "b" in p["wo"]:
        y = y + use(L, p["wo"]["b"], f"{path}/wo/b", L.vary_stream)
    return y


def _block_on_mesh(cfg, p, x, *, mixer, ffn, mode, positions, cache, attn_impl, L, path):
    def norm(name, x):
        return norm_apply(cfg, use_tree(L, p[name], f"{path}/{name}", L.vary_stream), x)

    h = norm("norm1", x)
    if mixer == ATTN:
        y, new_cache = attention_region(
            cfg, p["mixer"], h, L, f"{path}/mixer", mode=mode, positions=positions,
            cache=cache, attn_impl=attn_impl,
        )  # fmt: skip
    else:
        pm = use_tree(L, p["mixer"], f"{path}/mixer", L.vary_whole)
        y, new_cache = _whole_mixer(
            cfg, mixer, pm, enter(h, L, False), mode, positions, cache
        )
        y = leave(y, L, False)
    x = x + y
    if ffn == FFN_NONE:
        return x, new_cache, None
    h = norm("norm2", x)
    if ffn == FFN_DENSE:
        return x + mlp_region(cfg, p["ffn"], h, L, f"{path}/ffn"), new_cache, None
    y, aux = moe_stream(cfg, p["ffn"], h, L, mode=mode, path=f"{path}/ffn")
    return x + y, new_cache, aux


__all__ = [
    "attention_plan",
    "attention_region",
    "block_apply",
    "block_cache_init",
    "block_init",
    "mlp_region",
]
