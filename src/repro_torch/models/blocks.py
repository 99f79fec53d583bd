"""Decoder block: a (mixer, ffn) pair from the config's pattern.

The port of the reference's ``models/blocks.py``: the GQA, MLA, Mamba,
mLSTM and sLSTM mixers, the port's own KDA (``models/kda.py``; one card
only: the mesh paths refuse it), and the dense, MoE or no FFN.  A block
without an FFN (xLSTM's, whose mixers carry their own projections) has no
second norm either, as in the reference.  With ``cfg.hc_mult`` the
residual is the port's mHC stream (``models/hyper.py``): each sublayer in
a site of its own (``hc1`` around the mixer, ``hc2`` around the FFN), one
card only.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import (
    ATTN,
    FFN_DENSE,
    FFN_MOE,
    FFN_NONE,
    KDA,
    MAMBA,
    MLA,
    MLSTM,
    SLSTM,
    ModelConfig,
)
from repro_torch.models import attention, hyper, kda, ssm
from repro_torch.models.layers import mlp_apply, mlp_init, norm_apply, norm_init
from repro_torch.models.moe import moe_apply, moe_init, moe_stream
from repro_torch.models.sharding import _map_with_path, axis_size
from repro_torch.models.spmd import (
    combine,
    enter,
    gather,
    leave,
    own,
    psum,
    reblock,
    seq_split,
    use,
    use_tree,
    vary_model,
)

_MIXER_INIT = {
    ATTN: attention.gqa_init,
    MLA: attention.mla_init,
    MAMBA: ssm.mamba_init,
    MLSTM: ssm.mlstm_init,
    SLSTM: ssm.slstm_init,
    KDA: kda.kda_init,
}
# the recurrent mixers: their decode cache is a state of fixed size
_STATE_INIT = {
    MAMBA: ssm.mamba_state_init,
    MLSTM: ssm.mlstm_state_init,
    SLSTM: ssm.slstm_state_init,
    KDA: kda.kda_state_init,
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
    if cfg.hc_mult:
        p["hc1"] = hyper.hc_init(cfg, generator)
        if ffn != FFN_NONE:
            p["hc2"] = hyper.hc_init(cfg, generator)
    return p


def block_cache_init(
    cfg: ModelConfig,
    mixer: str,
    batch: int,
    cache_len: int,
    dtype,
    device,
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
    this rank's part of the stream, ``p`` its blocks of the params and
    ``cache`` its blocks of the cache at ``path`` ("groups/b0",
    "prefix/l0").  The norms run on the rank's rows (``[B/d, S/m, D]``
    when the stream is sequence-sharded); the sequence is all-gathered
    into the mixer and the FFN; every mixer and the dense FFN run tensor
    parallel where their widths divide over ``model`` (the ``*_region``
    functions); the MoE takes the stream as it is (``moe.moe_stream``).

    With ``cfg.hc_mult`` (one card), ``x`` is the mHC stream ``[B, S, n,
    D]`` and each sublayer runs inside its site (``models/hyper.py``)."""
    _check_kinds(mixer, ffn)
    if layout is not None:
        return _block_on_mesh(
            cfg, p, x, mixer=mixer, ffn=ffn, mode=mode, positions=positions,
            cache=cache, attn_impl=attn_impl, L=layout, path=path,
        )  # fmt: skip
    hc = cfg.hc_mult > 0
    if hc:
        u, coef = hyper.pre(cfg, p["hc1"], x)
    h = norm_apply(cfg, p["norm1"], u if hc else x)
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
    elif mixer == MAMBA:
        y, new_cache = ssm.mamba_apply(cfg, p["mixer"], h, mode=mode, state=cache)
    elif mixer == MLSTM:
        y, new_cache = ssm.mlstm_apply(cfg, p["mixer"], h, mode=mode, state=cache)
    elif mixer == KDA:
        y, new_cache = kda.kda_apply(cfg, p["mixer"], h, mode=mode, state=cache)
    else:
        y, new_cache = ssm.slstm_apply(cfg, p["mixer"], h, mode=mode, state=cache)
    x = hyper.post(x, y, coef) if hc else x + y
    if ffn == FFN_NONE:
        return x, new_cache, None
    if hc:
        u, coef = hyper.pre(cfg, p["hc2"], x)
    h = norm_apply(cfg, p["norm2"], u if hc else x)
    if ffn == FFN_DENSE:
        y, aux = mlp_apply(cfg, p["ffn"], h), None
    else:
        y, aux = moe_apply(cfg, p["ffn"], h, mode=mode)
    return (hyper.post(x, y, coef) if hc else x + y), new_cache, aux


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


def _use_blocks(L, p: dict, path: str, vary, blocks: dict) -> dict:
    """Every leaf of ``p`` (at ``path``) through :func:`use`: the block
    ``blocks`` names by the leaf's path below ``path``, else whole."""

    def one(rel, t):
        return use(L, t, f"{path}/{rel}", vary, blocks.get(rel))

    return _map_with_path(one, p)


def _to_stored(L, path: str, new: dict, dims: dict) -> dict:
    """A region's cache or state (each leaf split over ``model`` along
    ``dims[name]``, None: whole) as the rank stores it."""
    return {
        k: reblock(v, L, dims.get(k), L.cache_dim(f"{path}/{k}"))
        for k, v in new.items()
    }


def attention_region(cfg, p, h, L, path, *, mode, positions, cache, attn_impl):
    """GQA on the stream ``h`` (the block at ``path``): the rank's q heads
    and their kv heads (``wq``/``wk``/``wv`` column blocks, ``wo`` a row
    block, its output partial sums summed back onto the stream), or the
    whole attention on each rank when the heads do not divide over
    ``model``.  A cache whose kv heads do not divide is held in sequence
    blocks where its length divides (``cache_pspec``): the prefill keeps
    the rank's block, decode reads it through the split-K combine."""
    plan = attention_plan(cfg, L)
    tp = plan is not None
    qb, kvb, kv_map = plan if tp else (None, None, None)
    vary = L.vary_tp if tp else L.vary_whole
    hd = cfg.resolved_head_dim
    blocks = {}
    for name, heads in (("wq", qb), ("wk", kvb), ("wv", kvb), ("wo", qb)):
        for leaf in p[name]:
            if heads is not None:
                dim = 0 if (leaf == "b" or name == "wo") else 1
                blocks[f"{name}/{leaf}"] = (dim, heads[0] * hd, heads[1] * hd)
    pp = _use_blocks(L, p, f"{path}/mixer", vary, blocks)
    split = None
    if mode == "decode":
        split = seq_split(L, f"{path}/k", qb, cache["k"].shape[1])
    y, new_cache = attention.gqa_apply(
        cfg, pp, enter(h, L, tp), mode=mode, positions=positions, cache=cache,
        attn_impl=attn_impl, kv_map=kv_map, split=split,
    )  # fmt: skip
    if mode == "prefill":  # k/v: the rank's kv heads, or all of them
        dims = {"k": 2, "v": 2} if kvb is not None else {}
        new_cache = _to_stored(L, path, new_cache, dims)
    return leave(y, L, tp), new_cache


def mla_region(cfg, p, h, L, path, *, mode, positions, cache):
    """MLA on the stream ``h`` (the reference's ``attention.py:351-424``
    under ``make_wsc``): the rank's heads of ``wq``/``w_uq``, ``w_uk`` and
    ``w_uv`` (column blocks) and of ``wo`` (a row block, partial sums
    summed back onto the stream); the latent ``ckv`` and ``krope`` from
    weights whole over ``model``, the same on every model rank.  The
    prefill hands over the rank's sequence block of the latent cache
    where ``model`` splits it (``cache_pspec``; ``kpos`` whole); decode
    reads it through the split-K combine.  Whole on each rank when the
    heads do not divide over ``model``."""
    a = cfg.mla
    hb = L.block(cfg.n_heads)
    tp = hb is not None
    blocks = {}
    if tp:
        widths = {"wq/w": a.nope_head_dim + a.rope_head_dim, "w_uk/w": a.nope_head_dim,
                  "w_uv/w": a.v_head_dim, "wo/w": a.v_head_dim}  # fmt: skip
        widths["w_uq/w"] = widths["wq/w"]
        for rel, width in widths.items():
            blocks[rel] = (0 if rel == "wo/w" else 1, hb[0] * width, hb[1] * width)
    pp = _use_blocks(L, p, f"{path}/mixer", L.vary_tp if tp else L.vary_whole, blocks)
    split = None
    if mode == "decode":
        split = seq_split(L, f"{path}/ckv", hb, cache["ckv"].shape[1])
    y, new_cache = attention.mla_apply(
        cfg, pp, enter(h, L, tp), mode=mode, positions=positions, cache=cache,
        split=split,
    )  # fmt: skip
    if mode == "prefill":
        new_cache = _to_stored(L, path, new_cache, {})
    return leave(y, L, tp), new_cache


def _from_stored(L, path, cache, dims) -> dict | None:
    """Decode's stored state as the region runs it (each leaf split over
    ``model`` along ``dims[name]``, None: whole)."""
    if cache is None:
        return None
    return {
        k: reblock(v, L, L.cache_dim(f"{path}/{k}"), dims.get(k))
        for k, v in cache.items()
    }


def mamba_region(cfg, p, h, L, path, *, mode, positions, cache):
    """Mamba on the stream ``h`` (the reference's ``ssm.py:156-205`` under
    ``_make_wsc_ch``), over the rank's channels of ``d_inner``:
    ``in_proj`` column-parallel (the rank's channels of ``x`` and of
    ``z``: ``use`` all-gathers the weight over ``model`` and cuts both,
    as the stored column block holds only one half's), the conv,
    ``dt_proj``, ``a_log``, ``d_skip`` and the scan on those channels,
    ``x_proj`` row-parallel with its partial sums combined over ``model``
    (dt's rank input, B and C are needed whole), ``out_proj``
    row-parallel.  The state is held by channel.  Whole on each rank when
    ``d_inner`` does not divide over ``model``."""
    di = cfg.ssm.expand * cfg.d_model
    cb = L.block(di)
    tp = cb is not None
    blocks, dims, split = {}, {}, ssm.WHOLE
    if tp:
        lo, n = cb
        blocks = {"in_proj/w": (1, ((lo, n), (di + lo, n))), "dt_proj/w": (1, lo, n)}
        for rel in ("conv_w", "conv_b", "x_proj/w", "dt_proj/b", "a_log", "d_skip",
                    "out_proj/w"):  # fmt: skip
            blocks[rel] = (0, lo, n)
        dims = {"conv": 2, "ssm": 1}
        split = ssm.Split(reduce=lambda t: combine(t, L))
    pp = _use_blocks(L, p, f"{path}/mixer", L.vary_tp if tp else L.vary_whole, blocks)
    y, new = ssm.mamba_apply(
        cfg, pp, enter(h, L, tp), mode=mode, state=_from_stored(L, path, cache, dims),
        split=split,
    )  # fmt: skip
    if new is not None:
        new = _to_stored(L, path, new, dims)
    return leave(y, L, tp), new


def mlstm_region(cfg, p, h, L, path, *, mode, positions, cache):
    """mLSTM on the stream ``h`` (the reference's ``ssm.py:259-325``):
    ``in_proj`` column-parallel (both halves, as Mamba's), the conv on
    the rank's channels, which are all-gathered over ``model`` into
    ``wq``/``wk``/``wv``; ``w_if`` row-parallel, its partial sums combined;
    ``out_proj`` row-parallel.  The cell runs on the rank's heads where
    the heads divide over ``model`` (their channels are the rank's block
    of ``d_inner``), else whole on each rank between the channel-split
    projections (its output cut to the rank's channels).  Whole on each
    rank when ``d_inner`` does not divide."""
    di = int(cfg.xlstm.mlstm_proj_factor * cfg.d_model)
    dh = di // cfg.n_heads
    cb = L.block(di)
    hb = L.block(cfg.n_heads) if cb is not None else None
    blocks, dims, split = {}, {}, ssm.WHOLE
    if cb is not None:
        lo, n = cb
        blocks = {"in_proj/w": (1, ((lo, n), (di + lo, n)))}
        for rel in ("conv_w", "conv_b", "w_if/w", "out_proj/w"):
            blocks[rel] = (0, lo, n)
        dims = {"conv": 2}
        if hb is not None:  # the cell on the rank's heads
            for rel in ("wq/w", "wk/w", "wv/w"):
                blocks[rel] = (1, hb[0] * dh, hb[1] * dh)
            dims.update(c=1, n=1, m=1)
            split = ssm.Split(
                reduce=lambda t: combine(t, L),
                whole=lambda t: gather(t, L, 2, True),
                head0=hb[0],
            )
        else:  # the cell whole on each rank
            split = ssm.Split(
                reduce=lambda t: psum(t, L, (L.model,)),
                whole=lambda t: gather(t, L, 2, False),
                own=lambda t: own(t, L, 2, lo, n),
            )
    qkv = ("wq", "wk", "wv")
    vary = L.vary_tp if cb is not None else L.vary_whole
    pp = _use_blocks(L, {k: v for k, v in p.items() if k not in qkv},
                     f"{path}/mixer", vary, blocks)  # fmt: skip
    if hb is None:  # q, k and v: the same on every model rank
        vary = L.vary_whole
    pp.update(_use_blocks(L, {k: p[k] for k in qkv}, f"{path}/mixer", vary, blocks))
    y, new = ssm.mlstm_apply(
        cfg, pp, enter(h, L, cb is not None), mode=mode,
        state=_from_stored(L, path, cache, dims), split=split,
    )  # fmt: skip
    if new is not None:
        new = _to_stored(L, path, new, dims)
    return leave(y, L, cb is not None), new


def slstm_region(cfg, p, h, L, path, *, mode, positions, cache):
    """sLSTM on the stream ``h`` (the reference's ``ssm.py:377-421``): the
    recurrence on the rank's heads (``w_x``'s columns of those heads in
    all four gates, ``r_h`` by head), then the post gated FFN with
    ``ffn_up`` column-parallel (both halves) and ``ffn_down``
    row-parallel, the heads' output all-gathered over ``model`` between
    them.  The recurrence runs whole on each rank where the heads do not
    divide over ``model``, the FFN where ``d_ff`` does not."""
    d = cfg.d_model
    dh = d // cfg.n_heads
    dff = _width(L, f"{path}/mixer/ffn_up/w", p["ffn_up"]["w"], 1) // 2
    hb, fb = L.block(cfg.n_heads), L.block(dff)
    blocks, dims = {}, {}
    if hb is not None:
        lo, n = hb[0] * dh, hb[1] * dh
        gates = tuple((g * d + lo, n) for g in range(4))
        blocks = {"w_x/w": (1, gates), "w_x/b": (0, gates), "r_h": (1, *hb)}
        dims = dict.fromkeys("hcnm", 1)
    cell = {k: p[k] for k in ("w_x", "r_h")}
    vary = L.vary_tp if hb is not None else L.vary_whole
    pc = _use_blocks(L, cell, f"{path}/mixer", vary, blocks)
    y, new = ssm.slstm_cell(
        cfg, pc, enter(h, L, hb is not None), mode=mode,
        state=_from_stored(L, path, cache, dims),
    )  # fmt: skip
    if new is not None:
        new = _to_stored(L, path, new, dims)
    if hb is not None:  # the heads' channels whole for ffn_up
        y = gather(y, L, 2, fb is not None)
    elif fb is not None:  # the same on every model rank, into a split FFN
        y = vary_model(y, L)
    blocks = {}
    if fb is not None:
        lo, n = fb
        blocks = {"ffn_up/w": (1, ((lo, n), (dff + lo, n))), "ffn_down/w": (0, lo, n)}
    ffn = {k: p[k] for k in ("ffn_up", "ffn_down")}
    vary = L.vary_tp if fb is not None else L.vary_whole
    y = ssm.slstm_ffn(_use_blocks(L, ffn, f"{path}/mixer", vary, blocks), y)
    return leave(y, L, fb is not None), new


_REGIONS = {MLA: mla_region, MAMBA: mamba_region, MLSTM: mlstm_region,
            SLSTM: slstm_region}  # fmt: skip


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
            cfg, p["mixer"], h, L, path, mode=mode, positions=positions,
            cache=cache, attn_impl=attn_impl,
        )  # fmt: skip
    else:
        y, new_cache = _REGIONS[mixer](
            cfg, p["mixer"], h, L, path, mode=mode, positions=positions, cache=cache
        )
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
    "mamba_region",
    "mla_region",
    "mlp_region",
    "mlstm_region",
    "slstm_region",
]
