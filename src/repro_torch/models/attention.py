"""Attention mixers: GQA/MHA with an optional sliding window, and
DeepSeek-V2's multi-head latent attention (MLA).

The port of the reference's ``models/attention.py``.

Serving's prefill (``attn_impl="kernel"``, the default) runs the
hand-written ``flash_attention`` kernel: the same function as the
reference's ``chunked_attention`` and its ``attn_impl="pallas"`` route.
Training runs :func:`chunked_attention` (``attn_impl="chunked"``), the
port of the reference's plain online-softmax attention, which is what
the reference trains through and which autograd differentiates (the
kernel has no backward and refuses a gradient).  Decode attends one
token against a KV cache with a plain einsum, as the reference does.
The cache is a ring buffer of ``sliding_window`` slots for SWA models,
full-length otherwise; position ``p`` lives in slot ``p % window``.
Positions are ``[B, S]``, or ``[3, B, S]`` for M-RoPE, whose first (t)
coordinate is the one a cache slot records.

MLA trains and prefills on the expanded path (per-head k and v from the
latent) through :func:`chunked_attention` whatever ``attn_impl`` says:
its q/k heads (nope + rope, 192 wide at full width) are past the
kernel's largest head_dim, and the reference runs it there too.  Decode
is the absorbed path: scores and the weighted sum in the
``kv_lora_rank`` latent space, products in float32; its cache is the
latent ``{ckv, krope, kpos}``.  Where the config asks for them
(``MLAConfig.latent_norms``: Xing4.0's) the q latent passes an
RMSNorm between ``w_dq`` and ``w_uq``, and the kv latent one after
``w_dkv``, before it is cached.

On a mesh a decode cache that ``model`` splits along the sequence (MLA's
latent cache; a kv cache whose heads do not divide) is read through a
split-K combine: ``split`` (``models/spmd.py::SeqSplit``) gives each
rank's partial softmax's max, sum and weighted values to an all-reduce.
The softmax at decode is written out (max, exponentials, sum, divide)
so that the combine and one device run the same operations.

Two deliberate differences from the reference:

* the prefill -> decode handoff for a sliding window: when the prompt is
  longer than the window, the reference hands the last ``w`` keys over at
  slots ``0..w-1``, so unless ``s % w == 0`` decode overwrites keys that
  are still inside the window.  Here they are rolled by ``s % w`` so that
  position ``p`` sits in slot ``p % w``;
* decode writes the new key and value into the cache in place (the
  reference returns new arrays; its serving loop donates the old ones).
"""

from __future__ import annotations

import torch

from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import NEG_INF, flash_attention
from repro_torch.models import rope as rope_lib
from repro_torch.models.layers import (
    dense_apply,
    dense_init,
    norm_apply,
    norm_init,
    torch_dtype,
)

F32 = torch.float32
ATTN_IMPLS = ("kernel", "chunked")
SCORE_BYTES = 2 << 30  # float32 scores of one query chunk, batch and heads


def _q_block(qi, qblk, k, v, *, causal, window, scale, kv_chunk, softcap):
    """One query chunk of :func:`chunked_attention`: the online softmax over
    every kv chunk (none is skipped, as in the reference), products in
    float32, P rounded to v's dtype before the second product."""
    b, qc, hq, _ = qblk.shape
    s = k.shape[1]
    dev = qblk.device
    qpos = qi * qc + torch.arange(qc, device=dev)
    qf = qblk.float()
    m = torch.full((b, hq, qc), NEG_INF, dtype=F32, device=dev)
    l = torch.zeros((b, hq, qc), dtype=F32, device=dev)  # noqa: E741
    acc = torch.zeros((b, hq, qc, v.shape[-1]), dtype=F32, device=dev)
    for kj in range(s // kv_chunk):
        kblk = k[:, kj * kv_chunk : (kj + 1) * kv_chunk]
        vblk = v[:, kj * kv_chunk : (kj + 1) * kv_chunk]
        kpos = kj * kv_chunk + torch.arange(kv_chunk, device=dev)
        s_blk = torch.einsum("bqhd,bkhd->bhqk", qf, kblk.float()) * scale
        if softcap > 0.0:
            s_blk = softcap * torch.tanh(s_blk / softcap)
        mask = torch.ones((qc, kv_chunk), dtype=torch.bool, device=dev)
        if causal:
            mask &= kpos[None, :] <= qpos[:, None]
        if window is not None:
            mask &= (qpos[:, None] - kpos[None, :]) < window
        s_blk = torch.where(mask, s_blk, NEG_INF)
        # the running max only shifts the exponent: the output does not
        # depend on it, so it carries no gradient
        m_new = torch.maximum(m, s_blk.detach().amax(-1))
        p = torch.exp(s_blk - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)  # noqa: E741
        pv = torch.einsum("bhqk,bkhd->bhqd", p.to(vblk.dtype).float(), vblk.float())
        acc = acc * corr[..., None] + pv
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]  # [B, hq, qc, dv]
    return out.transpose(1, 2).to(qblk.dtype)


def chunked_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool,
    window: int | None,
    scale: float,
    q_chunk: int = 512,
    kv_chunk: int = 1024,
    softcap: float = 0.0,
) -> torch.Tensor:
    """q [B,S,Hq,D], k/v [B,S,Hkv,Dk]/[B,S,Hkv,Dv] -> [B,S,Hq,Dv].

    The reference's ``chunked_attention``: GQA kv heads repeated to Hq, an
    online softmax over ``q_chunk`` x ``kv_chunk`` blocks with causal,
    window and softcap masking, accumulated in float32.  Under autograd
    each query chunk is checkpointed (the reference's ``jax.checkpoint``
    of its ``q_step``), so the backward holds one chunk's scores at a
    time.  S must be a multiple of both chunks (after ``min(chunk, S)``).

    Where one query chunk's float32 scores over the whole batch would pass
    :data:`SCORE_BYTES`, the batch runs in slices of rows that stay under
    it (Kimi-Linear's prefill at batch 128: 8.6 GB a chunk whole)."""
    b, s, hq, _ = q.shape
    qc, kc = min(q_chunk, s), min(kv_chunk, s)
    rows = max(1, SCORE_BYTES // (hq * qc * kc * 4))
    if b > rows:
        kw = dict(causal=causal, window=window, scale=scale, q_chunk=q_chunk,
                  kv_chunk=kv_chunk, softcap=softcap)  # fmt: skip
        parts = [
            chunked_attention(*(t[lo : lo + rows] for t in (q, k, v)), **kw)
            for lo in range(0, b, rows)
        ]
        return torch.cat(parts)
    g = hq // k.shape[2]
    if s % qc or s % kc:
        raise ValueError(
            f"chunked_attention: S={s} is no multiple of the chunks ({qc}, {kc})"
        )
    if g > 1:
        k = k.repeat_interleave(g, dim=2)
        v = v.repeat_interleave(g, dim=2)
    kw = dict(causal=causal, window=window, scale=scale, kv_chunk=kc, softcap=softcap)
    outs = []
    for qi in range(s // qc):
        qblk = q[:, qi * qc : (qi + 1) * qc]
        if torch.is_grad_enabled():
            outs.append(checkpoint(_q_block, qi, qblk, k, v, use_reentrant=False, **kw))
        else:
            outs.append(_q_block(qi, qblk, k, v, **kw))
    return torch.cat(outs, 1)


def _softmax(s: torch.Tensor, split=None) -> torch.Tensor:
    """Softmax over the last dim, whose entries ``split`` may spread over
    ranks (each holds its block of the keys): the max and the sum of
    exponentials combined over them."""
    m = s.amax(-1, keepdim=True)
    if split is not None:
        m = split.max(m)
    e = torch.exp(s - m)
    total = e.sum(-1, keepdim=True)
    if split is not None:
        total = split.sum(total)
    return e / total


def _own_slots(kpos: torch.Tensor, split) -> torch.Tensor:
    """The positions of the slots this rank holds (all without a split)."""
    return kpos if split is None else kpos[:, split.start : split.start + split.size]


def decode_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    scale: float,
    kpos: torch.Tensor,
    pos: torch.Tensor,
    window: int | None,
    softcap: float = 0.0,
    split=None,
) -> torch.Tensor:
    """Single-token attention against a cache, in float32.

    q [B,1,Hq,D], k/v [B,L,Hkv,D]; kpos [B,L] absolute positions of the
    cache entries (-1 marks an empty slot; ring buffers are unordered);
    pos [B] current position.  ``split``: k/v are this rank's block of
    the slots (kpos all of them); the query's heads are gathered, the
    blocks' partial softmaxes combined, and the rank's heads returned."""
    if split is not None:
        q = split.whole_heads(q, 2)
    b, _, hq, d = q.shape
    hkv = k.shape[2]
    kpos = _own_slots(kpos, split)
    qg = q.reshape(b, hkv, hq // hkv, d).float()
    s_ = torch.einsum("bhgd,bkhd->bhgk", qg, k.float()) * scale
    if softcap > 0.0:
        s_ = softcap * torch.tanh(s_ / softcap)
    valid = (kpos >= 0) & (kpos <= pos[:, None])
    if window is not None:
        valid &= (pos[:, None] - kpos) < window
    s_ = s_.masked_fill(~valid[:, None, None, :], NEG_INF)
    p = _softmax(s_, split)
    out = torch.einsum("bhgk,bkhd->bhgd", p, v.float())
    if split is not None:
        out = split.sum(out)
    out = out.reshape(b, 1, hq, v.shape[-1]).to(q.dtype)
    return out if split is None else split.own_heads(out, 2)


def gqa_init(cfg: ModelConfig, generator: torch.Generator) -> dict:
    dtype = torch_dtype(cfg.dtype)
    d, hd = cfg.d_model, cfg.resolved_head_dim
    bias = cfg.qkv_bias
    return {
        "wq": dense_init(d, cfg.n_heads * hd, dtype, generator, bias=bias),
        "wk": dense_init(d, cfg.n_kv_heads * hd, dtype, generator, bias=bias),
        "wv": dense_init(d, cfg.n_kv_heads * hd, dtype, generator, bias=bias),
        "wo": dense_init(cfg.n_heads * hd, d, dtype, generator),
    }


def gqa_cache_init(
    cfg: ModelConfig,
    batch: int,
    cache_len: int,
    dtype: torch.dtype,
    device,
) -> dict[str, torch.Tensor]:
    """cache_len already accounts for sliding windows (ring buffer)."""
    shape = (batch, cache_len, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        # absolute positions held in each slot (-1 = empty)
        "kpos": torch.full((batch, cache_len), -1, dtype=torch.int32, device=device),
    }


def _cache_positions(positions: torch.Tensor) -> torch.Tensor:
    """The positions a cache records: [B, S], the t coordinate of M-RoPE's
    [3, B, S]."""
    return positions if positions.dim() == 2 else positions[0]


def _decode_pos(positions: torch.Tensor) -> torch.Tensor:
    """Decode's current position [B] from [B, 1] or M-RoPE's [3, B, 1]."""
    return _cache_positions(positions)[:, 0]


def prefill_cache(
    k: torch.Tensor, v: torch.Tensor, positions: torch.Tensor, window: int | None
) -> dict[str, torch.Tensor]:
    """The decode cache a prefill of ``s`` tokens hands over: everything, or
    for a window shorter than the prompt the last ``w`` entries rolled by
    ``s % w``, so that position ``p`` sits in slot ``p % w`` where decode
    looks for it."""
    positions = _cache_positions(positions)
    s = k.shape[1]
    if window is None or s <= window:
        return {"k": k, "v": v, "kpos": positions}
    shift = s % window
    return {
        "k": k[:, -window:].roll(shift, 1),
        "v": v[:, -window:].roll(shift, 1),
        "kpos": positions[:, -window:].roll(shift, 1),
    }


def select_kv(t: torch.Tensor, kv_map: range | None) -> torch.Tensor:
    """The kv heads of ``t`` ``[B, L, H, hd]`` that a rank's q heads attend
    with: all of them (``kv_map`` None) or a contiguous ``range`` of them
    (each q group over one of them), contiguous."""
    if kv_map is None:
        return t
    return t.narrow(2, kv_map.start, len(kv_map)).contiguous()


def gqa_apply(
    cfg: ModelConfig,
    p: dict,
    x: torch.Tensor,
    *,
    mode: str,
    positions: torch.Tensor,
    cache: dict[str, torch.Tensor] | None = None,
    attn_impl: str = "kernel",
    kv_map=None,
    split=None,
):
    """x [B,S,D] (train/prefill) or [B,1,D] (decode); positions [B,S] or
    M-RoPE's [3,B,S].  ``attn_impl`` picks the train/prefill attention:
    ``"kernel"`` (the ``flash_attention`` kernel, forward only) or
    ``"chunked"`` (:func:`chunked_attention`, differentiable).  Returns (y, cache): the
    prefill's cache to hand over, decode's updated cache (the same
    tensors, written in place), or None in train mode.

    The head counts are the weights' (``wq``'s columns over head_dim, and
    ``wk``'s): on a mesh, a rank's block of the heads.  ``kv_map``
    (:func:`select_kv`) picks the kv heads its q heads attend with where
    its kv columns are not already its q heads' own; the cache keeps
    the kv heads as computed.  ``split``: decode's cache is this rank's
    block of the slots (:func:`decode_attention`; ``kv_map`` unused)."""
    if attn_impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}, not {attn_impl!r}")
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    hq, hkv = p["wq"]["w"].shape[1] // hd, p["wk"]["w"].shape[1] // hd
    q = dense_apply(p["wq"], x).reshape(b, s, hq, hd)
    k = dense_apply(p["wk"], x).reshape(b, s, hkv, hd)
    v = dense_apply(p["wv"], x).reshape(b, s, hkv, hd)
    scale = hd**-0.5

    cs = rope_lib.cos_sin_for(cfg, positions)
    if cs is not None:
        q = rope_lib.apply_rope(q, *cs)
        k = rope_lib.apply_rope(k, *cs)

    window = cfg.sliding_window
    if mode in ("train", "prefill"):
        attend = flash_attention if attn_impl == "kernel" else chunked_attention
        y = attend(
            q,
            select_kv(k, kv_map),
            select_kv(v, kv_map),
            causal=True,
            window=window,
            scale=scale,
            softcap=cfg.attn_logit_softcap,
        )
        new_cache = None
        if mode == "prefill":
            new_cache = prefill_cache(k, v, positions, window)
    elif mode == "decode":
        pos = _decode_pos(positions)
        # kpos holds every slot, also where a rank holds a block of k/v
        slot = pos if window is None else pos % cache["kpos"].shape[1]
        bidx = torch.arange(b, device=x.device)
        slot = slot.long()
        _write(cache, "k", bidx, slot, k[:, 0], split)
        _write(cache, "v", bidx, slot, v[:, 0], split)
        cache["kpos"][bidx, slot] = pos.to(torch.int32)
        if split is not None:
            kv_map = None
        y = decode_attention(
            q,
            select_kv(cache["k"], kv_map),
            select_kv(cache["v"], kv_map),
            scale=scale,
            kpos=cache["kpos"],
            pos=pos,
            window=window,
            softcap=cfg.attn_logit_softcap,
            split=split,
        )
        new_cache = cache
    else:
        raise ValueError(f"unknown mode {mode!r}")
    y = y.reshape(b, s, hq * hd)
    return dense_apply(p["wo"], y), new_cache


def _write(cache: dict, name: str, rows, slot, value, split) -> None:
    """Decode's new entry into ``cache[name]`` at ``slot`` of each row (on
    a sequence split, only where this rank holds the slot)."""
    if split is None:
        cache[name][rows, slot] = value
    else:
        split.write(cache[name], rows, slot, value)


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2 multi-head latent attention)
# ---------------------------------------------------------------------------
def mla_init(cfg: ModelConfig, generator: torch.Generator) -> dict:
    a = cfg.mla
    dtype = torch_dtype(cfg.dtype)
    d, h = cfg.d_model, cfg.n_heads
    qd = a.nope_head_dim + a.rope_head_dim
    p = {
        "w_dkv": dense_init(d, a.kv_lora_rank, dtype, generator),
        "w_krope": dense_init(d, a.rope_head_dim, dtype, generator),
        "w_uk": dense_init(a.kv_lora_rank, h * a.nope_head_dim, dtype, generator),
        "w_uv": dense_init(a.kv_lora_rank, h * a.v_head_dim, dtype, generator),
        "wo": dense_init(h * a.v_head_dim, d, dtype, generator),
    }
    if a.q_lora_rank:
        p["w_dq"] = dense_init(d, a.q_lora_rank, dtype, generator)
        p["w_uq"] = dense_init(a.q_lora_rank, h * qd, dtype, generator)
        if a.latent_norms:
            p["q_norm"] = norm_init(cfg, a.q_lora_rank, generator.device)
    else:
        p["wq"] = dense_init(d, h * qd, dtype, generator)
    if a.latent_norms:
        p["kv_norm"] = norm_init(cfg, a.kv_lora_rank, generator.device)
    return p


def mla_cache_init(
    cfg: ModelConfig, batch: int, cache_len: int, dtype: torch.dtype, device
) -> dict[str, torch.Tensor]:
    a = cfg.mla
    return {
        "ckv": torch.zeros(
            (batch, cache_len, a.kv_lora_rank), dtype=dtype, device=device
        ),
        "krope": torch.zeros(
            (batch, cache_len, a.rope_head_dim), dtype=dtype, device=device
        ),
        "kpos": torch.full((batch, cache_len), -1, dtype=torch.int32, device=device),
    }


def _mla_q(cfg: ModelConfig, p: dict, x: torch.Tensor, positions: torch.Tensor):
    """(q_nope [B,S,H,nope], q_rope [B,S,H,rope] rotated, the rope's
    cos/sin), H the heads of the weights (on a mesh, the rank's).  With
    ``cfg.rope == "none"`` the rope part stays a plain projection and
    cos/sin are None."""
    a = cfg.mla
    b, s, _ = x.shape
    if a.q_lora_rank:
        q = dense_apply(p["w_dq"], x)
        if a.latent_norms:  # the q latent's RMSNorm
            q = norm_apply(cfg, p["q_norm"], q)
        q = dense_apply(p["w_uq"], q)
    else:
        q = dense_apply(p["wq"], x)
    q = q.reshape(b, s, -1, a.nope_head_dim + a.rope_head_dim)
    q_nope, q_rope = q[..., : a.nope_head_dim], q[..., a.nope_head_dim :]
    cs = rope_lib.cos_sin_for(cfg, positions, head_dim=a.rope_head_dim)
    if cs is None:  # rope "none" (Kimi-Linear's mla_use_nope): nothing rotated
        return q_nope, q_rope, None
    return q_nope, rope_lib.apply_rope(q_rope, *cs), cs


def mla_apply(
    cfg: ModelConfig,
    p: dict,
    x: torch.Tensor,
    *,
    mode: str,
    positions: torch.Tensor,
    cache: dict[str, torch.Tensor] | None = None,
    split=None,
):
    """x [B,S,D] (train/prefill) or [B,1,D] (decode).  Returns (y, cache)
    as :func:`gqa_apply` does; the cache is the latent ``{ckv, krope,
    kpos}``, written in place at decode.  The heads are ``w_uk``'s (on a
    mesh, the rank's).  ``split``: decode's latent cache is this rank's
    block of the sequence; each rank gathers every head's latent query,
    scores it against its own slots, the partial softmaxes are combined
    over ``model``, and the rank's heads go on into ``w_uv``."""
    a = cfg.mla
    b, s, _ = x.shape
    h = p["w_uk"]["w"].shape[1] // a.nope_head_dim
    scale = (a.nope_head_dim + a.rope_head_dim) ** -0.5
    q_nope, q_rope, cs = _mla_q(cfg, p, x, positions)
    ckv = dense_apply(p["w_dkv"], x)  # [B, S, r]
    if a.latent_norms:  # the kv latent's RMSNorm, before the cache
        ckv = norm_apply(cfg, p["kv_norm"], ckv)
    krope = dense_apply(p["w_krope"], x)[:, :, None, :]
    if cs is not None:
        krope = rope_lib.apply_rope(krope, *cs)
    krope = krope[:, :, 0]  # [B, S, rope]

    if mode in ("train", "prefill"):
        # expanded path: per-head k/v materialised from the latent
        k_nope = dense_apply(p["w_uk"], ckv).reshape(b, s, h, a.nope_head_dim)
        v = dense_apply(p["w_uv"], ckv).reshape(b, s, h, a.v_head_dim)
        kr = krope[:, :, None, :].expand(b, s, h, a.rope_head_dim)
        k = torch.cat([k_nope, kr], -1)
        q = torch.cat([q_nope, q_rope], -1)
        y = chunked_attention(q, k, v, causal=True, window=None, scale=scale)
        new_cache = None
        if mode == "prefill":
            kpos = _cache_positions(positions)
            new_cache = {"ckv": ckv, "krope": krope, "kpos": kpos}
    elif mode == "decode":
        # absorbed path: score and combine in the latent space
        pos = _decode_pos(positions)
        bidx = torch.arange(b, device=x.device)
        slot = pos.long()
        _write(cache, "ckv", bidx, slot, ckv[:, 0], split)
        _write(cache, "krope", bidx, slot, krope[:, 0], split)
        cache["kpos"][bidx, slot] = pos.to(torch.int32)
        ckv_c, kr_c = cache["ckv"].float(), cache["krope"].float()
        kpos = _own_slots(cache["kpos"], split)
        r = a.kv_lora_rank
        w_uk = p["w_uk"]["w"].reshape(r, h, a.nope_head_dim).float()
        # W_uk absorbed into q: q_lat [B, H, r], rounded as the reference's
        q_lat = torch.einsum("bhd,rhd->bhr", q_nope[:, 0].float(), w_uk).to(x.dtype)
        q_r = q_rope[:, 0]
        if split is not None:  # every head's query against this rank's slots
            q_lat, q_r = split.whole_heads(q_lat, 1), split.whole_heads(q_r, 1)
        s_lat = torch.einsum("bhr,bkr->bhk", q_lat.float(), ckv_c)
        s_rope = torch.einsum("bhd,bkd->bhk", q_r.float(), kr_c)
        s_all = (s_lat + s_rope) * scale
        valid = (kpos >= 0) & (kpos <= pos[:, None])
        s_all = s_all.masked_fill(~valid[:, None, :], NEG_INF)
        pr = _softmax(s_all, split).to(x.dtype)
        o_lat = torch.einsum("bhk,bkr->bhr", pr.float(), ckv_c)
        if split is not None:
            o_lat = split.own_heads(split.sum(o_lat), 1)
        o_lat = o_lat.to(x.dtype)
        w_uv = p["w_uv"]["w"].reshape(r, h, a.v_head_dim).float()
        y = torch.einsum("bhr,rhd->bhd", o_lat.float(), w_uv).to(x.dtype)[:, None]
        new_cache = cache
    else:
        raise ValueError(f"unknown mode {mode!r}")
    y = y.reshape(b, s, h * a.v_head_dim)
    return dense_apply(p["wo"], y), new_cache


__all__ = [
    "ATTN_IMPLS",
    "chunked_attention",
    "decode_attention",
    "gqa_apply",
    "gqa_cache_init",
    "gqa_init",
    "mla_apply",
    "mla_cache_init",
    "mla_init",
    "prefill_cache",
    "select_kv",
]
