"""GQA/MHA attention with an optional sliding window.

The port of the reference's ``models/attention.py`` (GQA only; MLA waits
for the zoo slice of deepseek-v2-lite, and ``blocks.py`` raises for it).

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
from repro_torch.models.layers import dense_apply, dense_init, torch_dtype

F32 = torch.float32
ATTN_IMPLS = ("kernel", "chunked")


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
    time.  S must be a multiple of both chunks (after ``min(chunk, S)``)."""
    b, s, hq, _ = q.shape
    g = hq // k.shape[2]
    qc, kc = min(q_chunk, s), min(kv_chunk, s)
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
) -> torch.Tensor:
    """Single-token attention against a cache, in float32.

    q [B,1,Hq,D], k/v [B,L,Hkv,D]; kpos [B,L] absolute positions of the
    cache entries (-1 marks an empty slot; ring buffers are unordered);
    pos [B] current position."""
    b, _, hq, d = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, hkv, hq // hkv, d).float()
    s_ = torch.einsum("bhgd,bkhd->bhgk", qg, k.float()) * scale
    if softcap > 0.0:
        s_ = softcap * torch.tanh(s_ / softcap)
    valid = (kpos >= 0) & (kpos <= pos[:, None])
    if window is not None:
        valid &= (pos[:, None] - kpos) < window
    s_ = s_.masked_fill(~valid[:, None, None, :], NEG_INF)
    p = torch.softmax(s_, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", p, v.float())
    return out.reshape(b, 1, hq, v.shape[-1]).to(q.dtype)


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
    cfg: ModelConfig, batch: int, cache_len: int, dtype: torch.dtype, device
) -> dict[str, torch.Tensor]:
    """cache_len already accounts for sliding windows (ring buffer)."""
    shape = (batch, cache_len, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        # absolute positions held in each slot (-1 = empty)
        "kpos": torch.full((batch, cache_len), -1, dtype=torch.int32, device=device),
    }


def prefill_cache(
    k: torch.Tensor, v: torch.Tensor, positions: torch.Tensor, window: int | None
) -> dict[str, torch.Tensor]:
    """The decode cache a prefill of ``s`` tokens hands over: everything, or
    for a window shorter than the prompt the last ``w`` entries rolled by
    ``s % w``, so that position ``p`` sits in slot ``p % w`` where decode
    looks for it."""
    s = k.shape[1]
    if window is None or s <= window:
        return {"k": k, "v": v, "kpos": positions}
    shift = s % window
    return {
        "k": k[:, -window:].roll(shift, 1),
        "v": v[:, -window:].roll(shift, 1),
        "kpos": positions[:, -window:].roll(shift, 1),
    }


def gqa_apply(
    cfg: ModelConfig,
    p: dict,
    x: torch.Tensor,
    *,
    mode: str,
    positions: torch.Tensor,
    cache: dict[str, torch.Tensor] | None = None,
    attn_impl: str = "kernel",
):
    """x [B,S,D] (train/prefill) or [B,1,D] (decode); positions [B,S].
    ``attn_impl`` picks the train/prefill attention: ``"kernel"`` (the
    ``flash_attention`` kernel, forward only) or ``"chunked"``
    (:func:`chunked_attention`, differentiable).  Returns (y, cache): the
    prefill's cache to hand over, decode's updated cache (the same
    tensors, written in place), or None in train mode."""
    if attn_impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}, not {attn_impl!r}")
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    q = dense_apply(p["wq"], x).reshape(b, s, cfg.n_heads, hd)
    k = dense_apply(p["wk"], x).reshape(b, s, cfg.n_kv_heads, hd)
    v = dense_apply(p["wv"], x).reshape(b, s, cfg.n_kv_heads, hd)
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
            k,
            v,
            causal=True,
            window=window,
            scale=scale,
            softcap=cfg.attn_logit_softcap,
        )
        new_cache = None
        if mode == "prefill":
            new_cache = prefill_cache(k, v, positions, window)
    elif mode == "decode":
        pos = positions[:, 0]
        slot = pos if window is None else pos % cache["k"].shape[1]
        bidx = torch.arange(b, device=x.device)
        slot = slot.long()
        cache["k"][bidx, slot] = k[:, 0]
        cache["v"][bidx, slot] = v[:, 0]
        cache["kpos"][bidx, slot] = pos.to(torch.int32)
        y = decode_attention(
            q,
            cache["k"],
            cache["v"],
            scale=scale,
            kpos=cache["kpos"],
            pos=pos,
            window=window,
            softcap=cfg.attn_logit_softcap,
        )
        new_cache = cache
    else:
        raise ValueError(f"unknown mode {mode!r}")
    y = y.reshape(b, s, cfg.n_heads * hd)
    return dense_apply(p["wo"], y), new_cache


__all__ = [
    "ATTN_IMPLS",
    "chunked_attention",
    "decode_attention",
    "gqa_apply",
    "gqa_cache_init",
    "gqa_init",
    "prefill_cache",
]
