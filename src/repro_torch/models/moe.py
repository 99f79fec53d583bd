"""Mixture-of-Experts FFN: a float32 softmax router, top-k gates and
capacity-based dispatch to a grouped SwiGLU over every expert.

The port of the reference's ``models/moe.py``, its single-shard path
(the replicated branch of ``_moe_local``): one card holds every expert.
Its expert-parallel ``shard_map`` and all-to-all branches wait for the
multi-GPU axis.

Dispatch keeps the reference's capacity semantics.  Each expert takes at
most ``C = max(1, ceil(top_k * T * capacity_factor / E))`` of the ``T *
top_k`` (token, expert) pairs, in token order (a stable sort ranks them);
an overflow pair is dropped and its token gets nothing from that expert
(only the shared experts, where the config has them).  JAX drops an
out-of-range scatter and clamps an out-of-range gather; torch raises on
both, so a dropped pair is scattered into one spare row past the
``[E, C, D]`` buffer and gathered from row 0 with a zero gate.

The grouped SwiGLU runs every expert over its ``C`` rows, filled or not:
the reference's arithmetic, whatever the routing.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import mlp_apply, mlp_init, torch_dtype, truncated_normal

F32 = torch.float32


def moe_init(cfg: ModelConfig, generator: torch.Generator) -> dict:
    m = cfg.moe
    dtype = torch_dtype(cfg.dtype)
    d, e, f = cfg.d_model, m.n_experts, m.d_ff_expert
    p = {
        "router": truncated_normal((d, e), d**-0.5, F32, generator),
        "w1": truncated_normal((e, d, f), d**-0.5, dtype, generator),
        "w3": truncated_normal((e, d, f), d**-0.5, dtype, generator),
        "w2": truncated_normal((e, f, d), f**-0.5, dtype, generator),
    }
    if m.n_shared_experts:
        p["shared"] = mlp_init(cfg, d, m.n_shared_experts * f, generator)
    return p


def capacity(cfg: ModelConfig, n_tokens: int) -> int:
    """Rows each expert takes: ``max(1, ceil(top_k * T * cf / E))``,
    computed as the reference computes it."""
    m = cfg.moe
    return max(1, int(-(-m.top_k * n_tokens * m.capacity_factor // m.n_experts)))


def _counts(idx: torch.Tensor, n: int) -> torch.Tensor:
    """How often each of ``0..n-1`` occurs in ``idx`` (int64 ``[n]``): a
    scatter-add of ones, as the reference's ``.at[idx].add(1)``, with a
    shape known before the data (the planner runs it on ``meta``)."""
    flat = idx.reshape(-1)
    return flat.new_zeros(n).scatter_add_(0, flat, torch.ones_like(flat))


def _route(cfg: ModelConfig, router_w: torch.Tensor, x_flat: torch.Tensor):
    """x_flat [T, D] -> gates [T, k] (x's dtype), eidx [T, k], aux (f32):
    softmax in float32, top-k, gates renormalised, Switch's load-balance
    loss ``E * sum_e f_e * P_e``."""
    m = cfg.moe
    probs = torch.softmax(x_flat.to(F32) @ router_w, dim=-1)  # [T, E]
    gates, eidx = torch.topk(probs, m.top_k, dim=-1)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    pe = probs.mean(0)
    counts = _counts(eidx, m.n_experts)
    fe = counts.to(F32) * (1.0 / (x_flat.shape[0] * m.top_k))
    aux = m.n_experts * torch.sum(fe * pe)
    return gates.to(x_flat.dtype), eidx, aux


def _dispatch_indices(eidx: torch.Tensor, n_experts: int, cap: int):
    """Flattened pairs -> (expert, slot, keep): slots unique per expert and
    ranked in pair order (a stable sort); ``keep = slot < cap``."""
    e_flat = eidx.reshape(-1)
    order = torch.argsort(e_flat, stable=True)
    counts = _counts(e_flat, n_experts)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(e_flat.numel(), device=e_flat.device) - starts[e_flat[order]]
    slot = torch.empty_like(rank)
    slot[order] = rank  # back to pair order
    return e_flat, slot, slot < cap


def _expert_ffn(w1, w3, w2, buf: torch.Tensor) -> torch.Tensor:
    """buf [E, C, D] -> [E, C, D]: a SwiGLU per expert (batched products)."""
    h = F.silu(torch.bmm(buf, w1)) * torch.bmm(buf, w3)
    return torch.bmm(h, w2)


def moe_apply(cfg: ModelConfig, p: dict, x: torch.Tensor):
    """x [B, S, D] -> (y [B, S, D], aux loss, a float32 scalar)."""
    m = cfg.moe
    b, s, d = x.shape
    x_flat = x.reshape(-1, d)
    t, k, e = x_flat.shape[0], m.top_k, m.n_experts
    cap = capacity(cfg, t)
    gates, eidx, aux = _route(cfg, p["router"], x_flat)
    e_flat, slot, keep = _dispatch_indices(eidx, e, cap)
    # row of each pair in the flat [E * C (+ 1 spare), D] buffer
    row = torch.where(keep, e_flat * cap + slot, e * cap)
    buf = x_flat.new_zeros((e * cap + 1, d))
    buf[row] = x_flat.repeat_interleave(k, dim=0)  # pair (t, j) is row t * k + j
    out = _expert_ffn(p["w1"], p["w3"], p["w2"], buf[: e * cap].view(e, cap, d))
    w = gates.reshape(-1, 1) * keep[:, None].to(gates.dtype)
    y_pairs = out.view(e * cap, d)[torch.where(keep, row, 0)] * w
    y = y_pairs.view(t, k, d).sum(1).reshape(b, s, d)
    if m.n_shared_experts:
        y = y + mlp_apply(cfg, p["shared"], x)
    return y, aux


__all__ = ["capacity", "moe_apply", "moe_init"]
