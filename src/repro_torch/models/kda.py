"""Kimi Delta Attention (KDA), the linear-attention mixer of Kimi Linear
(arXiv:2510.26692; flash-linear-attention's ``fla/layers/kda.py``).

Per layer and head ``h`` (``n_heads`` heads, ``d_k = d_v = head_dim``),
for token ``t`` with input ``x_t`` (the block's normed stream):

* projections and gates::

      q, k, v = SiLU(ShortConv(W_q x)), SiLU(ShortConv(W_k x)), SiLU(ShortConv(W_v x))
      q <- q / |q| * d_k ** -0.5,   k <- k / |k|            (per head)
      g_t = -exp(A_log[h]) * softplus(W_f_up W_f_down x_t + dt_bias)
      alpha_t = exp(g_t) in (0, 1) ** d_k,   beta_t = sigmoid(W_b x_t)[h]

  ``ShortConv`` is a depthwise causal convolution of ``conv_width`` taps
  with no bias; ``g`` is the per-channel log-decay, its projection of
  rank ``gate_rank``; ``|.|`` is ``sqrt(sum(.^2) + 1e-6)``;
* the recurrence (the gated delta rule with a per-channel decay)::

      S_t = (I - beta_t k_t k_t^T) Diag(alpha_t) S_{t-1} + beta_t k_t v_t^T
      o_t = S_t^T q_t

  with ``S`` of ``d_k x d_v`` a head, zero before the first token;
* the output: ``y = W_o [RMSNorm_{d_v}(o) * sigmoid(W_g_up W_g_down x + b_g)]``,
  the norm's scale shared by the heads, the gate of rank ``gate_rank``.

The parameters (``kda_init``): ``wqkv`` (q, k, v's projections side by
side, ``[d, 3 H d_k]``), ``conv`` (their taps, ``[conv_width, 3 H d_k]``),
``f_a``/``f_b`` (the decay's low rank), ``a_log`` ``[1, H]``, ``dt_bias``
``[1, H d_k]``, ``b`` (beta), ``g_a``/``g_b`` (the gate, ``g_b`` with the
bias ``b_g``), ``o_norm`` and ``wo``.

Two forms.  Train and prefill run the chunkwise-parallel (WY/UT) form,
:func:`chunk_kda`: within a chunk of ``chunk`` tokens a unit
lower-triangular solve gives the delta rule's corrections, across chunks
the state is carried.  Decode runs one recurrent step a token through the
fused ``kda_step`` kernel (``kernels/kda_step.py``: the state read and
written once).  The decode cache of a layer is ``{"state": [B, H, d_k,
d_v] float32, "conv": [B, conv_width - 1, 3 H d_k]}``, the state and the
last inputs of the three convolutions, written in place at decode.

Prefill runs the batch in slices of rows (:data:`SLICE_BYTES` of float32
``q`` a slice), so a layer's working memory does not grow with the batch.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.kda_step import kda_step
from repro_torch.kernels.rmsnorm import RMSNorm
from repro_torch.models.layers import (
    dense_apply,
    dense_init,
    span,
    torch_dtype,
    truncated_normal,
)

F32 = torch.float32
L2_EPS = 1e-6
SLICE_BYTES = 512 << 20  # float32 q of one slice of the prefill's rows


def kda_init(cfg: ModelConfig, generator: torch.Generator) -> dict:
    k = cfg.kda
    dtype = torch_dtype(cfg.dtype)
    d, h, dk, r = cfg.d_model, k.n_heads, k.head_dim, k.gate_rank
    hk = h * dk
    dev = generator.device
    # A_log = log(U(1, 16)) and dt_bias = softplus^-1(dt), dt log-uniform in
    # [1e-3, 0.1]: flash-linear-attention's init of the two
    u = torch.empty((1, h), dtype=F32, device=dev)
    u.uniform_(1.0, 16.0, generator=generator)
    dt = torch.empty((1, hk), dtype=F32, device=dev)
    dt = dt.uniform_(math.log(1e-3), math.log(0.1), generator=generator).exp()
    width = k.conv_width
    return {
        "wqkv": dense_init(d, 3 * hk, dtype, generator),
        "conv": {"w": truncated_normal((width, 3 * hk), width**-0.5, dtype, generator)},
        "f_a": dense_init(d, r, dtype, generator),
        "f_b": dense_init(r, hk, dtype, generator),
        "a_log": u.log(),
        "dt_bias": dt + torch.log(-torch.expm1(-dt)),
        "b": dense_init(d, h, dtype, generator),
        "g_a": dense_init(d, r, dtype, generator),
        "g_b": dense_init(r, hk, dtype, generator, bias=True),
        "o_norm": {"scale": torch.ones((dk,), dtype=F32, device=dev)},
        "wo": dense_init(hk, d, dtype, generator),
    }


def kda_state_init(
    cfg: ModelConfig, batch: int, dtype: torch.dtype, device
) -> dict[str, torch.Tensor]:
    k = cfg.kda
    hk = k.n_heads * k.head_dim
    return {
        "state": torch.zeros(
            (batch, k.n_heads, k.head_dim, k.head_dim), dtype=F32, device=device
        ),
        "conv": torch.zeros(
            (batch, k.conv_width - 1, 3 * hk), dtype=dtype, device=device
        ),
    }


# ---------------------------------------------------------------------------
# the gates
# ---------------------------------------------------------------------------
def _short_conv(p: dict, proj: torch.Tensor, tail: torch.Tensor | None):
    """``proj`` [B, S, C] (the projections), ``tail`` [B, W - 1, C] (the
    inputs before them; zeros at a sequence's start) -> (SiLU of the
    causal depthwise convolution [B, S, C] in float32, the new tail)."""
    w = p["conv"]["w"]
    width = w.shape[0]
    b, s, c = proj.shape
    if tail is None:
        tail = proj.new_zeros((b, width - 1, c))
    full = torch.cat([tail.to(proj.dtype), proj], 1)
    wf = w.float()
    if s == 1:  # decode: the window is the whole of ``full``
        y = (full.float() * wf).sum(1, keepdim=True)
    else:  # float32 sums of the taps, each read once in its own dtype
        y = full[:, :s] * wf[0]
        for j in range(1, width):
            y = y.addcmul(full[:, j : j + s], wf[j])
    return F.silu(y, inplace=not y.requires_grad), full[:, s:]


def _l2(x: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt((x * x).sum(-1, keepdim=True) + L2_EPS)


def _decay(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    """g [B, S, H, d_k] float32, the per-channel log-decay (<= 0)."""
    k = cfg.kda
    b, s, _ = x.shape
    z = dense_apply(p["f_b"], dense_apply(p["f_a"], x)).float() + p["dt_bias"].float()
    a = torch.exp(p["a_log"].float()).reshape(k.n_heads, 1)
    return -(a * F.softplus(z).reshape(b, s, k.n_heads, k.head_dim))


def _beta(p: dict, x: torch.Tensor) -> torch.Tensor:
    return torch.sigmoid(dense_apply(p["b"], x).float())  # [B, S, H]


def _out(cfg: ModelConfig, p: dict, x: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
    """o [B, S, H, d_v] (x's dtype) -> y [B, S, d]: the gated norm and out."""
    b, s, _ = x.shape
    on = RMSNorm.apply(o.contiguous(), p["o_norm"]["scale"], cfg.norm_eps)
    gate = torch.sigmoid(dense_apply(p["g_b"], dense_apply(p["g_a"], x)).float())
    y = (on.reshape(b, s, -1).float() * gate).to(x.dtype)
    return dense_apply(p["wo"], y)


# ---------------------------------------------------------------------------
# the chunkwise-parallel form
# ---------------------------------------------------------------------------
def _intra(q, k, gc):
    """The chunk's pairwise products with the decay between the two
    tokens: ``Aqk[t, i] = sum_c q_tc k_ic exp(gc_tc - gc_ic)`` for ``i <=
    t`` and ``Akk`` the same of ``k`` with itself for ``i < t`` (zero
    elsewhere), over ``[..., C, d_k]`` chunks (``C`` a power of two).

    Halving: at each level the chunk splits into blocks of ``2 h`` tokens,
    each a left and a right half; the pairs with ``t`` in the right half
    and ``i`` in the left one factor through ``gc_m``, the cumulative
    decay at the left half's last token, as ``(q_t exp(gc_t - gc_m)) .
    (k_i exp(gc_m - gc_i))``: both exponents are ``-|gc - gc_m|``, never
    positive, and one product a block gives them all.  Every pair below
    the diagonal falls in exactly one level; the diagonal itself is
    ``q_t . k_t``."""
    *lead, c, dk = q.shape
    aqk = torch.diag_embed((q * k).sum(-1))
    akk = q.new_zeros((*lead, c, c))
    h = 1
    while h < c:
        nb = c // (2 * h)
        shape = (*lead, nb, 2, h, dk)
        gb = gc.reshape(shape)
        e = torch.exp(-(gb - gb[..., :1, -1:, :]).abs())
        qr = q.reshape(shape)[..., 1, :, :] * e[..., 1, :, :]
        ke = k.reshape(shape) * e
        kl = ke[..., 0, :, :].transpose(-1, -2)
        blocks = torch.arange(nb, device=q.device)
        for a, rows in ((aqk, qr), (akk, ke[..., 1, :, :])):
            a.view(*lead, nb, 2, h, nb, 2, h)[..., blocks, 1, :, blocks, 0, :] = (
                rows @ kl
            ).movedim(-3, 0)
        h *= 2
    return aqk, akk


def _chunk_rows(q, k, v, g, beta, state):
    """:func:`chunk_kda` on ``[b, H, N, C, d]`` chunks (contiguous),
    ``beta [b, H, N, C]``, ``state [b, H, d_k, d_v]``."""
    b, h, n, c, dk = q.shape
    dv = v.shape[-1]
    gc = g.cumsum(-2)
    aqk, akk = _intra(q, k, gc)
    eg = torch.exp(gc)
    bcol = beta[..., None]
    # (I + diag(beta) strictly-lower(Akk)) [U | W] = beta [v | k e^gc]: the
    # unit lower-triangular inverse T once, then one product
    eye = torch.eye(c, dtype=q.dtype, device=q.device).expand_as(akk)
    t = torch.linalg.solve_triangular(akk * bcol, eye, upper=False, unitriangular=True)
    u, wk = (t @ (torch.cat([v, k * eg], -1) * bcol)).split([dv, dk], -1)
    qg = q * eg
    glast = gc[..., -1:, :]
    kend = (k * torch.exp(glast - gc)).transpose(-1, -2)  # [b, H, N, d_k, C]
    decay = torch.exp(glast).transpose(-1, -2)  # [b, H, N, d_k, 1]
    s = state.reshape(b * h, dk, dv)
    flat = [t.reshape(b * h, n, *t.shape[-2:]) for t in (u, wk, qg, aqk, kend, decay)]
    u, wk, qg, aqk, kend, decay = flat
    outs = []
    for i in range(n):
        w = torch.baddbmm(u[:, i], wk[:, i], s, alpha=-1.0)
        outs.append(torch.baddbmm(aqk[:, i] @ w, qg[:, i], s))
        s = torch.baddbmm(decay[:, i] * s, kend[:, i], w)
    o = torch.stack(outs, 1).reshape(b, h, n, c, dv)
    return o, s.reshape(b, h, dk, dv)


def chunk_kda(q, k, v, g, beta, *, chunk: int = 64, state=None):
    """The recurrence over whole sequences, chunk by chunk: q, k [B, S, H,
    d_k] (normalised, q scaled), v [B, S, H, d_v], g [B, S, H, d_k] (the
    log-decay), beta [B, S, H], all float32; ``state`` [B, H, d_k, d_v]
    before the first token (None: zeros).  Returns (o [B, S, H, d_v], the
    state after the last token), both float32.

    A length that is no multiple of ``chunk`` (a power of two) is padded
    at the end with ``beta = 0, g = 0`` (and zero q, k, v), which leave
    the state as it is.  Decays are only ever taken as ``exp(gc_i -
    gc_j)`` with ``i`` after ``j``, ``gc`` the cumulative log-decay inside
    the chunk, so no exponent is positive: ``-gc`` alone reaches hundreds
    over a chunk."""
    b, s, h, dk = q.shape
    dv = v.shape[-1]
    pad = (-s) % chunk
    n = (s + pad) // chunk

    def chunks(t):  # [B, S, H, ...] -> [B, H, N, C, ...], contiguous
        if pad:
            t = F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
        t = t.reshape(b, n, chunk, h, *t.shape[3:])
        return t.movedim(3, 1).contiguous()

    if state is None:
        state = q.new_zeros((b, h, dk, dv))
    o, state = _chunk_rows(*(chunks(t) for t in (q, k, v, g, beta)), state)
    o = o.movedim(1, 3).reshape(b, n * chunk, h, dv)
    return o[:, :s], state


# ---------------------------------------------------------------------------
# the mixer
# ---------------------------------------------------------------------------
def _qkv(cfg: ModelConfig, p: dict, x: torch.Tensor, tail):
    """(q, k, v side by side [B, S, 3, H, d] float32 after the
    convolutions and SiLU, q and k not yet normalised; the convolutions'
    new tail)."""
    k = cfg.kda
    b, s, _ = x.shape
    y, tail = _short_conv(p, dense_apply(p["wqkv"], x), tail)
    return y.reshape(b, s, 3, k.n_heads, k.head_dim), tail


def _prefill_rows(cfg: ModelConfig, p: dict, x: torch.Tensor):
    k = cfg.kda
    qkv, tail = _qkv(cfg, p, x, None)
    q, kk, v = qkv.unbind(2)
    q = _l2(q) * k.head_dim**-0.5
    o, state = chunk_kda(
        q, _l2(kk), v, _decay(cfg, p, x), _beta(p, x), chunk=k.chunk
    )
    return _out(cfg, p, x, o.to(x.dtype)), state, tail


def kda_apply(cfg: ModelConfig, p: dict, x: torch.Tensor, *, mode: str, state=None):
    """x [B, S, D] (train/prefill) or [B, 1, D] (decode) -> (y, cache).
    Prefill returns the cache to hand to decode (the state after the
    prompt and the convolutions' tail); decode updates ``state`` (the
    layer's cache) in place and returns it; train returns None."""
    if mode == "decode":
        with span("kda.step"):
            return _decode(cfg, p, x, state)
    if mode not in ("train", "prefill"):
        raise ValueError(f"unknown mode {mode!r}")
    with span("kda.prefill"):
        b, s, _ = x.shape
        hk = cfg.kda.n_heads * cfg.kda.head_dim
        rows = max(1, SLICE_BYTES // max(1, s * hk * 4))
        parts = [_prefill_rows(cfg, p, x[lo : lo + rows]) for lo in range(0, b, rows)]
        y = torch.cat([part[0] for part in parts])
        if mode == "train":
            return y, None
        return y, {
            "state": torch.cat([part[1] for part in parts]),
            "conv": torch.cat([part[2] for part in parts]),
        }


def _decode(cfg: ModelConfig, p: dict, x: torch.Tensor, cache: dict):
    k = cfg.kda
    b = x.shape[0]
    qkv, tail = _qkv(cfg, p, x, cache["conv"])
    cache["conv"].copy_(tail)
    g = _decay(cfg, p, x)[:, 0]
    beta = _beta(p, x)[:, 0]
    o = kda_step(cache["state"], qkv[:, 0].to(x.dtype), g, beta, k.head_dim**-0.5)
    return _out(cfg, p, x, o.reshape(b, 1, k.n_heads, k.head_dim)), cache


__all__ = ["chunk_kda", "kda_apply", "kda_init", "kda_state_init"]
