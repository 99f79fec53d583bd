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

Two forms.  Train and prefill run the chunkwise-parallel (WY/UT) form
(``kernels/kda_chunk.py``): within a chunk of ``chunk`` tokens a unit
lower-triangular solve gives the delta rule's corrections, across chunks
the state is carried; on a card, where no gradient is recorded, one
launch of the ``kda_chunk`` kernel a slice of rows (the L2 norms
included), else its plain version (``kda_chunk_plain``).  Decode runs one
recurrent step a token through the fused ``kda_step`` kernel
(``kernels/kda_step.py``: the state read and written once).  The decode
cache of a layer is ``{"state": [B, H, d_k, d_v] float32, "conv": [B,
conv_width - 1, 3 H d_k]}``, the state and the last inputs of the three
convolutions, written in place at decode.

Prefill runs the batch in slices of rows (:data:`SLICE_BYTES` of float32
``q`` a slice), so a layer's working memory does not grow with the batch.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.kda_chunk import kda_chunk
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
    g, beta = _decay(cfg, p, x), _beta(p, x)
    with span("kda.chunk"):
        o, state = kda_chunk(qkv, g, beta, k.head_dim**-0.5, k.chunk, x.dtype)
    return _out(cfg, p, x, o), state, tail


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


__all__ = ["kda_apply", "kda_init", "kda_state_init"]
