"""Recurrent mixers: Mamba-1's selective SSM, and xLSTM's mLSTM and sLSTM.

The port of the reference's ``models/ssm.py``, in plain PyTorch: the
reference's scans are ``lax.scan`` and ``lax.associative_scan``, no
Pallas kernel, so there is no hand-written kernel here either.

* Mamba's selective scan runs over sequence chunks (``_best_chunk``, the
  reference's: the largest divisor of S up to ``cfg.ssm.chunk``), the
  float32 state ``h [B, d_inner, d_state]`` carried across chunks in a
  Python loop.  The discretised ``[B, chunk, d_inner, d_state]`` tensors
  are formed inside a chunk's body and never at full sequence length;
  inside a chunk a log-depth (Hillis-Steele) scan combines
  ``(al * ar, bl * ar + br)``, the reference's operator.
* mLSTM carries its matrix memory across the same chunks and steps
  through each chunk token by token, as the reference's scan does.
* sLSTM is strictly sequential (recurrent gate weights, block-diagonal
  per head), a step a token, and ends with its post gated FFN.

In train mode under autograd each chunk body of Mamba and mLSTM is
checkpointed (the reference's ``jax.checkpoint``), so the backward holds
one chunk's intermediates at a time; prefill and decode take none.
Decode is one step of each recurrence against the state a prefill hands
over.

Every recurrence is per channel or per head, so on a mesh
(``models/blocks.py``'s regions, the reference's ``_make_wsc_ch``) a rank
runs these functions on its block of the weights: its channels of
``d_inner`` (the widths are read off the weights) and its heads, with
:class:`Split` saying where the other ranks' channels come in.  No
collective is needed inside a scan.  Left out: the reference's
``REPRO_NO_SCAN_WSC`` switch.
"""

from __future__ import annotations

from collections.abc import Callable
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import (
    dense_apply,
    dense_init,
    torch_dtype,
    truncated_normal,
)

F32 = torch.float32
M_INIT = -1e30  # mLSTM's empty stabiliser (finite: -inf - -inf would be NaN)


def _same(x: torch.Tensor) -> torch.Tensor:
    return x


def _whole(x: torch.Tensor) -> torch.Tensor:
    # contiguous and a node of its own, as the mesh's all-gather gives it:
    # the products that read it and the order in which their gradients
    # add up are then the same on one device and on a mesh
    return x.contiguous().view_as(x)


@dataclass(frozen=True)
class Split:
    """How a mixer that runs on a rank's part of its channels meets the
    others' (the defaults: the whole mixer on one device).  ``reduce``: a
    row-parallel product's partial sums summed (Mamba's ``x_proj``,
    mLSTM's gates); ``whole``: the rank's channels of ``d_inner`` whole
    (mLSTM's q, k and v read every channel); ``own``: the rank's
    channels of a whole ``d_inner`` (mLSTM's cell run whole); ``head0``:
    the first of the rank's heads (in mLSTM's gates, which cover all
    heads)."""

    reduce: Callable = _same
    whole: Callable = _whole
    own: Callable = _same
    head0: int = 0


WHOLE = Split()


def _remat(mode: str) -> bool:
    return mode == "train" and torch.is_grad_enabled()


def _run(fn, remat: bool, *args):
    if remat:
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


# ---------------------------------------------------------------------------
# causal depthwise conv1d (Mamba and mLSTM)
# ---------------------------------------------------------------------------
def causal_conv1d(
    x: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor,
    conv_state: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """x [B,S,C], w [C,K], b [C], conv_state [B,K-1,C] (zeros if None).
    Returns (y [B,S,C], new_state [B,K-1,C]): the last K-1 rows of the
    padded input."""
    k, s = w.shape[1], x.shape[1]
    if conv_state is None:
        pad = x.new_zeros((x.shape[0], k - 1, x.shape[2]))
    else:
        pad = conv_state.to(x.dtype)
    xp = torch.cat([pad, x], 1)  # [B, S+K-1, C]
    y = sum(xp[:, i : i + s] * w[:, i] for i in range(k))
    y = y + b
    new_state = xp[:, s:] if k > 1 else pad
    return y, new_state


def _best_chunk(s_len: int, chunk: int) -> int:
    """Largest divisor of s_len that is <= chunk."""
    chunk = min(chunk, s_len)
    while s_len % chunk:
        chunk -= 1
    return max(chunk, 1)


# ---------------------------------------------------------------------------
# Mamba-1 selective SSM
# ---------------------------------------------------------------------------
def mamba_init(cfg: ModelConfig, generator: torch.Generator) -> dict:
    s = cfg.ssm
    dtype = torch_dtype(cfg.dtype)
    dev = generator.device
    d = cfg.d_model
    di = s.expand * d
    dtr = s.dt_rank or -(-d // 16)
    a = torch.arange(1, s.d_state + 1, dtype=F32, device=dev).expand(di, s.d_state)
    return {
        "in_proj": dense_init(d, 2 * di, dtype, generator),
        "conv_w": truncated_normal((di, s.d_conv), s.d_conv**-0.5, dtype, generator),
        "conv_b": torch.zeros((di,), dtype=dtype, device=dev),
        "x_proj": dense_init(di, dtr + 2 * s.d_state, dtype, generator),
        "dt_proj": dense_init(dtr, di, dtype, generator, bias=True, scale=dtr**-0.5),
        "a_log": torch.log(a),  # float32 [di, N]
        "d_skip": torch.ones((di,), dtype=F32, device=dev),
        "out_proj": dense_init(di, d, dtype, generator),
    }


def mamba_state_init(
    cfg: ModelConfig, batch: int, dtype: torch.dtype, device
) -> dict[str, torch.Tensor]:
    s = cfg.ssm
    di = s.expand * cfg.d_model
    return {
        "conv": torch.zeros((batch, s.d_conv - 1, di), dtype=dtype, device=device),
        "ssm": torch.zeros((batch, di, s.d_state), dtype=F32, device=device),
    }


def _scan_chunk(h0, dt_k, b_k, c_k, x_k, a):
    """One chunk of the selective scan from state h0 [B,di,N]: returns
    (the chunk's last state, y [B,chunk,di])."""
    da = torch.exp(dt_k[..., None] * a)  # [B, chunk, di, N]
    dbx = (dt_k * x_k)[..., None] * b_k[:, :, None, :]
    # inclusive scan of (al * ar, bl * ar + br) along the chunk, log depth
    n, step = da.shape[1], 1
    while step < n:
        head, tail = slice(None, step), slice(step, None)
        dbx = torch.cat(
            [dbx[:, head], torch.addcmul(dbx[:, tail], dbx[:, :-step], da[:, tail])], 1
        )
        da = torch.cat([da[:, head], da[:, :-step] * da[:, tail]], 1)
        step *= 2
    h = da * h0[:, None] + dbx  # [B, chunk, di, N]
    y = torch.einsum("bsdn,bsn->bsd", h, c_k)
    return h[:, -1], y


def _selective_scan_chunked(dt, b_seq, c_seq, xf, a, chunk: int, remat: bool):
    """h_t = exp(dt_t A) h_{t-1} + (dt_t x_t) B_t;  y_t = h_t . C_t.

    dt/xf [B,S,di], b_seq/c_seq [B,S,N] (all float32), a [di,N].
    Returns (y [B,S,di], the last state [B,di,N])."""
    b, s_len, di = dt.shape
    chunk = _best_chunk(s_len, chunk)
    h = dt.new_zeros((b, di, a.shape[1]))
    ys = []
    for i in range(0, s_len, chunk):
        c = slice(i, i + chunk)
        seq = (dt[:, c], b_seq[:, c], c_seq[:, c], xf[:, c])
        h, y = _run(_scan_chunk, remat, h, *seq, a)
        ys.append(y)
    return torch.cat(ys, 1), h


def mamba_apply(
    cfg: ModelConfig,
    p: dict,
    u: torch.Tensor,
    *,
    mode: str,
    state: dict[str, torch.Tensor] | None = None,
    split: Split = WHOLE,
):
    """u [B,S,D] -> (y [B,S,D], new_state or None): the prefill's state to
    hand over, decode's next state, None in train mode.  ``d_inner`` is
    ``in_proj``'s half (on a mesh the rank's channels, ``x`` and ``z``
    side by side); ``split.reduce`` sums ``x_proj``'s partial products,
    and the output is then the rank's partial sum."""
    s_cfg = cfg.ssm
    d = u.shape[-1]
    di = p["in_proj"]["w"].shape[1] // 2
    dtr = s_cfg.dt_rank or -(-d // 16)
    n = s_cfg.d_state

    xz = dense_apply(p["in_proj"], u)
    x, z = xz[..., :di], xz[..., di:]
    conv_state = state["conv"] if state is not None else None
    x, new_conv = causal_conv1d(x, p["conv_w"], p["conv_b"], conv_state)
    x = F.silu(x)

    xdb = split.reduce(dense_apply(p["x_proj"], x))
    dt = F.softplus(dense_apply(p["dt_proj"], xdb[..., :dtr]).float())  # [B,S,di]
    b_ssm = xdb[..., dtr : dtr + n].float()
    c_ssm = xdb[..., dtr + n :].float()
    a = -torch.exp(p["a_log"])  # [di, N]
    xf = x.float()

    if mode in ("train", "prefill"):
        y, h_last = _selective_scan_chunked(
            dt, b_ssm, c_ssm, xf, a, s_cfg.chunk, _remat(mode)
        )
        new_state = {"conv": new_conv, "ssm": h_last} if mode == "prefill" else None
    elif mode == "decode":
        da1 = torch.exp(dt[:, 0, :, None] * a)  # [B, di, N]
        dbx1 = (dt[:, 0] * xf[:, 0])[..., None] * b_ssm[:, 0, None, :]
        h = da1 * state["ssm"] + dbx1
        y = torch.einsum("bdn,bn->bd", h, c_ssm[:, 0])[:, None]
        new_state = {"conv": new_conv, "ssm": h}
    else:
        raise ValueError(f"unknown mode {mode!r}")
    y = y + xf * p["d_skip"]
    y = y.to(u.dtype) * F.silu(z)
    return dense_apply(p["out_proj"], y), new_state


# ---------------------------------------------------------------------------
# mLSTM (xLSTM's matrix-memory block)
# ---------------------------------------------------------------------------
def mlstm_init(cfg: ModelConfig, generator: torch.Generator) -> dict:
    x_cfg = cfg.xlstm
    dtype = torch_dtype(cfg.dtype)
    d = cfg.d_model
    di = int(x_cfg.mlstm_proj_factor * d)
    h, cw = cfg.n_heads, x_cfg.conv_width
    return {
        "in_proj": dense_init(d, 2 * di, dtype, generator),
        "conv_w": truncated_normal((di, cw), cw**-0.5, dtype, generator),
        "conv_b": torch.zeros((di,), dtype=dtype, device=generator.device),
        "wq": dense_init(di, di, dtype, generator),
        "wk": dense_init(di, di, dtype, generator),
        "wv": dense_init(di, di, dtype, generator),
        "w_if": dense_init(di, 2 * h, dtype, generator),  # i and f pre-acts
        "out_proj": dense_init(di, d, dtype, generator),
    }


def mlstm_state_init(
    cfg: ModelConfig, batch: int, dtype: torch.dtype, device
) -> dict[str, torch.Tensor]:
    x_cfg = cfg.xlstm
    di = int(x_cfg.mlstm_proj_factor * cfg.d_model)
    h = cfg.n_heads
    dh = di // h
    return {
        "conv": torch.zeros(
            (batch, x_cfg.conv_width - 1, di), dtype=dtype, device=device
        ),
        "c": torch.zeros((batch, h, dh, dh), dtype=F32, device=device),
        "n": torch.zeros((batch, h, dh), dtype=F32, device=device),
        "m": torch.full((batch, h), M_INIT, dtype=F32, device=device),
    }


def _mlstm_step(c, n, m, q, k, v, log_i, log_f):
    """One token: c [B,H,dk,dv], n [B,H,dk], m [B,H]; q/k/v [B,H,dh],
    log_i/log_f [B,H].  Returns (c, n, m, h_out [B,H,dh])."""
    m_new = torch.maximum(log_f + m, log_i)
    i_p = torch.exp(log_i - m_new)
    f_p = torch.exp(log_f + m - m_new)
    c = f_p[..., None, None] * c + i_p[..., None, None] * (
        k[..., :, None] * v[..., None, :]
    )
    n = f_p[..., None] * n + i_p[..., None] * k
    num = torch.einsum("bhkv,bhk->bhv", c, q)
    den = torch.clamp(torch.abs(torch.einsum("bhk,bhk->bh", n, q)), min=1.0)
    return c, n, m_new, num / den[..., None]


def _mlstm_chunk(c, n, m, q, k, v, log_i, log_f):
    """``_mlstm_step`` over a chunk's tokens (axis 1): (c, n, m, ys
    [B,chunk,H,dh])."""
    ys = []
    for t in range(q.shape[1]):
        c, n, m, y = _mlstm_step(
            c, n, m, q[:, t], k[:, t], v[:, t], log_i[:, t], log_f[:, t]
        )
        ys.append(y)
    return c, n, m, torch.stack(ys, 1)


def mlstm_apply(
    cfg: ModelConfig,
    p: dict,
    u: torch.Tensor,
    *,
    mode: str,
    state: dict[str, torch.Tensor] | None = None,
    split: Split = WHOLE,
):
    """u [B,S,D] -> (y [B,S,D], new_state or None), as :func:`mamba_apply`.
    v comes from the un-convolved input, q, k and the gates from the
    convolved one (the reference's wiring).  On a mesh the channels are
    ``in_proj``'s half and the heads ``wq``'s columns over the head
    width: ``split.whole`` gives q, k and v every channel,
    ``split.reduce`` sums the gates' partial products (all heads; the
    rank's from ``split.head0``) and ``split.own`` cuts the cell's output
    to the rank's channels."""
    x_cfg = cfg.xlstm
    b, s_len, d = u.shape
    n_heads = cfg.n_heads
    dh = int(x_cfg.mlstm_proj_factor * d) // n_heads
    h0, h = split.head0, p["wq"]["w"].shape[1] // dh

    xz = dense_apply(p["in_proj"], u)
    di = xz.shape[-1] // 2
    x, z = xz[..., :di], xz[..., di:]
    conv_state = state["conv"] if state is not None else None
    xc, new_conv = causal_conv1d(x, p["conv_w"], p["conv_b"], conv_state)
    xc = F.silu(xc)

    xcw = split.whole(xc)
    q = dense_apply(p["wq"], xcw).reshape(b, s_len, h, dh).float()
    k = dense_apply(p["wk"], xcw).reshape(b, s_len, h, dh).float() * dh**-0.5
    v = dense_apply(p["wv"], split.whole(x)).reshape(b, s_len, h, dh).float()
    if_pre = split.reduce(dense_apply(p["w_if"], xc)).float()  # [B,S,2H]
    log_i = if_pre[..., h0 : h0 + h]
    log_f = F.logsigmoid(if_pre[..., n_heads + h0 : n_heads + h0 + h])

    if mode in ("train", "prefill"):
        chunk = _best_chunk(s_len, x_cfg.chunk)
        carry = (
            u.new_zeros((b, h, dh, dh), dtype=F32),
            u.new_zeros((b, h, dh), dtype=F32),
            u.new_full((b, h), M_INIT, dtype=F32),
        )
        remat, ys = _remat(mode), []
        for i in range(0, s_len, chunk):
            sl = slice(i, i + chunk)
            seq = (q[:, sl], k[:, sl], v[:, sl], log_i[:, sl], log_f[:, sl])
            *carry, y = _run(_mlstm_chunk, remat, *carry, *seq)
            ys.append(y)
        y = torch.cat(ys, 1)
        new_state = None
        if mode == "prefill":
            c, n, m = carry
            new_state = {"conv": new_conv, "c": c, "n": n, "m": m}
    elif mode == "decode":
        c, n, m, y = _mlstm_step(
            state["c"], state["n"], state["m"],
            q[:, 0], k[:, 0], v[:, 0], log_i[:, 0], log_f[:, 0],
        )  # fmt: skip
        y = y[:, None]
        new_state = {"conv": new_conv, "c": c, "n": n, "m": m}
    else:
        raise ValueError(f"unknown mode {mode!r}")
    y = split.own(y.reshape(b, s_len, h * dh).to(u.dtype)) * F.silu(z)
    return dense_apply(p["out_proj"], y), new_state


# ---------------------------------------------------------------------------
# sLSTM (xLSTM's scalar-memory block: recurrent gates, so sequential)
# ---------------------------------------------------------------------------
def slstm_init(cfg: ModelConfig, generator: torch.Generator) -> dict:
    dtype = torch_dtype(cfg.dtype)
    d = cfg.d_model
    h = cfg.n_heads
    dh = d // h
    dff = int(cfg.xlstm.slstm_ffn_factor * d)
    return {
        # input weights of (z, i, f, o) stacked: [D, 4D]
        "w_x": dense_init(d, 4 * d, dtype, generator, bias=True),
        # block-diagonal recurrent weights per head: [4, H, dh, dh]
        "r_h": truncated_normal((4, h, dh, dh), dh**-0.5, dtype, generator),
        "ffn_up": dense_init(d, 2 * dff, dtype, generator),
        "ffn_down": dense_init(dff, d, dtype, generator),
    }


def slstm_state_init(
    cfg: ModelConfig, batch: int, dtype: torch.dtype, device
) -> dict[str, torch.Tensor]:
    h = cfg.n_heads
    shape = (batch, h, cfg.d_model // h)
    return {
        "h": torch.zeros(shape, dtype=F32, device=device),
        "c": torch.zeros(shape, dtype=F32, device=device),
        "n": torch.ones(shape, dtype=F32, device=device),
        "m": torch.zeros(shape, dtype=F32, device=device),
    }


def _slstm_step(rh, hprev, c, n, m, x_pre):
    """rh [4,H,dh,dh] float32; x_pre [B,4,H,dh] the input pre-activations;
    the carry (h, c, n, m), each [B,H,dh].  Returns the next carry."""
    rec = torch.einsum("bhd,ghde->bghe", hprev, rh)  # [B,4,H,dh]
    pre = x_pre + rec
    z = torch.tanh(pre[:, 0])
    log_i = pre[:, 1]
    log_f = F.logsigmoid(pre[:, 2])
    o = torch.sigmoid(pre[:, 3])
    m_new = torch.maximum(log_f + m, log_i)
    i_p = torch.exp(log_i - m_new)
    f_p = torch.exp(log_f + m - m_new)
    c_new = f_p * c + i_p * z
    n_new = f_p * n + i_p
    h_new = o * c_new / torch.clamp(n_new, min=1e-6)
    return h_new, c_new, n_new, m_new


def slstm_cell(
    cfg: ModelConfig,
    p: dict,
    u: torch.Tensor,
    *,
    mode: str,
    state: dict[str, torch.Tensor] | None = None,
):
    """The recurrence a token at a time: u [B,S,D] -> (y [B,S,H*dh],
    new_state or None) over the heads of ``r_h`` (on a mesh the rank's,
    ``w_x`` then holding its heads' columns of all four gates)."""
    b, s_len, _ = u.shape
    h = p["r_h"].shape[1]
    dh = cfg.d_model // cfg.n_heads
    x_pre = dense_apply(p["w_x"], u).float().reshape(b, s_len, 4, h, dh)
    rh = p["r_h"].float()
    if state is None:
        shape = (b, h, dh)
        zero = u.new_zeros(shape, dtype=F32)
        carry = (zero, zero, u.new_ones(shape, dtype=F32), zero)
    else:
        carry = tuple(state[key] for key in "hcnm")

    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"unknown mode {mode!r}")
    ys = []
    for t in range(s_len):
        carry = _slstm_step(rh, *carry, x_pre[:, t])
        ys.append(carry[0])
    y = torch.stack(ys, 1).reshape(b, s_len, h * dh)
    new_state = None if mode == "train" else dict(zip("hcnm", carry, strict=True))
    return y.to(u.dtype), new_state


def slstm_ffn(p: dict, y: torch.Tensor) -> torch.Tensor:
    """The post gated FFN (the xLSTM block's structure): ``ffn_up``'s two
    halves side by side (on a mesh the rank's columns of each)."""
    up = dense_apply(p["ffn_up"], y)
    dff = up.shape[-1] // 2
    return dense_apply(p["ffn_down"], F.silu(up[..., :dff]) * up[..., dff:])


def slstm_apply(
    cfg: ModelConfig,
    p: dict,
    u: torch.Tensor,
    *,
    mode: str,
    state: dict[str, torch.Tensor] | None = None,
):
    """u [B,S,D] -> (y [B,S,D], new_state or None), as :func:`mamba_apply`:
    the recurrence a token at a time, then the post gated FFN."""
    y, new_state = slstm_cell(cfg, p, u, mode=mode, state=state)
    return slstm_ffn(p, y), new_state


__all__ = [
    "WHOLE",
    "Split",
    "causal_conv1d",
    "mamba_apply",
    "mamba_init",
    "mamba_state_init",
    "mlstm_apply",
    "mlstm_init",
    "mlstm_state_init",
    "slstm_apply",
    "slstm_cell",
    "slstm_ffn",
    "slstm_init",
    "slstm_state_init",
]
