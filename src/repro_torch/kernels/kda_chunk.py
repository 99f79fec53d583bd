"""The chunked prefill of Kimi Delta Attention (``models/kda.py``): every
(sequence, head) of a layer over its whole prompt, chunk by chunk, in one
launch.

Per (sequence, head), with ``q, k, v`` the prompt's inputs after the short
convolutions (``qkv [B, S, 3, H, d]`` float32, q, k and v side by side),
``g`` the float32 log-decay ``[B, S, H, d]`` and ``beta`` the float32
``[B, S, H]``, from a zero state::

    q <- q / |q| * scale,  k <- k / |k|       (|x| = sqrt(sum x^2 + 1e-6))
    S_t = (I - beta_t k_t k_t^T) Diag(exp(g_t)) S_{t-1} + beta_t k_t v_t^T
    o_t = S_t^T q_t

computed chunkwise (:func:`chunk_kda`); returns ``o [B, S, H, d]`` in the
asked dtype and the state after the last token ``[B, H, d, d]`` float32.

Two routes.  :func:`kda_chunk_plain` (the L2 norms and :func:`chunk_kda`,
plain PyTorch) runs on a CPU (or ``meta``) tensor, and on a CUDA tensor
where autograd would record the call (``torch.is_grad_enabled()`` and an
input that requires a gradient: training, since the kernel has no
backward).  Any other CUDA call launches ``csrc/kda_chunk.cu`` through the
lean launch path (:mod:`repro_torch.kernels.lib`) or raises: the kernel
takes ``d`` a multiple of 8 up to 128, chunks of 64 tokens and ``o`` in
float32 or bfloat16.  :attr:`kda_chunk.calls_by_route` counts the calls
by route.  Bound: operations, ~8.9 MFLOP of products a 64-token chunk of
a head at d 128 against ~148 KB moved (the source's note).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import lib
from repro_torch.kernels.kda_step import L2_EPS

_pack = lib.KDA_CHUNK_ARGS.pack
_OUT = (torch.float32, torch.bfloat16)
CHUNK = 64  # the kernel's chunk length
MAX_D = 128  # a chunk's q, k, v, g and the products' buffers in shared memory


def _l2(x: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt((x * x).sum(-1, keepdim=True) + L2_EPS)


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


def kda_chunk_plain(qkv, g, beta, scale: float, chunk: int, dtype: torch.dtype):
    """The plain PyTorch version: what the CPU and autograd run and what
    the kernel is checked against on the card."""
    q, k, v = qkv.unbind(2)
    o, state = chunk_kda(_l2(q) * scale, _l2(k), v, g, beta, chunk=chunk)
    return o.to(dtype), state


def _check(qkv, g, beta, dtype) -> tuple[int, int, int, int]:
    """Raise on operands no route takes; return (B, S, H, d)."""
    if qkv.dim() != 5 or qkv.shape[2] != 3:
        raise ValueError(f"kda_chunk wants qkv [B, S, 3, H, d]; got {tuple(qkv.shape)}")
    b, s, _, h, d = qkv.shape
    if tuple(g.shape) != (b, s, h, d) or tuple(beta.shape) != (b, s, h):
        raise ValueError(
            f"kda_chunk wants g [B, S, H, d] and beta [B, S, H] for qkv "
            f"{tuple(qkv.shape)}; got {tuple(g.shape)}, {tuple(beta.shape)}"
        )
    if any(t.dtype is not torch.float32 for t in (qkv, g, beta)) or dtype not in _OUT:
        raise TypeError(
            "kda_chunk wants float32 qkv, g and beta and o in float32 or bfloat16; "
            f"got {qkv.dtype}, {g.dtype}, {beta.dtype} and {dtype}"
        )
    return b, s, h, d


def launch_args(
    qkv_ptr, g_ptr, beta_ptr, o_ptr, state_ptr, stream, index, b, s, h, d, scale
) -> bytes:
    """The packed ``KdaChunkArgs`` of ``csrc/kda_chunk.cu`` for one launch on
    the raw ``stream`` of device ``index`` (field order as in the C struct;
    the format is :data:`lib.KDA_CHUNK_ARGS`)."""
    return _pack(
        qkv_ptr, g_ptr, beta_ptr, o_ptr, state_ptr, stream, index, b, s, h, d, scale,
        L2_EPS,
    )  # fmt: skip


def kda_chunk(qkv, g, beta, scale: float, chunk: int, dtype: torch.dtype):
    """``(o [B, S, H, d] in dtype, state [B, H, d, d] float32)``: the
    prompt's recurrence from a zero state (the module docstring)."""
    b, s, h, d = _check(qkv, g, beta, dtype)
    index = lib.device_index("kda_chunk", qkv, g, beta)
    recorded = torch.is_grad_enabled() and (
        qkv.requires_grad or g.requires_grad or beta.requires_grad
    )
    if index < 0 or recorded:
        kda_chunk.calls_by_route["plain"] += 1
        return kda_chunk_plain(qkv, g, beta, scale, chunk, dtype)
    if chunk != CHUNK or d % 8 or d > MAX_D:
        raise ValueError(
            f"kda_chunk: the kernel takes chunks of {CHUNK} and d a multiple of 8 up "
            f"to {MAX_D}; got chunk {chunk}, d {d}"
        )
    operands = (qkv, g, beta)
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in operands):
        raise ValueError("kda_chunk operands must be contiguous and 16-byte aligned")
    o = torch.empty((b, s, h, d), dtype=dtype, device=qkv.device)
    state = torch.empty((b, h, d, d), dtype=torch.float32, device=qkv.device)
    kda_chunk.calls_by_route["kernel"] += 1
    if b * h == 0:
        return o, state
    if lib.raw_stream is None:
        lib.load()
    args = launch_args(
        qkv.data_ptr(), g.data_ptr(), beta.data_ptr(), o.data_ptr(), state.data_ptr(),
        lib.raw_stream(index), index, b, s, h, d, scale,
    )  # fmt: skip
    rc = (lib.kda_chunk_f32 if dtype is torch.float32 else lib.kda_chunk_bf16)(args)
    if rc:
        lib.check(rc, "kda_chunk")
    kda_chunk.launches += 1
    return o, state


kda_chunk.launches = 0
kda_chunk.calls_by_route = {"kernel": 0, "plain": 0}

__all__ = ["CHUNK", "MAX_D", "chunk_kda", "kda_chunk", "kda_chunk_plain", "launch_args"]
