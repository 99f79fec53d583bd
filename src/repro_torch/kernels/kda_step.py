"""The fused decode step of Kimi Delta Attention (``models/kda.py``): one
recurrent step of every (sequence, head) of a layer, the state read and
written once.

Per (sequence, head), with ``q, k, v`` the step's inputs after the short
convolutions (``qkv [B, 3, H, d]``, q, k and v side by side), ``g`` the
float32 log-decay ``[B, H, d]`` and ``beta`` the float32 ``[B, H]``::

    q <- q / |q| * scale,  k <- k / |k|       (|x| = sqrt(sum x^2 + 1e-6))
    S' = Diag(exp(g)) S
    u  = v - S'^T k
    S  <- S' + beta k u^T                      (in place)
    o  = S^T q = S'^T q + beta (q . k) u

``state`` is ``[B, H, d, d]`` float32, updated in place; ``o`` ``[B, H, d]``
comes back in ``qkv``'s dtype.  All in float32.

On a CPU (or ``meta``) tensor :func:`kda_step` computes
:func:`kda_step_plain`; on a CUDA tensor it launches
``csrc/kda_step.cu`` through the lean launch path
(:mod:`repro_torch.kernels.lib`) or raises.  The kernel takes ``d`` a
multiple of 8 up to 128 and ``q``, ``k``, ``v`` in bfloat16 or float32.
Bound: bytes.  A (sequence, head) reads and writes its float32 state
once (131,072 B at d 128) against ~6 d^2 flops; at batch 128 and 32 heads
a launch moves 537 MB, ~0.16 ms at 3.35 TB/s.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import lib

_pack = lib.KDA_STEP_ARGS.pack
_DTYPES = (torch.float32, torch.bfloat16)
L2_EPS = 1e-6
MAX_D = 128  # a thread holds d / 8 rows of the state, four columns each


def kda_step_plain(state, qkv, g, beta, scale: float) -> torch.Tensor:
    """The plain PyTorch version: what the CPU runs and what the kernel is
    checked against on the card.  Updates ``state`` in place."""
    q, k, v = qkv.float().unbind(1)
    q = q * torch.rsqrt((q * q).sum(-1, keepdim=True) + L2_EPS) * scale
    k = k * torch.rsqrt((k * k).sum(-1, keepdim=True) + L2_EPS)
    s = state * torch.exp(g.float())[..., None]
    u = v - torch.einsum("bhkv,bhk->bhv", s, k)
    s = s + beta.float()[..., None, None] * k[..., None] * u[..., None, :]
    o = torch.einsum("bhkv,bhk->bhv", s, q)
    state.copy_(s)
    return o.to(qkv.dtype)


def _check(state, qkv, g, beta) -> tuple[int, int, int]:
    """Raise on operands the step does not take; return (B, H, d)."""
    if qkv.dim() != 4 or qkv.shape[1] != 3:
        raise ValueError(f"kda_step wants qkv [B, 3, H, d]; got {tuple(qkv.shape)}")
    b, _, h, d = qkv.shape
    if (
        tuple(state.shape) != (b, h, d, d)
        or tuple(g.shape) != (b, h, d)
        or tuple(beta.shape) != (b, h)
    ):
        raise ValueError(
            f"kda_step wants state [B, H, d, d], g [B, H, d], beta [B, H] for qkv "
            f"{tuple(qkv.shape)}; got {tuple(state.shape)}, {tuple(g.shape)}, "
            f"{tuple(beta.shape)}"
        )
    rest = (state, g, beta)
    if qkv.dtype not in _DTYPES or any(t.dtype is not torch.float32 for t in rest):
        raise TypeError(
            "kda_step wants float32 or bfloat16 qkv and float32 state, g and beta; "
            f"got {qkv.dtype}, {state.dtype}, {g.dtype}, {beta.dtype}"
        )
    return b, h, d


def launch_args(
    state_ptr, qkv_ptr, g_ptr, beta_ptr, o_ptr, stream, index, bh, h, d, scale
) -> bytes:
    """The packed ``KdaStepArgs`` of ``csrc/kda_step.cu`` for one launch on
    the raw ``stream`` of device ``index`` (field order as in the C
    struct; the format is :data:`lib.KDA_STEP_ARGS`)."""
    return _pack(
        state_ptr, qkv_ptr, g_ptr, beta_ptr, o_ptr, stream, index, bh, h, d, scale,
        L2_EPS,
    )  # fmt: skip


def kda_step(state, qkv, g, beta, scale: float) -> torch.Tensor:
    """One step of every (sequence, head): ``state`` updated in place,
    ``o [B, H, d]`` returned (the module docstring)."""
    b, h, d = _check(state, qkv, g, beta)
    index = lib.device_index("kda_step", state, qkv, g, beta)
    if index < 0:
        return kda_step_plain(state, qkv, g, beta, scale)
    if d % 8 or d > MAX_D:
        raise ValueError(
            f"kda_step: the kernel takes d a multiple of 8 up to {MAX_D}; got {d}"
        )
    if not all(t.is_contiguous() for t in (state, qkv, g, beta)):
        raise ValueError("kda_step operands must be contiguous")
    out = torch.empty((b, h, d), dtype=qkv.dtype, device=qkv.device)
    if b * h == 0:
        return out
    if lib.raw_stream is None:
        lib.load()
    args = launch_args(
        state.data_ptr(), qkv.data_ptr(), g.data_ptr(), beta.data_ptr(), out.data_ptr(),
        lib.raw_stream(index), index, b * h, h, d, scale,
    )  # fmt: skip
    f32 = qkv.dtype is torch.float32
    rc = (lib.kda_step_f32 if f32 else lib.kda_step_bf16)(args)
    if rc:
        lib.check(rc, "kda_step")
    kda_step.launches += 1
    return out


kda_step.launches = 0

__all__ = ["MAX_D", "kda_step", "kda_step_plain", "launch_args"]
