"""Fused attention forward (FlashAttention-2): causal, GQA, sliding window,
tanh logit softcap.

The model zoo's prefill runs it once per attention layer (24 times per
prefill of h2o-danube-3-4b).

Replaces the TPU kernel ``src/repro/kernels/flash_attention/kernel.py``
(``flash_attention_bhsd``; layout and padding in ``ops.py``, oracle
``ref.py::attention_ref``) with the hand-written CUDA kernels of
``repro_torch/csrc/flash_attention.cu``.  Both take the model's
``[B, S, H, D]`` layout directly (no transpose, no padding: the kv tail is
masked by the true length) and read kv head ``h // (Hq / Hkv)`` in place.
Attention is bound by operations on an H100.  A CUDA call takes one of two
routes, chosen by :func:`route` before the launch (no fallback between
them):

* ``"wgmma"`` (bf16, ``D % 8 == 0``; every head dim the zoo's configs
  use): tensor-core products (``wgmma``) on tiles that TMA brings into
  shared memory through two-slot k and v rings, the online softmax in
  registers,
  P rounded to bf16 for the second product (the one change of arithmetic
  against the reference).  TMA wants 16-byte aligned operands and row
  strides: :func:`check_tma_operands` raises otherwise.
* ``"scalar"`` (float32, and bf16 with ``D % 8 != 0``): float32 FMAs from
  shared memory, the reference's arithmetic, far from the tensor cores.

The wrapper takes the lean launch path of :mod:`repro_torch.kernels.lib`
(entry points bound once, arguments packed into one struct, device
guard in C, raw stream handle); the call is device-bound, so this keeps
one calling convention for all kernels rather than saving time.

On a CPU tensor :func:`flash_attention` computes :func:`attention_plain`;
on a CUDA tensor it launches a kernel or raises.  There is no backward
(the reference trains through its plain ``chunked_attention``, as the
port does: ``models/attention.py``), so a call that autograd would have
to differentiate raises on either device instead of dropping the
gradient.  ``launches`` counts
kernel launches only, ``launches_by_route`` splits them by route.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import lib

NEG_INF = -1e30  # the reference's mask value
MAX_HEAD_DIM = 128  # the kernel's largest head_dim
_DTYPES = (torch.float32, torch.bfloat16)
ROUTES = ("wgmma", "scalar")
TMA_ALIGN = 16  # bytes: TMA's rule for a tensor's base and row strides

# The packed ``FlashAttentionArgs`` of ``csrc/flash_attention.cu`` for one
# launch, from (q, k, v, o) pointers, the raw stream, the device index,
# b, s, hq, hkv, d, causal, window (0: none), scale and softcap: the one
# place that packs it.
launch_args = lib.FLASH_ATTENTION_ARGS.pack


def attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    scale: float | None = None,
    softcap: float = 0.0,
) -> torch.Tensor:
    """The plain PyTorch version (``attention_ref``: the S x S softmax
    materialised in float32): what the CPU runs and what the kernel is
    checked against on the card.  q [B,S,Hq,D], k/v [B,S,Hkv,D] ->
    [B,S,Hq,D] in q's dtype."""
    s, hq, d = q.shape[1:]
    g = hq // k.shape[2]
    if scale is None:
        scale = d**-0.5
    kr = k.repeat_interleave(g, dim=2).float()
    vr = v.repeat_interleave(g, dim=2).float()
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), kr) * scale
    if softcap > 0.0:
        scores = softcap * torch.tanh(scores / softcap)
    qpos = torch.arange(s, device=q.device)[:, None]
    kpos = torch.arange(s, device=q.device)[None, :]
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= (qpos - kpos) < window
    scores = scores.masked_fill(~mask, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, vr).to(q.dtype)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window) -> None:
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(
            f"flash_attention wants q [B,S,Hq,D] and k, v [B,S,Hkv,D]; got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    b, s, hq, d = q.shape
    if (k.shape[0], k.shape[1], k.shape[3]) != (b, s, d) or hq % k.shape[2]:
        raise ValueError(
            f"flash_attention: k/v {tuple(k.shape)} do not fit q {tuple(q.shape)}"
        )
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention takes head_dim 1..{MAX_HEAD_DIM}, not {d}")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window must be >= 1, not {window}")
    if q.dtype not in _DTYPES or not (q.dtype == k.dtype == v.dtype):
        raise TypeError(
            "flash_attention wants q, k, v all float32 or all bfloat16; got "
            f"{q.dtype}, {k.dtype}, {v.dtype}"
        )
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention operands must be contiguous")


def route(dtype: torch.dtype, head_dim: int) -> str:
    """The kernel a CUDA call with operands of ``dtype`` and ``head_dim``
    (already checked: at most 128) takes: ``"wgmma"`` for bf16 with
    ``head_dim % 8 == 0``, else ``"scalar"``."""
    if dtype == torch.bfloat16 and head_dim % 8 == 0:
        return "wgmma"
    return "scalar"


def check_tma_operands(*tensors: torch.Tensor) -> None:
    """Raise unless every operand of the ``"wgmma"`` route starts on a
    16-byte boundary and its rows (``D`` elements) are a multiple of 16
    bytes long, as the kernel's TMA tensor maps need."""
    for t in tensors:
        row = t.shape[-1] * t.element_size()
        if t.data_ptr() % TMA_ALIGN or row % TMA_ALIGN:
            raise ValueError(
                f"flash_attention's tensor-core route wants {TMA_ALIGN}-byte aligned "
                f"operands and rows; got an operand at byte {t.data_ptr() % TMA_ALIGN} "
                f"past a boundary with {row}-byte rows"
            )


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    scale: float | None = None,
    softcap: float = 0.0,
) -> torch.Tensor:
    """q [B,S,Hq,D], k/v [B,S,Hkv,D] (float32 or bfloat16, contiguous,
    Hq a multiple of Hkv, D <= 128) -> [B,S,Hq,D] in q's dtype."""
    _check(q, k, v, window)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "flash_attention has no backward: train through "
            "models.attention.chunked_attention (attn_impl='chunked')"
        )
    if scale is None:
        scale = q.shape[-1] ** -0.5
    index = lib.device_index("flash_attention", q, k, v)
    if index < 0:
        return attention_plain(
            q, k, v, causal=causal, window=window, scale=scale, softcap=softcap
        )
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    b, s, hq, d = q.shape
    way = route(q.dtype, d)
    if lib.raw_stream is None:
        lib.load()
    if way == "wgmma":
        check_tma_operands(q, k, v)
        fn = lib.flash_attention_bf16_wgmma
    elif q.dtype == torch.float32:
        fn = lib.flash_attention_f32
    else:
        fn = lib.flash_attention_bf16
    args = launch_args(
        q.data_ptr(),
        k.data_ptr(),
        v.data_ptr(),
        out.data_ptr(),
        lib.raw_stream(index),
        index,
        b,
        s,
        hq,
        k.shape[2],
        d,
        int(causal),
        0 if window is None else int(window),
        scale,
        softcap,
    )
    rc = fn(args)
    if rc:
        lib.check(rc, "flash_attention")
    flash_attention.launches += 1
    flash_attention.launches_by_route[way] += 1
    return out


flash_attention.launches = 0
flash_attention.launches_by_route = dict.fromkeys(ROUTES, 0)

__all__ = [
    "MAX_HEAD_DIM",
    "ROUTES",
    "attention_plain",
    "check_tma_operands",
    "flash_attention",
    "launch_args",
    "route",
]
