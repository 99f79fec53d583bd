"""Fused RMSNorm: ``y = x * rsqrt(mean(x^2) + eps) * scale`` in float32,
cast back to ``x``'s dtype.

Every block of the model zoo enters its mixer and its FFN through it, and
the final norm closes the stack: 49 calls per forward of
h2o-danube-3-4b (24 layers).

Replaces the TPU kernel ``src/repro/kernels/rmsnorm/kernel.py``
(``rmsnorm``; dispatch in ``ops.py``, oracle ``ref.py::rmsnorm_ref``) with
the hand-written CUDA kernels of ``repro_torch/csrc/rmsnorm.cu``.  What
bounds it on an H100: bytes (x read once, y written once) at the prefill
shape, the host's launch path at the decode shape, where a call moves
61 KB; the wrapper takes the lean launch path of
:mod:`repro_torch.kernels.lib`.  :func:`launch_plan` picks one of two
routes before the launch (no fallback between them):

* ``"cta"``: a CTA of 128 or 256 threads per row (256 with fewer rows
  than :data:`SPREAD_ROWS` or over 8 KB a row), the row held in
  registers between its sum of squares and its scaling, so x is read
  from device memory once; a CTA per row spreads the four rows of a
  decode step over four SMs and the 4000 of a prefill over all of them;
* ``"masked"``: rows over :data:`REGISTER_ROW_BYTES`, rows whose length is
  no multiple of 16 bytes and operands not 16-byte aligned: a warp per
  row that reads it twice, the tail masked.

On a CPU tensor :func:`rmsnorm` computes :func:`rmsnorm_plain`; on a CUDA
tensor it launches a kernel or raises.  ``launches`` counts kernel
launches only, ``launches_by_route`` splits them by route.

:class:`RMSNorm` is the differentiable form the model calls: its forward
is :func:`rmsnorm` (the kernel on the card), its backward the explicit
formula in float32 in plain torch (the reference has no backward kernel
either: JAX differentiates its plain ``norm_apply``).  The wrapper alone
returns a tensor the kernel wrote, which autograd cannot see through.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.kernels import lib

_pack = lib.RMSNORM_ARGS.pack
_DTYPES = (torch.float32, torch.bfloat16)
ROUTES = ("cta", "masked")  # their order is the C side's route code
_ROUTE_CODE = {r: i for i, r in enumerate(ROUTES)}
REGISTER_ROW_BYTES = 16 * 1024  # the longest row the single pass holds
MASKED_ROWS_PER_CTA = 8
CTA_VECS = 4  # cta route: 16-byte vectors a thread holds
SPREAD_ROWS = 132  # an H100's SMs: fewer rows take 256 threads a row


def rmsnorm_plain(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """The plain PyTorch version (``rmsnorm_ref``): what the CPU runs and
    what the kernel is checked against on the card."""
    xf = x.float()
    ms = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * scale.float()).to(x.dtype)


def _check(x: torch.Tensor, scale: torch.Tensor) -> tuple[int, bool]:
    """Raise on operands the kernel does not take; return the row width
    and whether x is float32 (each attribute read once)."""
    shape, sshape = x.shape, scale.shape
    if len(shape) < 1 or len(sshape) != 1 or sshape[0] != shape[-1]:
        raise ValueError(
            f"rmsnorm wants x [..., d] and scale [d]; got {tuple(shape)}, "
            f"{tuple(sshape)}"
        )
    dtype, stype = x.dtype, scale.dtype
    if dtype not in _DTYPES or stype is not torch.float32:
        raise TypeError(
            "rmsnorm wants float32 or bfloat16 x and float32 scale; got "
            f"{dtype}, {stype}"
        )
    if not (x.is_contiguous() and scale.is_contiguous()):
        raise ValueError("rmsnorm operands must be contiguous")
    return shape[-1], dtype is torch.float32


@functools.lru_cache(maxsize=256)
def launch_plan(
    n: int, d: int, elem: int, aligned: bool = True
) -> tuple[str, int, int, bool]:
    """``(route, threads_per_row, rows_per_cta, vec)`` for ``n`` rows of
    ``d`` elements of ``elem`` bytes; ``aligned``: x, scale and out all
    start on a 16-byte boundary.  ``vec``: 16-byte accesses."""
    row = d * elem
    vec = aligned and row % 16 == 0
    if not vec or row > REGISTER_ROW_BYTES:
        return "masked", 32, MASKED_ROWS_PER_CTA, vec
    # 128 threads when they hold the row at CTA_VECS vectors a thread and
    # the rows fill the card; with fewer rows than SMs each row's loads
    # spread over 256 threads
    narrow = n >= SPREAD_ROWS and row // 16 <= CTA_VECS * 128
    return "cta", 128 if narrow else 256, 1, True


def launch_args(x_ptr, scale_ptr, out_ptr, stream, index, n, d, plan, eps) -> bytes:
    """The packed ``RmsnormArgs`` of ``csrc/rmsnorm.cu`` for one launch of
    ``plan`` (a :func:`launch_plan`) on the raw ``stream`` of device
    ``index``: the one place that packs it (field order as in the C
    struct; the format is :data:`lib.RMSNORM_ARGS`)."""
    way, threads, rows, vec = plan
    return _pack(
        x_ptr,
        scale_ptr,
        out_ptr,
        stream,
        index,
        n,
        d,
        _ROUTE_CODE[way],
        threads,
        rows,
        vec,
        eps,
    )


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """x [..., d] float32/bfloat16, scale [d] float32 -> like x."""
    d, f32 = _check(x, scale)
    index = lib.device_index("rmsnorm", x, scale)
    if index < 0:
        return rmsnorm_plain(x, scale, eps)
    out = torch.empty_like(x)
    n = out.numel() // d if d else 0
    if n == 0:
        return out
    if lib.raw_stream is None:
        lib.load()
    xp, sp, op = x.data_ptr(), scale.data_ptr(), out.data_ptr()
    plan = launch_plan(n, d, 4 if f32 else 2, (xp | sp | op) % 16 == 0)
    args = launch_args(xp, sp, op, lib.raw_stream(index), index, n, d, plan, eps)
    rc = (lib.rmsnorm_f32 if f32 else lib.rmsnorm_bf16)(args)
    if rc:
        lib.check(rc, "rmsnorm")
    rmsnorm.launches += 1
    rmsnorm.launches_by_route[plan[0]] += 1
    return out


rmsnorm.launches = 0
rmsnorm.launches_by_route = dict.fromkeys(ROUTES, 0)


def rmsnorm_backward(
    x: torch.Tensor, scale: torch.Tensor, g: torch.Tensor, eps: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(dx, dscale)`` of ``y = x * rstd * scale`` for the upstream ``g``,
    in float32: with ``x^ = x * rstd`` and ``gs = g * scale``,
    ``dx = rstd * (gs - x^ * mean(gs * x^))`` and ``dscale = sum_rows g * x^``.
    ``dx`` comes back in x's dtype, ``dscale`` in float32."""
    xf = x.float()
    rstd = torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    xhat = xf * rstd
    gf = g.float()
    gs = gf * scale.float()
    dx = rstd * (gs - xhat * (gs * xhat).mean(-1, keepdim=True))
    dscale = (gf * xhat).reshape(-1, x.shape[-1]).sum(0)
    return dx.to(x.dtype), dscale


class RMSNorm(torch.autograd.Function):
    """``RMSNorm.apply(x, scale, eps)``: :func:`rmsnorm` forward (one kernel
    launch on a CUDA tensor, the plain version on a CPU one) with
    :func:`rmsnorm_backward` as its gradient.  The per-row ``rstd`` is
    computed again in the backward, so the forward stays one launch."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, scale: torch.Tensor, eps: float):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return rmsnorm(x, scale, eps)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        x, scale = ctx.saved_tensors
        dx, dscale = rmsnorm_backward(x, scale, g, ctx.eps)
        return dx, dscale, None

__all__ = [
    "REGISTER_ROW_BYTES",
    "ROUTES",
    "RMSNorm",
    "SPREAD_ROWS",
    "launch_args",
    "launch_plan",
    "rmsnorm",
    "rmsnorm_backward",
    "rmsnorm_plain",
]
