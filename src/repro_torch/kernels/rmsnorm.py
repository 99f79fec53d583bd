"""Fused RMSNorm: ``y = x * rsqrt(mean(x^2) + eps) * scale`` in float32,
cast back to ``x``'s dtype.

Every block of the model zoo enters its mixer and its FFN through it, and
the final norm closes the stack: 49 calls per forward of
h2o-danube-3-4b (24 layers).

Replaces the TPU kernel ``src/repro/kernels/rmsnorm/kernel.py``
(``rmsnorm``; dispatch in ``ops.py``, oracle ``ref.py::rmsnorm_ref``) with
the hand-written CUDA kernel ``repro_torch/csrc/rmsnorm.cu``.  What bounds
it on an H100: bytes (x read once, y written once); its design (one warp
per row, 16-byte vector accesses where the row allows, a float32 sum of
squares reduced with warp shuffles, any row count) is set out in the
source.

On a CPU tensor :func:`rmsnorm` computes :func:`rmsnorm_plain`; on a CUDA
tensor it launches the kernel or raises.  ``launches`` counts kernel
launches only.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import lib

_DTYPES = (torch.float32, torch.bfloat16)


def rmsnorm_plain(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """The plain PyTorch version (``rmsnorm_ref``): what the CPU runs and
    what the kernel is checked against on the card."""
    xf = x.float()
    ms = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * scale.float()).to(x.dtype)


def _check(x: torch.Tensor, scale: torch.Tensor) -> None:
    if x.dim() < 1 or scale.shape != (x.shape[-1],):
        raise ValueError(
            f"rmsnorm wants x [..., d] and scale [d]; got {tuple(x.shape)}, "
            f"{tuple(scale.shape)}"
        )
    if x.dtype not in _DTYPES or scale.dtype != torch.float32:
        raise TypeError(
            "rmsnorm wants float32 or bfloat16 x and float32 scale; got "
            f"{x.dtype}, {scale.dtype}"
        )
    if x.device != scale.device:
        raise ValueError("rmsnorm operands are on different devices")
    if not (x.is_contiguous() and scale.is_contiguous()):
        raise ValueError("rmsnorm operands must be contiguous")


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """x [..., d] float32/bfloat16, scale [d] float32 -> like x."""
    _check(x, scale)
    if x.device.type == "cpu":
        return rmsnorm_plain(x, scale, eps)
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm: unsupported device {x.device}")
    d = x.shape[-1]
    n = x.numel() // d if d else 0
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    elem = x.element_size()
    vec = (d * elem) % 16 == 0 and x.data_ptr() % 16 == 0
    kernels = lib.load()
    fn = kernels.rmsnorm_f32 if x.dtype == torch.float32 else kernels.rmsnorm_bf16
    with torch.cuda.device(x.device):
        rc = fn(
            x.data_ptr(),
            scale.data_ptr(),
            out.data_ptr(),
            n,
            d,
            float(eps),
            int(vec),
            torch.cuda.current_stream().cuda_stream,
        )
    lib.check(rc, "rmsnorm")
    rmsnorm.launches += 1
    return out


rmsnorm.launches = 0

__all__ = ["rmsnorm", "rmsnorm_plain"]
