"""ERB batched gather: ``out[i, :] = buffer[idx[i], :] * w[i]``.

The fleet's minibatch gather: every train step reads ``N * B`` rows of
the pooled device replay ``[R, F]`` by index.

Replaces the TPU kernel ``src/repro/kernels/replay_gather/kernel.py``
(``replay_gather``; dispatch in ``ops.py``, oracle ``ref.py``) with the
hand-written CUDA kernel ``repro_torch/csrc/replay_gather.cu``.  What
bounds it on an H100: bytes, ``2 * B * F * 4`` of them, which at the
fleet's shapes is about a megabyte, so the launch itself dominates.  Its
design (one block per output row, coalesced 4-byte loads and stores, a
masked tail) is set out in the source.

On a CPU tensor :func:`replay_gather` computes :func:`replay_gather_plain`;
on a CUDA tensor it launches the kernel or raises.  ``launches`` counts
kernel launches only.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import lib


def replay_gather_plain(
    buffer: torch.Tensor, idx: torch.Tensor, w: torch.Tensor
) -> torch.Tensor:
    """The plain PyTorch version: what the CPU runs and what the kernel
    is checked against on the card."""
    return buffer[idx.long()] * w[:, None]


def _check(buffer: torch.Tensor, idx: torch.Tensor, w: torch.Tensor) -> None:
    if buffer.dim() != 2 or idx.dim() != 1 or w.shape != idx.shape:
        raise ValueError(
            f"replay_gather wants buffer [cap, F], idx [B], w [B]; got "
            f"{tuple(buffer.shape)}, {tuple(idx.shape)}, {tuple(w.shape)}"
        )
    f32, i32 = torch.float32, torch.int32
    if (buffer.dtype, idx.dtype, w.dtype) != (f32, i32, f32):
        raise TypeError(
            "replay_gather wants float32 buffer, int32 idx, float32 w; got "
            f"{buffer.dtype}, {idx.dtype}, {w.dtype}"
        )
    if not (buffer.device == idx.device == w.device):
        raise ValueError("replay_gather operands are on different devices")
    if not (buffer.is_contiguous() and idx.is_contiguous() and w.is_contiguous()):
        raise ValueError("replay_gather operands must be contiguous")


def replay_gather(
    buffer: torch.Tensor, idx: torch.Tensor, w: torch.Tensor
) -> torch.Tensor:
    """buffer [cap, F] f32, idx [B] i32, w [B] f32 -> [B, F] f32.

    Every ``idx`` must lie in ``[0, cap)``; the caller checks that on the
    host (a device-side check would synchronise)."""
    _check(buffer, idx, w)
    if buffer.device.type == "cpu":
        return replay_gather_plain(buffer, idx, w)
    if buffer.device.type != "cuda":
        raise ValueError(f"replay_gather: unsupported device {buffer.device}")
    batch, feat = idx.shape[0], buffer.shape[1]
    out = torch.empty((batch, feat), dtype=torch.float32, device=buffer.device)
    if batch == 0:
        return out
    with torch.cuda.device(buffer.device):
        rc = lib.load().replay_gather_f32(
            buffer.data_ptr(),
            idx.data_ptr(),
            w.data_ptr(),
            out.data_ptr(),
            batch,
            feat,
            torch.cuda.current_stream().cuda_stream,
        )
    lib.check(rc, "replay_gather")
    replay_gather.launches += 1
    return out


replay_gather.launches = 0

__all__ = ["replay_gather", "replay_gather_plain"]
