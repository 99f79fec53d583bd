"""ERB batched gather: ``out[i, :] = buffer[idx[i], :] * w[i]``.

The fleet's minibatch gather: every train step reads ``N * B`` rows of
the pooled device replay ``[R, F]`` by index.

Replaces the TPU kernel ``src/repro/kernels/replay_gather/kernel.py``
(``replay_gather``; dispatch in ``ops.py``, oracle ``ref.py``) with the
hand-written CUDA kernel ``repro_torch/csrc/replay_gather.cu``.  What
bounds it on an H100: bytes, ``2 * B * F * 4`` of them, which at the
fleet's shapes is about a megabyte, a fraction of a microsecond, so the
host's launch path dominates the call.  The wrapper therefore takes the
lean launch path of :mod:`repro_torch.kernels.lib` (entry point bound
once, its arguments packed into one struct, device guard in C, raw
stream handle).  The kernel's design (a warp
per row, 16-byte loads aligned on the source row's phase, 16-byte stores
where the destination has the same phase, masked scalar head and tail)
is set out in the source.

On a CPU tensor :func:`replay_gather` computes :func:`replay_gather_plain`;
on a CUDA tensor it launches the kernel or raises.  ``launches`` counts
kernel launches only.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import lib

# The packed ``ReplayGatherArgs`` of ``csrc/replay_gather.cu`` for one
# launch, from (buffer, idx, w, out) pointers, the raw stream, the device
# index, batch and feat: the one place that packs it.
launch_args = lib.REPLAY_GATHER_ARGS.pack


def replay_gather_plain(
    buffer: torch.Tensor, idx: torch.Tensor, w: torch.Tensor
) -> torch.Tensor:
    """The plain PyTorch version: what the CPU runs and what the kernel
    is checked against on the card."""
    return buffer[idx.long()] * w[:, None]


def _check(
    buffer: torch.Tensor, idx: torch.Tensor, w: torch.Tensor
) -> tuple[int, int]:
    """Raise on operands the kernel does not take; return the batch and
    the row width (each attribute read once)."""
    bshape, ishape = buffer.shape, idx.shape
    if len(bshape) != 2 or len(ishape) != 1 or w.shape != ishape:
        raise ValueError(
            f"replay_gather wants buffer [cap, F], idx [B], w [B]; got "
            f"{tuple(bshape)}, {tuple(ishape)}, {tuple(w.shape)}"
        )
    bt, it, wt = buffer.dtype, idx.dtype, w.dtype
    if not (bt is torch.float32 and it is torch.int32 and wt is torch.float32):
        raise TypeError(
            "replay_gather wants float32 buffer, int32 idx, float32 w; got "
            f"{bt}, {it}, {wt}"
        )
    if not (buffer.is_contiguous() and idx.is_contiguous() and w.is_contiguous()):
        raise ValueError("replay_gather operands must be contiguous")
    return ishape[0], bshape[1]


def replay_gather(
    buffer: torch.Tensor, idx: torch.Tensor, w: torch.Tensor
) -> torch.Tensor:
    """buffer [cap, F] f32, idx [B] i32, w [B] f32 -> [B, F] f32.

    Every ``idx`` must lie in ``[0, cap)``; the caller checks that on the
    host (a device-side check would synchronise)."""
    batch, feat = _check(buffer, idx, w)
    index = lib.device_index("replay_gather", buffer, idx, w)
    if index < 0:
        return replay_gather_plain(buffer, idx, w)
    out = buffer.new_empty(batch, feat)  # sizes as arguments: parsed faster
    if batch == 0:
        return out
    if lib.raw_stream is None:
        lib.load()
    args = launch_args(
        buffer.data_ptr(),
        idx.data_ptr(),
        w.data_ptr(),
        out.data_ptr(),
        lib.raw_stream(index),
        index,
        batch,
        feat,
    )
    rc = lib.replay_gather_f32(args)
    if rc:
        lib.check(rc, "replay_gather")
    replay_gather.launches += 1
    return out


replay_gather.launches = 0

__all__ = ["launch_args", "replay_gather", "replay_gather_plain"]
