"""Fused TD-target + Huber loss: the elementwise tail of a DQN update.

    target = r + gamma * (1 - done) * max_a q_next[a]    (target net)
    delta  = q_sel - target
    loss   = 0.5 delta^2 if |delta| <= 1 else |delta| - 0.5
    dq     = dloss/dq_sel = clip(delta, -1, 1)

Replaces the TPU kernel ``src/repro/kernels/fused_td/kernel.py``
(``fused_td``; ``custom_vjp`` in ``ops.py``, oracle ``ref.py``) with the
hand-written CUDA kernel ``repro_torch/csrc/fused_td.cu``.  What bounds
it on an H100: bytes, ``(A + 5) * 4`` a sample, a few kilobytes at the
fleet's shapes, so the launch dominates; the fleet therefore calls it
once per train step on the flattened rows of all agents.  Unlike the TPU
kernel it masks the tail, so any B works.

:func:`td_loss` wraps it in a ``torch.autograd.Function``: the forward
returns the per-row loss and saves ``dq``; the backward returns
``grad * dq`` for ``q_sel`` and nothing for the target-side inputs.  A
per-agent mean over B taken outside gives the reference's ``g * dq / B``
(``ops.py:34-36``).

On CPU tensors :func:`fused_td` computes :func:`fused_td_plain`; on CUDA
tensors it launches the kernel or raises.  ``launches`` counts kernel
launches only.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import lib


def fused_td_plain(q_sel, q_next, reward, done, gamma: float):
    """The plain PyTorch version (the reference's ``fused_td_ref``
    arithmetic): what the CPU runs and what the kernel is checked
    against on the card.  Returns ``(loss [B, 1], dq [B, 1])``."""
    best = q_next.max(-1, keepdim=True).values
    target = reward + gamma * (1.0 - done) * best
    delta = q_sel - target
    absd = delta.abs()
    loss = torch.where(absd <= 1.0, 0.5 * delta * delta, absd - 0.5)
    return loss, delta.clamp(-1.0, 1.0)


def _check(q_sel, q_next, reward, done) -> None:
    if q_next.dim() != 2 or q_next.shape[1] < 1:
        raise ValueError(f"fused_td wants q_next [B, A>=1]; got {tuple(q_next.shape)}")
    col = (q_next.shape[0], 1)
    for name, t in (("q_sel", q_sel), ("reward", reward), ("done", done)):
        if tuple(t.shape) != col:
            raise ValueError(f"fused_td wants {name} {col}; got {tuple(t.shape)}")
    ts = (q_sel, q_next, reward, done)
    if any(t.dtype != torch.float32 for t in ts):
        raise TypeError("fused_td operands must be float32")
    if any(t.device != q_next.device for t in ts):
        raise ValueError("fused_td operands are on different devices")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("fused_td operands must be contiguous")


def fused_td(q_sel, q_next, reward, done, gamma: float):
    """q_sel [B, 1], q_next [B, A], reward [B, 1], done [B, 1] (float32)
    -> (loss [B, 1], dq [B, 1])."""
    _check(q_sel, q_next, reward, done)
    if q_next.device.type == "cpu":
        return fused_td_plain(q_sel, q_next, reward, done, gamma)
    if q_next.device.type != "cuda":
        raise ValueError(f"fused_td: unsupported device {q_next.device}")
    b, a = q_next.shape
    loss = torch.empty((b, 1), dtype=torch.float32, device=q_next.device)
    dq = torch.empty_like(loss)
    if b == 0:
        return loss, dq
    with torch.cuda.device(q_next.device):
        rc = lib.load().fused_td_f32(
            q_sel.data_ptr(),
            q_next.data_ptr(),
            reward.data_ptr(),
            done.data_ptr(),
            loss.data_ptr(),
            dq.data_ptr(),
            b,
            a,
            float(gamma),
            torch.cuda.current_stream().cuda_stream,
        )
    lib.check(rc, "fused_td")
    fused_td.launches += 1
    return loss, dq


fused_td.launches = 0


class TDLoss(torch.autograd.Function):
    """Per-row Huber TD loss, differentiable in ``q_sel`` only."""

    @staticmethod
    def forward(ctx, q_sel, q_next, reward, done, gamma: float):
        loss, dq = fused_td(q_sel, q_next, reward, done, gamma)
        ctx.save_for_backward(dq)
        return loss

    @staticmethod
    def backward(ctx, grad):
        (dq,) = ctx.saved_tensors
        return grad * dq, None, None, None, None


def td_loss(q_sel, q_next, reward, done, gamma: float) -> torch.Tensor:
    """Per-row TD loss ``[B, 1]`` through the fused kernel, with the
    fused ``dq`` as its gradient (take the mean outside)."""
    return TDLoss.apply(q_sel, q_next, reward, done, gamma)


__all__ = ["TDLoss", "fused_td", "fused_td_plain", "td_loss"]
