"""Fused TD tail of the stacked DQN update: from the Q-values to each
agent's mean Huber loss and its gradient, in one launch.

    a        = the row's stored action, truncated to an int
    q_sel    = q[a]                                (jnp.take_along_axis)
    target   = r + gamma * (1 - done) * max_a q_next[a]    (target net)
    delta    = q_sel - target
    loss_row = 0.5 delta^2 if |delta| <= 1 else |delta| - 0.5
    dq       = dloss_row/dq_sel = clip(delta, -1, 1)
    loss     = mean_b loss_row                     (per agent)
    grad_q   = dq / B at the selected action, 0 elsewhere

and, on request, the fleet observatory's per-agent statistics from the
same launch (the reference's ``fleet.py::loss_fn_stats`` aux outputs):

    td_abs   = mean_b |delta|                      (unclipped)
    q_max    = max_{b, a} |q|                      (NaN if any q is NaN)

Replaces the TPU kernel ``src/repro/kernels/fused_td/kernel.py``
(``fused_td``: ``loss_row`` and ``dq``; ``custom_vjp`` in ``ops.py``,
oracle ``ref.py``) and the operations its caller ran around it in the
same XLA program (``src/repro/rl/fleet.py::make_dqn_loss_fn``: the
``take_along_axis`` select before it, the mean after it, the select's
gradient scatter in backward) with the hand-written CUDA kernel
``repro_torch/csrc/fused_td.cu``.  What bounds it on an H100: bytes, a
few kilobytes at the fleet's shapes, so the launch dominates the call;
the wrapper takes the lean launch path of :mod:`repro_torch.kernels.lib`
(entry point bound once, its arguments packed into one struct, device
guard in C, raw stream handle).  ``action``, ``reward`` and ``done`` are
read in place from the gathered replay rows at the column offsets
``cols`` (:func:`repro_torch.core.erb.flat_columns`).

An action out of range follows JAX: ``a`` in ``[-A, -1]`` wraps, any
other selects NaN (and a NaN action truncates to 0, as ``astype``).

:func:`td_loss` wraps it in a ``torch.autograd.Function``: the forward
returns ``loss [N]`` and saves ``grad_q``; the backward returns
``grad[:, None, None] * grad_q`` for ``q`` (the reference's
``g * dq / B``) and nothing for the target-side inputs.

The statistics are asked for with ``stats=(td_abs, q_max)``, two
float32 ``[N]`` tensors the launch writes into (rows of the train
chunk's stats buffer, so the K steps copy nothing); ``stats=None``
passes null pointers and the kernel writes what it wrote before the
statistics existed.  Through :func:`td_loss` they are outputs marked
non-differentiable.

On CPU tensors :func:`fused_td` computes :func:`fused_td_plain`; on CUDA
tensors it launches the kernel or raises.  ``launches`` counts kernel
launches only.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import lib

# The packed ``FusedTdArgs`` of ``csrc/fused_td.cu`` for one launch, from
# the (q, q_next, rows, loss_rows, dq, loss, grad_q, td_abs, q_max)
# pointers (the last two 0 for no statistics), the raw stream, the device
# index, n, b, a, f, the action, reward and done columns, and gamma: the
# one place that packs it.
launch_args = lib.FUSED_TD_ARGS.pack


class TDOut(NamedTuple):
    loss: torch.Tensor  # [N] each agent's mean loss
    loss_rows: torch.Tensor  # [N, B]
    dq: torch.Tensor  # [N, B] clip(delta, -1, 1)
    grad_q: torch.Tensor  # [N, B, A] dq / B at the selected action
    td_abs: torch.Tensor | None = None  # [N] mean |delta|; statistics only
    q_max: torch.Tensor | None = None  # [N] max |q|; statistics only


def fused_td_plain(q, q_next, rows, cols, gamma: float) -> TDOut:
    """The plain PyTorch version in the reference's order (select the
    action, ``fused_td_ref``'s arithmetic per row, the mean per agent,
    then ``loss_fn_stats``' two statistics): what the CPU runs and what
    the kernel is checked against on the card.  Always computes the
    statistics."""
    a, b = q.shape[2], q.shape[1]
    col_a, col_r, col_d = cols
    # the action as jnp.take_along_axis(q, action.astype(int32)) selects:
    # truncated, NaN read as 0, [-A, -1] wrapped, NaN where still out of
    # range (torch.gather would raise)
    t = torch.nan_to_num(rows[..., col_a].trunc(), nan=0.0)
    t = torch.where(t < 0, t + a, t)
    valid = (t >= 0) & (t < a)
    index = torch.where(valid, t, 0.0).long()[..., None]
    q_sel = torch.where(valid, q.gather(2, index)[..., 0], torch.nan)
    best = q_next.max(-1).values
    target = rows[..., col_r] + gamma * (1.0 - rows[..., col_d]) * best
    delta = q_sel - target
    absd = delta.abs()
    loss_rows = torch.where(absd <= 1.0, 0.5 * delta * delta, absd - 0.5)
    dq = delta.clamp(-1.0, 1.0)
    g = torch.where(valid, dq / b, 0.0)
    grad_q = torch.zeros_like(q).scatter_(2, index, g[..., None])
    # jnp.mean(|q_sel - td_target|) and jnp.max(|q|): NaN propagates
    td_abs = absd.sum(1) / b
    q_max = q.abs().amax((1, 2))
    return TDOut(loss_rows.sum(1) / b, loss_rows, dq, grad_q, td_abs, q_max)


def _check_stats(stats, q, n: int) -> None:
    """Raise unless ``stats`` is two float32 ``[n]`` contiguous tensors
    on ``q``'s device."""
    if len(stats) != 2 or any(
        t.shape != (n,)
        or t.dtype is not torch.float32
        or not t.is_contiguous()
        or t.device != q.device
        for t in stats
    ):
        raise ValueError(
            f"fused_td stats must be (td_abs, q_max), float32 [{n}] contiguous "
            f"tensors on {q.device}"
        )


def _check(q, q_next, rows, cols) -> tuple[int, int, int, int]:
    """Raise on operands the kernel does not take; return n, b, a, f
    (each attribute read once)."""
    qs, ns, rs = q.shape, q_next.shape, rows.shape
    if len(qs) != 3 or ns != qs or len(rs) != 3 or rs[:2] != qs[:2] or qs[2] < 1:
        raise ValueError(
            "fused_td wants q, q_next [N, B, A>=1] and rows [N, B, F]; got "
            f"{tuple(qs)}, {tuple(ns)}, {tuple(rs)}"
        )
    f = rs[2]
    col_a, col_r, col_d = cols
    if not (0 <= col_a < f and 0 <= col_r < f and 0 <= col_d < f):
        raise ValueError(f"fused_td: columns {cols} do not index rows of {f}")
    qt, nt, rt = q.dtype, q_next.dtype, rows.dtype
    if not (qt is torch.float32 and nt is torch.float32 and rt is torch.float32):
        raise TypeError(f"fused_td operands must be float32; got {qt}, {nt}, {rt}")
    if not (q.is_contiguous() and q_next.is_contiguous() and rows.is_contiguous()):
        raise ValueError("fused_td operands must be contiguous")
    return qs[0], qs[1], qs[2], f


def fused_td(q, q_next, rows, cols, gamma: float, stats=None) -> TDOut:
    """q, q_next [N, B, A] f32, rows [N, B, F] f32, ``cols`` the
    (action, reward, done) column offsets of ``rows`` -> :class:`TDOut`;
    ``stats`` None, or the ``(td_abs, q_max)`` [N] tensors to write the
    statistics into (then ``TDOut.td_abs``, ``.q_max``)."""
    n, b, a, f = _check(q, q_next, rows, cols)
    if stats is not None:
        _check_stats(stats, q, n)
    index = lib.device_index("fused_td", q, q_next, rows)
    if index < 0:
        out = fused_td_plain(q, q_next, rows, cols, gamma)
        if stats is None:
            return out._replace(td_abs=None, q_max=None)
        stats[0].copy_(out.td_abs)
        stats[1].copy_(out.q_max)
        return out._replace(td_abs=stats[0], q_max=stats[1])
    loss, loss_rows, dq = q.new_empty(n), q.new_empty(n, b), q.new_empty(n, b)
    td_abs, q_max = (None, None) if stats is None else stats
    out = TDOut(loss, loss_rows, dq, q.new_empty(n, b, a), td_abs, q_max)
    if n == 0:
        return out
    if lib.raw_stream is None:
        lib.load()
    args = launch_args(
        q.data_ptr(),
        q_next.data_ptr(),
        rows.data_ptr(),
        loss_rows.data_ptr(),
        dq.data_ptr(),
        loss.data_ptr(),
        out.grad_q.data_ptr(),
        0 if stats is None else td_abs.data_ptr(),
        0 if stats is None else q_max.data_ptr(),
        lib.raw_stream(index),
        index,
        n,
        b,
        a,
        f,
        *cols,
        gamma,
    )
    rc = lib.fused_td_f32(args)
    if rc:
        lib.check(rc, "fused_td")
    fused_td.launches += 1
    return out


fused_td.launches = 0


class TDLoss(torch.autograd.Function):
    """Per-agent mean Huber TD loss, differentiable in ``q`` only; with
    ``stats``, also ``td_abs`` and ``q_max``, non-differentiable."""

    @staticmethod
    def forward(ctx, q, q_next, rows, cols, gamma: float, stats):
        out = fused_td(q, q_next, rows, cols, gamma, stats)
        ctx.save_for_backward(out.grad_q)
        if stats is None:
            return out.loss
        ctx.mark_non_differentiable(out.td_abs, out.q_max)
        return out.loss, out.td_abs, out.q_max

    @staticmethod
    def backward(ctx, grad, *_stats_grads):
        (grad_q,) = ctx.saved_tensors
        return grad[:, None, None] * grad_q, None, None, None, None, None


def td_loss(q, q_next, rows, cols, gamma: float, stats=None):
    """Each agent's mean TD loss ``[N]`` through the fused kernel, with
    the fused ``grad_q`` as its gradient; with ``stats`` (the ``[N]``
    ``td_abs`` and ``q_max`` tensors to write), ``(loss, td_abs,
    q_max)``."""
    return TDLoss.apply(q, q_next, rows, cols, gamma, stats)


__all__ = [
    "TDLoss",
    "TDOut",
    "fused_td",
    "fused_td_plain",
    "launch_args",
    "td_loss",
]
