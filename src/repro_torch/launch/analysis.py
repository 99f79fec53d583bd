"""Roofline analysis sources of the H100 planner (``launch/dryrun.py``).

The port of the reference's ``repro/launch/analysis.py``.  The reference
walks a jaxpr and parses XLA's optimized HLO; PyTorch has neither, so:

* FLOPs: :class:`FlopCounter`, a ``TorchDispatchMode`` that sees every
  aten operation the port's own step runs, on ``meta`` tensors at the
  global shapes (nothing is allocated or computed).  The counting rules
  are the reference's ``_jaxpr_flops`` rules (``:112-157``), so that the
  two packages' counts agree: a matrix product ``2 * out * k``; a
  convolution ``2 * out * k_spatial * cin / groups`` with ``cin`` the
  weight's input-channel dimension (the reference's rule: for a grouped
  convolution that dimension is already ``C_in / groups``, so it divides
  by the groups twice; copied, so that the counts agree); elementwise
  operations 1 an element, transcendentals 5, reductions their input
  size.  A fused aten operation with no single JAX primitive (softmax,
  SiLU, a backward formula) counts as the primitives JAX's own
  definition of it would trace to (:data:`_FUSED`).  Comparisons,
  casts, copies, gathers and scatters count nothing, as in the
  reference.  Recomputation is counted where it runs: the port's
  checkpoints (under ``remat`` each group of layers and each block in
  it; a query chunk of the attention, a chunk of the cross entropy, of
  the recurrences) recompute their forward in the backward, as the
  reference's ``jax.checkpoint`` bodies do.  A group's recompute stops
  where its last block's input is saved (torch's early stop), as JAX's
  drops the last block's forward that nothing reads, so the two count
  the same products.  The reference also checkpoints each kv step
  inside a query chunk, so its training counts one more ``Q K^T``
  product a block than the port's, which does not
  (``tests/test_torch_planner.py`` holds the two counts together with
  that term, and a dead product of the reference's sLSTM scan, added;
  both are products of a backward, which runs once whatever the
  rematerialisation, so each counts the same with and without it).
* collective bytes: the reference parses the per-device collectives out
  of the compiled HLO (``parse_collectives``, ``top_collectives``).  The
  port compiles no SPMD program, so :func:`collective_bytes` models them
  from the sharding specs, per device and per step, with ring algorithms
  (a group of ``n`` moves ``(n - 1) / n`` of the gathered tensor a
  device for an all-gather or a reduce-scatter, twice that for an
  all-reduce):

  - FSDP: every parameter leaf sharded over a data-parallel axis is
    all-gathered over those axes before its use, once in the forward
    and once in the backward (per microbatch), and its gradient
    reduce-scattered back over them (per microbatch); a leaf (or the
    part of one) replicated over a batch axis has its gradient
    all-reduced over that axis;
  - tensor parallelism: with the policy's ``tensor_parallel`` and a
    ``model`` axis over 1, the residual stream ``[B, S, d]`` of the
    device's batch is all-reduced over ``model`` after every mixer and
    every FFN, in the forward and again in the backward (a
    reduce-scatter plus an all-gather under sequence parallelism moves
    the same bytes);
  - MoE: the port runs the reference's single-shard dispatch (every
    expert's slots on the device, no all-to-all); the expert weights
    come by the FSDP gathers above and the combine is the FFN's
    all-reduce.

  Each byte is put on the link of its axis: ``model`` on NVLink,
  ``data`` and ``pod`` on the network (``launch/mesh.py``).
* memory traffic: :func:`analytic_hbm_bytes`, the reference's analytic
  model, copied verbatim.
"""

from __future__ import annotations

import math
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# ---------------------------------------------------------------------------
# the aten FLOP counter
# ---------------------------------------------------------------------------
_MATMUL = {"mm", "bmm", "addmm", "baddbmm", "addbmm", "mv", "dot", "addmv"}
_CONV = {"convolution", "convolution_backward"}
_ELEMENTWISE_1 = {
    "add",
    "sub",
    "rsub",
    "mul",
    "div",
    "maximum",
    "minimum",
    "fmax",
    "fmin",
    "neg",
    "abs",
    "floor",
    "ceil",
    "round",
    "trunc",
    "sign",
    "sgn",
    "bitwise_and",
    "bitwise_or",
    "bitwise_xor",
    "bitwise_not",
    "logical_and",
    "logical_or",
    "logical_xor",
    "logical_not",
    "where",
    "masked_fill",
    "clamp",
    "clamp_min",
    "clamp_max",
    "remainder",
    "fmod",
    "pow",
    "square",
    "reciprocal",
}
_ELEMENTWISE_T = {
    "exp",
    "log",
    "tanh",
    "sigmoid",
    "sin",
    "cos",
    "sqrt",
    "rsqrt",
    "erf",
    "exp2",
    "log1p",
    "expm1",
    "tan",
    "atan2",
}
_REDUCE = {
    "sum",
    "amax",
    "amin",
    "prod",
    "argmax",
    "argmin",
    "any",
    "all",
    "cumsum",
    "cumprod",
    "cummax",
    "cummin",
    "max",
    "min",
}
# Fused aten operations, counted as the JAX primitives their JAX
# definitions trace to, per element: (of the output, of the first input).
_FUSED = {
    "silu": (6, 0),  # x * logistic(x)
    "silu_backward": (9, 0),  # the product rule through logistic
    "sigmoid_backward": (3, 0),  # g * y * (1 - y)
    "tanh_backward": (3, 0),  # g * (1 - y * y)
    "softplus": (12, 0),  # logaddexp(x, 0)
    "gelu": (12, 0),  # the tanh form
    "gelu_backward": (20, 0),
    "addcmul": (2, 0),
    "addcdiv": (2, 0),
    "lerp": (3, 0),
    "_softmax": (7, 2),  # max, sub, exp, sum, div
    "_log_softmax": (7, 2),
    "_softmax_backward_data": (3, 1),  # y * (g - sum(g * y))
    "_log_softmax_backward_data": (7, 1),
    "logsumexp": (6, 3),  # max, sub, exp, sum, log, add
    "mean": (1, 1),  # sum, then a divide
    "threshold_backward": (1, 0),
    "log_sigmoid_forward": (0, 19),  # -logaddexp(-x, 0)
    "log_sigmoid_backward": (0, 8),
    "softplus_backward": (0, 8),
}


def _numel(x) -> int:
    return x.numel() if isinstance(x, torch.Tensor) else 0


def _first_tensor(args):
    for a in args:
        if isinstance(a, torch.Tensor):
            return a
        if isinstance(a, (list, tuple)):
            t = _first_tensor(a)
            if t is not None:
                return t
    return None


def _out_numel(out) -> int:
    if isinstance(out, torch.Tensor):
        return out.numel()
    if isinstance(out, (list, tuple)):
        return sum(_out_numel(o) for o in out)
    return 0


def _matmul_flops(name: str, args, out) -> float:
    if name in ("mm", "bmm", "mv", "dot"):
        a = args[0]
        return 2.0 * _out_numel(out) * a.shape[-1]
    # addmm(bias, a, b), baddbmm(bias, a, b), addmv(bias, a, v), addbmm
    a = args[1]
    return 2.0 * _out_numel(out) * a.shape[-1]


def _conv_flops(name: str, args, out) -> float:
    """The reference's rule ``2 * out * k_spatial * cin / groups``, ``cin``
    the weight's input-channel dimension.  The backward counts that of
    its forward once for each gradient it computes (the input's, the
    weight's; the bias's is a reduction)."""
    if name == "convolution":
        w, groups = args[1], args[8]
        return 2.0 * out.numel() * math.prod(w.shape[2:]) * w.shape[1] / groups
    grad_out, w, groups, mask = args[0], args[2], args[9], args[10]
    fwd = 2.0 * grad_out.numel() * math.prod(w.shape[2:]) * w.shape[1] / groups
    return fwd * (int(mask[0]) + int(mask[1]))


class FlopCounter(TorchDispatchMode):
    """Counts the FLOPs of every aten operation run inside it, by the
    reference's rules (module docstring), into ``by_kind``: ``matmul``,
    ``conv``, ``elementwise``, ``transcendental``, ``reduction``,
    ``fused``.  ``unknown`` keeps the names of operations no rule
    covers (counted as nothing: views, copies, gathers, comparisons).

        with FlopCounter() as fc:
            step(state, batch)
        fc.total
    """

    def __init__(self):
        super().__init__()
        self.by_kind: dict[str, float] = defaultdict(float)
        self.unknown: set[str] = set()

    @property
    def total(self) -> float:
        return float(sum(self.by_kind.values()))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self._count(func.overloadpacket.__name__, func, args, out)
        return out

    def _count(self, name: str, func, args, out) -> None:
        base = name[:-1] if name.endswith("_") and not name.startswith("_") else name
        if base in _MATMUL:
            self.by_kind["matmul"] += _matmul_flops(base, args, out)
        elif base in _CONV:
            self.by_kind["conv"] += _conv_flops(base, args, out)
        elif base in _ELEMENTWISE_T:
            self.by_kind["transcendental"] += 5.0 * _out_numel(out)
        elif base in ("max", "min") and func._overloadname in ("other", "out"):
            self.by_kind["elementwise"] += _out_numel(out)
        elif base in _REDUCE:
            self.by_kind["reduction"] += _numel(_first_tensor(args))
        elif base in _ELEMENTWISE_1:
            self.by_kind["elementwise"] += _out_numel(out)
        elif base in _FUSED:
            per_out, per_in = _FUSED[base]
            n_in = _numel(_first_tensor(args))
            self.by_kind["fused"] += per_out * _out_numel(out) + per_in * n_in
        else:
            self.unknown.add(name)


def count_flops(fn, *args, **kw) -> float:
    """Global FLOPs of ``fn(*args, **kw)``, run under a :class:`FlopCounter`
    (on ``meta`` tensors nothing is computed)."""
    with FlopCounter() as fc:
        fn(*args, **kw)
    return fc.total


# ---------------------------------------------------------------------------
# the activations autograd keeps
# ---------------------------------------------------------------------------
class SavedBytes:
    """Bytes of the tensors autograd saves for the backward, counted while
    a forward runs inside it (``torch.autograd.graph.saved_tensors_hooks``):
    each storage once, however many operations save it or views of it.

        with SavedBytes() as sb:
            loss = loss_fn(params, batch)
        sb.bytes

    A non-reentrant checkpoint saves its inputs through the hooks in
    force where it is called (``_CheckpointFrame.save_inputs``), so an
    outermost checkpoint's inputs are counted here (under ``remat``: each
    group's input of the residual stream); the tensors its region saves,
    a nested checkpoint's inputs among them, go to its own hooks and are
    recomputed in the backward, so they are not.  What the recompute
    holds while a region's backward runs is not seen here
    (``launch/dryrun.py::recompute_bytes`` sizes it)."""

    def __init__(self):
        self.bytes = 0
        self._seen: set[int] = set()
        self._hooks = torch.autograd.graph.saved_tensors_hooks(self._pack, _unpack)

    def exclude(self, tensors) -> None:
        """Never count the storages of ``tensors`` (the step's own inputs:
        params, optimizer state, caches and batch, sized apart)."""
        for t in tensors:
            self._seen.add(t.untyped_storage()._cdata)

    def _pack(self, t: torch.Tensor):
        storage = t.untyped_storage()
        key = storage._cdata
        if key not in self._seen:
            self._seen.add(key)
            self.bytes += storage.nbytes()
        return t

    def __enter__(self):
        self._hooks.__enter__()
        return self

    def __exit__(self, *exc):
        return self._hooks.__exit__(*exc)


def _unpack(t):
    return t


# ---------------------------------------------------------------------------
# the collective model (per device, per step)
# ---------------------------------------------------------------------------
def _axes(ax) -> tuple[str, ...]:
    if ax is None:
        return ()
    return (ax,) if isinstance(ax, str) else tuple(ax)


def _group(mesh_shape: dict, axes) -> int:
    return math.prod(mesh_shape[a] for a in axes)


def collective_bytes(
    *,
    mode: str,
    leaves,
    mesh_shape: dict,
    policy,
    act_bytes_per_boundary: float,
    n_boundaries: int,
) -> dict:
    """Per-device collective bytes of one step, by kind and by link.

    ``leaves``: ``(nbytes, spec)`` of every parameter leaf (global bytes,
    its per-dimension spec).  ``act_bytes_per_boundary``: the bytes of
    the device's ``[B, S, d]`` residual stream (all its microbatches);
    ``n_boundaries``: the mixers and FFNs of the model (one tensor-parallel
    all-reduce after each, each way).  See the module docstring."""
    out: dict[str, float] = defaultdict(float)
    link: dict[str, float] = defaultdict(float)
    k = policy.microbatches if mode == "train" else 1
    batch_axes = tuple(a for a in policy.batch_axes if a in mesh_shape)

    def put(kind: str, axes, nbytes: float) -> None:
        if nbytes <= 0:
            return
        out[kind] += nbytes
        for_model = policy.model_axis in axes
        link["nvlink" if for_model else "network"] += nbytes

    for nbytes, spec in leaves:
        used = [a for ax in (spec or ()) for a in _axes(ax)]
        fsdp = tuple(a for a in used if a in batch_axes)
        held = nbytes / _group(mesh_shape, [a for a in used if a not in fsdp])
        f = _group(mesh_shape, fsdp)
        if f > 1:
            gather = held * (f - 1) / f
            put("all-gather", fsdp, gather * (2 if mode == "train" else 1) * k)
            if mode == "train":
                put("reduce-scatter", fsdp, gather * k)
        if mode == "train":
            rest = tuple(a for a in batch_axes if a not in used)
            r = _group(mesh_shape, rest)
            if r > 1:
                put("all-reduce", rest, 2.0 * (held / f) * (r - 1) / r)
    m = mesh_shape.get(policy.model_axis, 1)
    tp = policy.tensor_parallel and policy.model_axis not in batch_axes and m > 1
    if tp:
        each_way = 2 if mode == "train" else 1
        per = 2.0 * act_bytes_per_boundary * (m - 1) / m
        put("all-reduce", (policy.model_axis,), per * n_boundaries * each_way)
    result = dict(out)
    result["total"] = float(sum(out.values()))
    result["by_link"] = dict(link)
    return result


# ---------------------------------------------------------------------------
# analytic HBM-traffic model (per device, per step)
# ---------------------------------------------------------------------------
def analytic_hbm_bytes(
    *,
    mode: str,
    param_bytes_dev: float,
    opt_bytes_dev: float,
    act_bytes_dev: float,
    cache_bytes_dev: float,
    io_bytes_dev: float,
) -> dict[str, float]:
    """Assumptions (documented in EXPERIMENTS.md §Roofline):
    train : params read fwd + read bwd + write; grads write+read;
            moments read+write; checkpointed activations write+read plus
            one recompute read (remat); batch io once.
    prefill: params read once; activations write once; io once.
    decode: params read once (the decode wall); cache read + small write.
    """
    if mode == "train":
        grads = 2 * param_bytes_dev  # grads ~ params
        total = (
            3 * param_bytes_dev
            + grads
            + 2 * opt_bytes_dev
            + 3 * act_bytes_dev
            + io_bytes_dev
        )
    elif mode == "prefill":
        total = param_bytes_dev + 2 * act_bytes_dev + cache_bytes_dev + io_bytes_dev
    else:  # decode
        total = param_bytes_dev + cache_bytes_dev + io_bytes_dev
    return {"total": float(total)}


__all__ = [
    "FlopCounter",
    "SavedBytes",
    "analytic_hbm_bytes",
    "collective_bytes",
    "count_flops",
]
