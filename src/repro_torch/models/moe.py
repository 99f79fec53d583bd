"""Mixture-of-Experts FFN: a float32 softmax router, top-k gates and
capacity-based dispatch to a grouped SwiGLU, on one card or expert
parallel over a ``(data, model)`` :class:`~torch.distributed.device_mesh.DeviceMesh`.

The port of the reference's ``models/moe.py``.  Dispatch keeps its
capacity semantics.  Each expert takes at most ``C = max(1, ceil(top_k *
T * capacity_factor / E))`` of a shard's ``T * top_k`` (token, expert)
pairs, ``T`` the shard's own tokens, in token order (a stable sort ranks
them); an overflow pair is dropped and its token gets nothing from that
expert (only the shared experts, where the config has them).  JAX drops
an out-of-range scatter and clamps an out-of-range gather; torch raises
on both, so a dropped pair is scattered into one spare row past the
``[E, C, D]`` buffer and gathered from row 0 with a zero gate.  The
grouped SwiGLU runs every expert over its ``C`` rows, filled or not: the
reference's arithmetic, whatever the routing.

With a mesh, :func:`moe_apply` follows the reference's ``shard_map``
rules (``moe_apply``'s docstring): experts split over ``model`` (each
rank holds ``E / n_model`` of them, :func:`shard_moe_params`), and over
``data`` on their ``d_model`` axis (FSDP) where it divides.  The rest of
the model runs replicated on every rank, so the layer takes and returns
the whole ``[B, S, D]`` on each: it slices its rank's tokens on entry and
gathers ``y`` on exit.  The collectives are autograd functions whose
backward is the transpose the reference's ``shard_map`` gets from JAX for
a program replicated outside the layer: each rank's loss is the same
number, and a replicated tensor's gradient is the whole gradient on every
rank.  A mesh rank runs on one device: ``gloo`` backs it on the CPU,
NCCL on the card.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import mlp_apply, mlp_init, torch_dtype, truncated_normal
from repro_torch.models.sharding import (
    ShardingPolicy,
    axis_size,
    leaf_pspec,
    mesh_axes,
    mesh_coord,
    take_slice,
)

F32 = torch.float32
EXPERTS = ("w1", "w3", "w2")
# the names ``all_gather_into_tensor`` and ``reduce_scatter_tensor`` took
# in newer PyTorch; either is the same collective
_ALL_GATHER = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_REDUCE_SCATTER = (
    getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor
)


def moe_init(cfg: ModelConfig, generator: torch.Generator) -> dict:
    m = cfg.moe
    dtype = torch_dtype(cfg.dtype)
    d, e, f = cfg.d_model, m.n_experts, m.d_ff_expert
    p = {
        "router": truncated_normal((d, e), d**-0.5, F32, generator),
        "w1": truncated_normal((e, d, f), d**-0.5, dtype, generator),
        "w3": truncated_normal((e, d, f), d**-0.5, dtype, generator),
        "w2": truncated_normal((e, f, d), f**-0.5, dtype, generator),
    }
    if m.n_shared_experts:
        p["shared"] = mlp_init(cfg, d, m.n_shared_experts * f, generator)
    return p


def capacity(cfg: ModelConfig, n_tokens: int) -> int:
    """Rows each expert takes: ``max(1, ceil(top_k * T * cf / E))``,
    computed as the reference computes it."""
    m = cfg.moe
    return max(1, int(-(-m.top_k * n_tokens * m.capacity_factor // m.n_experts)))


# ---------------------------------------------------------------------------
# the mesh: axis sizes, the experts' layout, a rank's slice
# ---------------------------------------------------------------------------
def expert_shape(cfg: ModelConfig, name: str) -> tuple[int, int, int]:
    m = cfg.moe
    e, d, f = m.n_experts, cfg.d_model, m.d_ff_expert
    return (e, f, d) if name == "w2" else (e, d, f)


def expert_spec(cfg: ModelConfig, name: str, axes: dict, tp: bool = True) -> tuple:
    """The reference's layout of expert leaf ``name`` on a mesh of
    ``axes`` (``models/sharding.py``'s rules): ``(model, data, None)``
    for ``w1``/``w3`` and ``(model, None, data)`` for ``w2``, an axis
    dropped where it does not divide its dimension."""
    policy = ShardingPolicy(tensor_parallel=tp)
    return leaf_pspec(f"ffn/{name}", expert_shape(cfg, name), axes, policy, cfg)


def shard_moe_params(cfg: ModelConfig, p: dict, mesh, *, tp: bool = True) -> dict:
    """A rank's own slice of a whole MoE parameter dict: experts
    ``[r * E_loc:(r + 1) * E_loc]`` for its ``model`` coordinate ``r``,
    and under FSDP its ``d_model`` slice for its ``data`` coordinate; the
    router and the shared experts whole.  The rank then holds ``E_loc / E``
    (and ``1 / n_data`` under FSDP) of the expert bytes."""
    axes = mesh_axes(mesh)
    out = dict(p)
    for name in EXPERTS:
        out[name] = take_slice(p[name], expert_spec(cfg, name, axes, tp), mesh)
    return out


# ---------------------------------------------------------------------------
# collectives with their gradients
# ---------------------------------------------------------------------------
def _group_size(group) -> int:
    return dist.get_world_size(group)


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous()  # a gradient may come transposed; blocks are rows
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def _all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    src = x.movedim(dim, 0).contiguous()
    out = src.new_empty((_group_size(group) * src.shape[0], *src.shape[1:]))
    _ALL_GATHER(out, src, group=group)
    return out.movedim(0, dim).contiguous()


class _AllToAll(torch.autograd.Function):
    """``all_to_all_single`` of equal splits of dim 0 over ``group``: the
    reference's ``all_to_all(split_axis=0, concat_axis=0)``.  Block ``i``
    goes to rank ``i`` and block ``j`` of the result came from rank ``j``,
    so the exchange is its own transpose."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group), None


class _Enter(torch.autograd.Function):
    """A replicated tensor entering the per-rank body: forward its block
    ``index`` (a tuple of slices; None: the whole tensor, a view), backward
    the block's gradient put back in place in zeros and summed over
    ``groups``.  For the tokens this gathers the blocks the mesh split and
    sums where the ranks shared them (decode: each model rank's local
    experts give a part); for the router (under ``P()``) it is the
    ``psum`` JAX puts in the transpose of the broadcast; for experts
    replicated over ``data`` it sums the data ranks' gradients."""

    @staticmethod
    def forward(ctx, t, index, groups):
        ctx.shape, ctx.index, ctx.groups = t.shape, index, groups
        return t.view_as(t) if index is None else t[index].clone()

    @staticmethod
    def backward(ctx, g):
        if ctx.index is None:
            full = g.contiguous().clone()
        else:
            full = g.new_zeros(ctx.shape)
            full[ctx.index] = g
        for group in ctx.groups:
            dist.all_reduce(full, group=group)
        return full, None, None


class _Gather(torch.autograd.Function):
    """All-gather along ``dim`` over ``group``.  ``reduce=False``: the
    result is replicated and everything after it runs identically on
    every rank (``y`` on exit, the whole experts of the local path), so
    the backward is the rank's own block of the gradient, not a sum over
    ranks (``torch.distributed.nn``'s all-gather sums, which scales the
    gradient by the group size here).  ``reduce=True``: FSDP's gather of
    weights that each rank then uses on its own tokens; the backward is a
    reduce-scatter."""

    @staticmethod
    def forward(ctx, t, group, dim, reduce):
        ctx.group, ctx.dim, ctx.reduce = group, dim, reduce
        ctx.block = t.shape[dim]
        return _all_gather(t, group, dim)

    @staticmethod
    def backward(ctx, g):
        g0 = g.movedim(ctx.dim, 0).contiguous()
        if ctx.reduce:
            out = g0.new_empty((ctx.block, *g0.shape[1:]))
            _REDUCE_SCATTER(out, g0, group=ctx.group)
        else:
            out = g0.narrow(0, dist.get_rank(ctx.group) * ctx.block, ctx.block)
        return out.movedim(0, ctx.dim).contiguous(), None, None, None


class _AllReduceSum(torch.autograd.Function):
    """``psum`` over ``group`` into a replicated result: the backward
    hands every rank the whole gradient (JAX's transpose of ``psum``)."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Mean(torch.autograd.Function):
    """The mean of each rank's value over ``groups`` (``n`` ranks in all),
    replicated: the backward gives each rank ``1 / n`` of the gradient."""

    @staticmethod
    def forward(ctx, x, groups, n):
        ctx.n = n
        out = x.contiguous().clone()
        for group in groups:
            dist.all_reduce(out, group=group)
        return out / n

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None, None


# ---------------------------------------------------------------------------
# the per-shard body
# ---------------------------------------------------------------------------
def _counts(idx: torch.Tensor, n: int) -> torch.Tensor:
    """How often each of ``0..n-1`` occurs in ``idx`` (int64 ``[n]``): a
    scatter-add of ones, as the reference's ``.at[idx].add(1)``, with a
    shape known before the data (the planner runs it on ``meta``)."""
    flat = idx.reshape(-1)
    return flat.new_zeros(n).scatter_add_(0, flat, torch.ones_like(flat))


def _route(cfg: ModelConfig, router_w: torch.Tensor, x_flat: torch.Tensor):
    """x_flat [T, D] -> gates [T, k] (x's dtype), eidx [T, k], aux (f32):
    softmax in float32, top-k, gates renormalised, Switch's load-balance
    loss ``E * sum_e f_e * P_e``."""
    m = cfg.moe
    probs = torch.softmax(x_flat.to(F32) @ router_w, dim=-1)  # [T, E]
    gates, eidx = torch.topk(probs, m.top_k, dim=-1)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    pe = probs.mean(0)
    counts = _counts(eidx, m.n_experts)
    fe = counts.to(F32) * (1.0 / (x_flat.shape[0] * m.top_k))
    aux = m.n_experts * torch.sum(fe * pe)
    return gates.to(x_flat.dtype), eidx, aux


def _dispatch_indices(eidx: torch.Tensor, n_experts: int, cap: int):
    """Flattened pairs -> (expert, slot, keep): slots unique per expert and
    ranked in pair order (a stable sort); ``keep = slot < cap``."""
    e_flat = eidx.reshape(-1)
    order = torch.argsort(e_flat, stable=True)
    counts = _counts(e_flat, n_experts)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(e_flat.numel(), device=e_flat.device) - starts[e_flat[order]]
    slot = torch.empty_like(rank)
    slot[order] = rank  # back to pair order
    return e_flat, slot, slot < cap


def _expert_ffn(w1, w3, w2, buf: torch.Tensor) -> torch.Tensor:
    """buf [E, C, D] -> [E, C, D]: a SwiGLU per expert (batched products)."""
    h = F.silu(torch.bmm(buf, w1)) * torch.bmm(buf, w3)
    return torch.bmm(h, w2)


def moe_local(
    cfg: ModelConfig,
    x_flat: torch.Tensor,
    router_w: torch.Tensor,
    w1: torch.Tensor,
    w3: torch.Tensor,
    w2: torch.Tensor,
    *,
    seq_sharded: bool,
    model=None,
    data=None,
):
    """The per-shard body (the reference's ``_moe_local``): x_flat
    ``[T_loc, D]``, ``w*`` the ``E_loc`` experts this rank holds.
    Returns ``(y [T_loc, D], aux)``, ``aux`` this shard's own router loss
    (the caller averages it over the mesh).

    ``model``: the model axis's process group, or None (one shard, every
    expert here).  With it, ``seq_sharded=True`` takes the all-to-all
    branch (each rank's tokens differ): pairs scattered into an ``[E,
    C_loc, D]`` buffer, exchanged so each rank runs its ``E_loc`` experts
    over every source rank's rows, and exchanged back.  Otherwise the
    replicated branch: the tokens are the same on every model rank, each
    serves the pairs of its own experts (offset ``rank * E_loc``) and ``y``
    is summed over ``model``.  Weights whose ``d_model`` axis is a slice
    (FSDP) are gathered over ``data`` here, so the whole copies live only
    inside the layer."""
    m = cfg.moe
    t, d = x_flat.shape
    k, e = m.top_k, m.n_experts
    e_loc = w1.shape[0]
    if w1.shape[1] != d:
        w1 = _Gather.apply(w1, data, 1, True)
        w3 = _Gather.apply(w3, data, 1, True)
        w2 = _Gather.apply(w2, data, 2, True)
    cap = capacity(cfg, t)
    gates, eidx, aux = _route(cfg, router_w, x_flat)
    e_flat, slot, keep = _dispatch_indices(eidx, e, cap)
    pairs = x_flat.repeat_interleave(k, dim=0)  # pair (t, j) is row t * k + j
    if seq_sharded and model is not None:
        n = _group_size(model)
        # row of each pair in the flat [E * C (+ 1 spare), D] send buffer
        row = torch.where(keep, e_flat * cap + slot, e * cap)
        buf = x_flat.new_zeros((e * cap + 1, d))
        buf[row] = pairs
        # [E, C, D] = [n, E_loc, C, D]: block i to rank i, which holds
        # experts [i * E_loc, (i + 1) * E_loc); back: [n sources, E_loc, C, D]
        recv = _AllToAll.apply(buf[: e * cap].view(n, e_loc, cap, d), model)
        out = _expert_ffn(w1, w3, w2, recv.transpose(0, 1).reshape(e_loc, n * cap, d))
        out = out.view(e_loc, n, cap, d).transpose(0, 1).contiguous()
        back = _AllToAll.apply(out, model).view(e * cap, d)  # on the source
        w = gates.reshape(-1, 1) * keep[:, None].to(gates.dtype)
        y_pairs = back[torch.where(keep, row, 0)] * w
    else:
        first = dist.get_rank(model) * e_loc if model is not None else 0
        e_rel = e_flat - first
        local = (e_rel >= 0) & (e_rel < e_loc) & keep
        # row of each pair in the flat [E_loc * C (+ 1 spare), D] buffer
        row = torch.where(local, e_rel * cap + slot, e_loc * cap)
        buf = x_flat.new_zeros((e_loc * cap + 1, d))
        buf[row] = pairs
        out = _expert_ffn(w1, w3, w2, buf[: e_loc * cap].view(e_loc, cap, d))
        w = gates.reshape(-1, 1) * local[:, None].to(gates.dtype)
        y_pairs = out.view(e_loc * cap, d)[torch.where(local, row, 0)] * w
    y = y_pairs.view(t, k, d).sum(1)
    if model is not None and not seq_sharded:
        y = _AllReduceSum.apply(y, model)
    return y, aux


# ---------------------------------------------------------------------------
# public entry
# ---------------------------------------------------------------------------
def _whole_experts(cfg: ModelConfig, p: dict, mesh, tp: bool):
    """The whole ``w1, w3, w2`` for the local path: a rank's slices
    gathered over the axes their layout split (the computation after is
    the same on every rank, so each gets its own block's gradient)."""
    if mesh is None:
        return [p[name] for name in EXPERTS]
    axes = mesh_axes(mesh)
    out = []
    for name in EXPERTS:
        w = _check_local(cfg, p, name, axes, tp)
        for dim, ax in enumerate(expert_spec(cfg, name, axes, tp)):
            for a in reversed((ax,) if isinstance(ax, str) else ax or ()):
                if axes[a] > 1:
                    w = _Gather.apply(w, mesh.get_group(a), dim, False)
        out.append(w)
    return out


def _check_local(cfg: ModelConfig, p: dict, name: str, axes: dict, tp: bool):
    spec = expert_spec(cfg, name, axes, tp)
    want = tuple(
        size // axis_size(axes, ax)
        for size, ax in zip(expert_shape(cfg, name), spec, strict=True)
    )
    if tuple(p[name].shape) != want:
        raise ValueError(
            f"moe_apply: {name} is {tuple(p[name].shape)} on this rank, its "
            f"slice on the mesh is {want} (shard_moe_params)"
        )
    return p[name]


def moe_apply(
    cfg: ModelConfig,
    p: dict,
    x: torch.Tensor,
    *,
    mesh=None,
    batch_axes: tuple[str, ...] = ("data",),
    mode: str = "train",
    tp: bool = True,
):
    """x [B, S, D] -> (y [B, S, D], aux loss, a float32 scalar).

    Without a mesh, the single-shard local path.  With one (a
    ``DeviceMesh`` whose dims include ``model``, ``p`` this rank's slice,
    :func:`shard_moe_params`), the reference's rules: the local path
    (every rank the same computation on the whole experts, gathered) when
    ``tp`` is off, no batch axis is in the mesh, the batch does not
    divide over the batch axes (a 1-token decode), the model axis is 1,
    or the experts do not divide over it.  Otherwise expert parallel:
    train and prefill sequence-shard the tokens over ``model`` (the
    all-to-all branch; an ``S`` that ``model`` does not divide raises, as
    the reference's ``shard_map`` does for a replicated output its
    all-to-alls make vary); decode keeps them replicated over ``model``
    (the psum branch).  ``aux`` is the mean of every rank's router loss."""
    m = cfg.moe
    b, s, d = x.shape
    seq_sharded = mode in ("train", "prefill")
    axes = {} if mesh is None else mesh_axes(mesh)
    bt = tuple(a for a in batch_axes if a in axes)
    n_model = axes.get("model", 1)
    if (
        mesh is None
        or not tp
        or not bt
        or b % axis_size(axes, bt)
        or n_model == 1
        or m.n_experts % n_model
    ):
        w1, w3, w2 = _whole_experts(cfg, p, mesh, tp)
        y, aux = moe_local(
            cfg, x.reshape(-1, d), p["router"], w1, w3, w2, seq_sharded=False
        )
        y = y.reshape(b, s, d)
    else:
        if seq_sharded and s % n_model:
            raise ValueError(
                f"moe_apply: mode {mode!r} shards S={s} over model={n_model}; "
                "the reference's shard_map refuses an S it does not divide"
            )
        if "model" in bt:
            raise ValueError("moe_apply: the model axis cannot also split the batch")
        world = [mesh.get_group(a) for a in axes if axes[a] > 1]
        model = mesh.get_group("model")
        data = mesh.get_group("data") if "data" in axes else None
        # this rank's tokens: its batch block, and under sequence sharding
        # its block of S
        bi, nb = mesh_coord(mesh, bt)
        index = [slice(bi * (b // nb), (bi + 1) * (b // nb)), slice(None)]
        if seq_sharded:
            mi = mesh.get_local_rank("model")
            index[1] = slice(mi * (s // n_model), (mi + 1) * (s // n_model))
        xs = _Enter.apply(x, tuple(index), world)
        router = _Enter.apply(p["router"], None, world)
        fsdp = axes.get("data", 1) > 1 and d % axes["data"] == 0
        # experts replicated over an axis other than model (data, unless
        # FSDP splits them there) sum their gradients over it
        rep = [
            mesh.get_group(a)
            for a in axes
            if a != "model" and axes[a] > 1 and not (fsdp and a == "data")
        ]
        w1, w3, w2 = (_check_local(cfg, p, n, axes, tp) for n in EXPERTS)
        if rep:
            w1, w3, w2 = (_Enter.apply(w, None, rep) for w in (w1, w3, w2))
        y, aux = moe_local(
            cfg, xs.reshape(-1, d), router, w1, w3, w2,
            seq_sharded=seq_sharded, model=model, data=data,
        )  # fmt: skip
        y = y.reshape(xs.shape)
        # exit: gather y back to [B, S, D] on every rank
        if seq_sharded:
            y = _Gather.apply(y, model, 1, False)
        for a in reversed(bt):
            if axes[a] > 1:
                y = _Gather.apply(y, mesh.get_group(a), 0, False)
        # the reference's pmean over model in the body, then over every
        # axis: one mean of each rank's own loss over the mesh
        aux = _Mean.apply(aux, world, math.prod(axes.values()))
    if m.n_shared_experts:
        y = y + mlp_apply(cfg, p["shared"], x)
    return y, aux


__all__ = [
    "EXPERTS",
    "capacity",
    "expert_spec",
    "moe_apply",
    "moe_init",
    "moe_local",
    "shard_moe_params",
]
