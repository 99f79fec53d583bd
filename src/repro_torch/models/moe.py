"""Mixture-of-Experts FFN: a float32 softmax router, top-k gates and
capacity-based dispatch to a grouped SwiGLU, on one card or expert
parallel over a ``(data, model)`` :class:`~torch.distributed.device_mesh.DeviceMesh`.

Two things only the port has (``MoEConfig.router``, ``n_held``): the
sigmoid router of DeepSeek-V3 and Kimi-Linear (scores ``s = sigmoid(x
W_r)`` over every expert, the top-k chosen by ``s + bias``, a per-expert
leaf used only for the choice, the gates ``s`` of the chosen renormalised
and scaled by ``routed_scale``), and a held share: the layer holds
``n_held`` experts from ``held_offset`` (one card's share under expert
parallelism), routes over all ``n_experts`` with their capacity, and
computes the part of the result its own experts give.  Pairs routed to an
expert not held add nothing, and nothing stands in for the cards that
hold them; the shared experts run here whole.

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

With a mesh, the layer follows the reference's ``shard_map`` rules:
experts split over ``model`` (each rank holds ``E / n_model`` of them,
:func:`shard_moe_params`), and over ``data`` on their ``d_model`` axis
(FSDP) where it divides.  In the model (:func:`moe_stream`) the layer
takes the rank's own part of the residual stream, its rows and, in train
and prefill, its block of the sequence (``models/spmd.py``): those are
the expert-parallel path's tokens, so nothing is sliced on entry or
gathered on exit.  :func:`moe_apply` is the reference's layer on the
whole ``[B, S, D]`` on every rank: it slices the rank's tokens out and
gathers ``y`` back.  The collectives are ``models/spmd.py``'s autograd
functions, whose backward is the transpose JAX gives the reference's
``shard_map``: a replicated tensor's gradient is the whole gradient on
every rank.  A mesh rank runs on one device: ``gloo`` backs it on the
CPU, NCCL on the card.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import (
    mlp_apply,
    mlp_init,
    span,
    torch_dtype,
    truncated_normal,
)
from repro_torch.models.sharding import (
    ShardingPolicy,
    axis_size,
    leaf_pspec,
    mesh_axes,
    mesh_coord,
    take_slice,
)
from repro_torch.models.spmd import (
    _AllReduceSum,
    _AllToAll,
    _Enter,
    _Gather,
    _Mean,
    group_size as _group_size,
)
from repro_torch.models.spmd import all_to_all as _all_to_all  # noqa: F401

F32 = torch.float32
EXPERTS = ("w1", "w3", "w2")


def moe_init(cfg: ModelConfig, generator: torch.Generator) -> dict:
    m = cfg.moe
    dtype = torch_dtype(cfg.dtype)
    d, e, f = cfg.d_model, m.n_experts, m.d_ff_expert
    held = m.held
    p = {
        "router": truncated_normal((d, e), d**-0.5, F32, generator),
        "w1": truncated_normal((held, d, f), d**-0.5, dtype, generator),
        "w3": truncated_normal((held, d, f), d**-0.5, dtype, generator),
        "w2": truncated_normal((held, f, d), f**-0.5, dtype, generator),
    }
    if m.router == "sigmoid":  # the selection bias, zero at init
        p["bias"] = {"b": torch.zeros((e,), dtype=F32, device=generator.device)}
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
# the per-shard body
# ---------------------------------------------------------------------------
def _counts(idx: torch.Tensor, n: int) -> torch.Tensor:
    """How often each of ``0..n-1`` occurs in ``idx`` (int64 ``[n]``): a
    scatter-add of ones, as the reference's ``.at[idx].add(1)``, with a
    shape known before the data (the planner runs it on ``meta``)."""
    flat = idx.reshape(-1)
    return flat.new_zeros(n).scatter_add_(0, flat, torch.ones_like(flat))


def _route(cfg: ModelConfig, router_w: torch.Tensor, x_flat: torch.Tensor, bias=None):
    """x_flat [T, D] -> gates [T, k] (x's dtype), eidx [T, k], aux (f32):
    softmax in float32, top-k, gates renormalised, Switch's load-balance
    loss ``E * sum_e f_e * P_e``.  The sigmoid router (``bias`` [E], its
    selection bias): scores ``sigmoid`` in float32, the top-k by score
    plus bias, the chosen scores renormalised and scaled by
    ``routed_scale``; ``P_e`` of its loss the scores normalised over the
    experts."""
    m = cfg.moe
    if m.router == "sigmoid":
        scores = torch.sigmoid(x_flat.to(F32) @ router_w)  # [T, E]
        eidx = torch.topk(scores + bias, m.top_k, dim=-1).indices
        gates = scores.gather(-1, eidx)
        gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
        gates = gates * m.routed_scale
        probs = scores / scores.sum(-1, keepdim=True)
    else:
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
    bias=None,
):
    """The per-shard body (the reference's ``_moe_local``): x_flat
    ``[T_loc, D]``, ``w*`` the ``E_loc`` experts this rank holds;
    ``bias``: the sigmoid router's selection bias.
    Returns ``(y [T_loc, D], aux)``, ``aux`` this shard's own router loss
    (the caller averages it over the mesh).

    ``model``: the model axis's process group, or None (one shard, every
    expert here).  With it, ``seq_sharded=True`` takes the all-to-all
    branch (each rank's tokens differ): pairs scattered into an ``[E,
    C_loc, D]`` buffer, exchanged so each rank runs its ``E_loc`` experts
    over every source rank's rows, and exchanged back.  Otherwise the
    replicated branch: the tokens are the same on every model rank, each
    serves the pairs of its own experts (offset ``rank * E_loc``) and ``y``
    is summed over ``model``.  Without ``model``, the experts held are the
    config's share (``held_offset``; all of them by default).  Weights
    whose ``d_model`` axis is a slice
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
    gates, eidx, aux = _route(cfg, router_w, x_flat, bias)
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
        first = dist.get_rank(model) * e_loc if model is not None else m.held_offset
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
def _bias(p: dict):
    """The sigmoid router's selection bias, None for the softmax router."""
    return p["bias"]["b"] if "bias" in p else None


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


def _ep_ok(cfg: ModelConfig, axes: dict, bt: tuple, tp: bool) -> bool:
    """The reference's rule for the expert-parallel path: ``tp`` on, the
    rows split over batch axes in the mesh, a model axis over 1 that
    divides the experts."""
    n_model = axes.get("model", 1)
    return bool(tp and bt and n_model > 1 and not cfg.moe.n_experts % n_model)


def _moe_ep(cfg: ModelConfig, p: dict, xs: torch.Tensor, mesh, *, seq_sharded, tp):
    """The expert-parallel body on this rank's own tokens ``xs`` (its rows,
    and under sequence sharding its block of S): ``(y like xs, aux)``,
    ``aux`` the mean of every rank's router loss.  The router enters
    replicated (its gradient summed over the mesh); experts replicated
    over an axis other than model (data, unless FSDP splits them there)
    sum their gradients over it."""
    axes = mesh_axes(mesh)
    d = xs.shape[-1]
    world = [mesh.get_group(a) for a in axes]
    router = _Enter.apply(p["router"], None, world)
    fsdp = axes.get("data", 1) > 1 and d % axes["data"] == 0
    rep = [
        mesh.get_group(a)
        for a in axes
        if a != "model" and axes[a] > 1 and not (fsdp and a == "data")
    ]
    w1, w3, w2 = (_check_local(cfg, p, n, axes, tp) for n in EXPERTS)
    if rep:
        w1, w3, w2 = (_Enter.apply(w, None, rep) for w in (w1, w3, w2))
    data = mesh.get_group("data") if "data" in axes else None
    y, aux = moe_local(
        cfg, xs.reshape(-1, d), router, w1, w3, w2,
        seq_sharded=seq_sharded, model=mesh.get_group("model"), data=data,
        bias=_bias(p),
    )  # fmt: skip
    # the reference's pmean over model in the body, then over every axis:
    # one mean of each rank's own loss over the mesh
    return y.reshape(xs.shape), _Mean.apply(aux, world, math.prod(axes.values()))


def _refuse_unsharded(mode: str, s: int, n_model: int) -> None:
    raise ValueError(
        f"moe_apply: mode {mode!r} shards S={s} over model={n_model}; "
        "the reference's shard_map refuses an S it does not divide"
    )


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
    """x [B, S, D] -> (y [B, S, D], aux loss, a float32 scalar): the
    reference's ``moe_apply`` on the whole ``x``, the same on every rank.

    Without a mesh, the single-shard local path.  With one (a
    ``DeviceMesh`` whose dims include ``model``, ``p`` this rank's slice,
    :func:`shard_moe_params`), the reference's rules: the local path
    (every rank the same computation on the whole experts, gathered) when
    ``tp`` is off, no batch axis is in the mesh, the batch does not
    divide over the batch axes (a 1-token decode), the model axis is 1,
    or the experts do not divide over it.  Otherwise expert parallel:
    the layer slices this rank's tokens out of ``x`` (train and prefill
    shard S over ``model``: the all-to-all branch; an ``S`` that ``model``
    does not divide raises, as the reference's ``shard_map`` does for a
    replicated output its all-to-alls make vary; decode keeps the tokens
    replicated over ``model``: the psum branch) and gathers ``y`` back.
    ``aux`` is the mean of every rank's router loss.  The model itself
    calls :func:`moe_stream`, on its own part of the stream."""
    b, s, d = x.shape
    seq_sharded = mode in ("train", "prefill")
    axes = {} if mesh is None else mesh_axes(mesh)
    bt = tuple(a for a in batch_axes if a in axes)
    n_model = axes.get("model", 1)
    if bt and b % axis_size(axes, bt):
        bt = ()
    if mesh is None or not _ep_ok(cfg, axes, bt, tp):
        w1, w3, w2 = _whole_experts(cfg, p, mesh, tp)
        with span("moe.held"):
            y, aux = moe_local(
                cfg, x.reshape(-1, d), p["router"], w1, w3, w2, seq_sharded=False,
                bias=_bias(p),
            )  # fmt: skip
        y = y.reshape(b, s, d)
    else:
        if seq_sharded and s % n_model:
            _refuse_unsharded(mode, s, n_model)
        if "model" in bt:
            raise ValueError("moe_apply: the model axis cannot also split the batch")
        world = [mesh.get_group(a) for a in axes if axes[a] > 1]
        model = mesh.get_group("model")
        # this rank's tokens: its batch block, and under sequence sharding
        # its block of S
        bi, nb = mesh_coord(mesh, bt)
        index = [slice(bi * (b // nb), (bi + 1) * (b // nb)), slice(None)]
        if seq_sharded:
            mi = mesh.get_local_rank("model")
            index[1] = slice(mi * (s // n_model), (mi + 1) * (s // n_model))
        xs = _Enter.apply(x, tuple(index), world)
        y, aux = _moe_ep(cfg, p, xs, mesh, seq_sharded=seq_sharded, tp=tp)
        # exit: gather y back to [B, S, D] on every rank
        if seq_sharded:
            y = _Gather.apply(y, model, 1, False)
        for a in reversed(bt):
            if axes[a] > 1:
                y = _Gather.apply(y, mesh.get_group(a), 0, False)
    if cfg.moe.n_shared_experts:
        y = y + mlp_apply(cfg, p["shared"], x)
    return y, aux


def moe_stream(cfg: ModelConfig, p: dict, h: torch.Tensor, L, *, mode: str, path: str):
    """The MoE FFN on this rank's part of the stream ``h`` (``L``, a
    ``models/spmd.py::Layout``): ``(y like h, aux)``.  On the
    expert-parallel path (the reference's rule) the stream's own tokens
    are the rank's tokens: no slice on entry, no gather on exit.  Train
    and prefill need the stream sequence-sharded (an S that ``model``
    does not divide raises, as the reference does); decode's stream is
    replicated over ``model`` (the psum branch).  Otherwise the local
    path runs the reference's global computation: every token gathered
    on every rank, the whole experts, and the rank's block of ``y`` cut
    back out.  The shared experts are a tensor-parallel dense FFN on the
    stream."""
    from repro_torch.models.blocks import mlp_region

    n_model = L.n_model
    if _ep_ok(cfg, L.axes, L.batch, L.tp):
        seq_sharded = mode in ("train", "prefill")
        xs, s = h, h.shape[1]
        if seq_sharded and not L.seq:  # a replicated stream (seq_shard off)
            if s % n_model:
                _refuse_unsharded(mode, s, n_model)
            r, size = L.rank(L.model), s // n_model
            index = (slice(None), slice(r * size, (r + 1) * size))
            xs = _Enter.apply(h, index, [L.group(L.model)])
        y, aux = _moe_ep(cfg, p, xs, L.mesh, seq_sharded=seq_sharded, tp=L.tp)
        if xs is not h:
            y = _Gather.apply(y, L.group(L.model), 1, False)
    else:
        t = h
        if L.seq:
            t = _Gather.apply(t, L.group(L.model), 1, False)
        for a in reversed(L.batch):
            t = _Gather.apply(t, L.group(a), 0, False)
        b, s, d = t.shape
        w1, w3, w2 = _whole_experts(cfg, p, L.mesh, L.tp)
        y, aux = moe_local(
            cfg, t.reshape(-1, d), p["router"], w1, w3, w2, seq_sharded=False,
            bias=_bias(p),
        )  # fmt: skip
        index = (L.rows(b), L.seq_block(s))
        split = L.batch + ((L.model,) if L.seq else ())
        y = _Enter.apply(y.reshape(b, s, d), index, L.groups(split))
    if cfg.moe.n_shared_experts:
        y = y + mlp_region(cfg, p["shared"], h, L, f"{path}/shared")
    return y, aux


__all__ = [
    "EXPERTS",
    "capacity",
    "expert_spec",
    "moe_apply",
    "moe_init",
    "moe_local",
    "moe_stream",
    "shard_moe_params",
]
