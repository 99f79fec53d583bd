"""Sharding policy: logical -> mesh rules for params, optimizer state and
caches, over a mesh *shape*.

The port of the reference's ``models/sharding.py``.  The rules are its
rules (2-D parameter sharding: tensor parallelism over ``model`` plus
FSDP over ``fsdp_axes``; a dimension that does not divide its axes falls
back to replication), applied to a mesh shape, an ordered ``{axis name:
size}`` dict (``launch/mesh.py``), so they need no device: the H100
planner (``launch/dryrun.py``) reads them to size each leaf per card.  A
``PartitionSpec`` is a plain tuple with one entry per dimension: ``None``,
an axis name, or a tuple of axis names.

The fleet's mesh (:class:`FleetMesh`, :func:`make_fleet_mesh`) keeps the
reference's rule: ``None`` when at most one device would join, and every
caller then runs the single-device path; otherwise a 1-D mesh whose
devices each hold a shard of the fleet engine's stacked agent axis
(:class:`FleetSharding` says which).  On a ``(data, model)``
``torch.distributed`` ``DeviceMesh`` each rank keeps its block of every
zoo parameter under these rules (:func:`shard_params`) and of every
decode cache under :func:`cache_pspec` (:func:`stored_cache_specs`), and
``models/spmd.py`` lays out the activations as the reference's
``act_spec``, ``_full_s`` and ``_make_wsc_ch`` do; :func:`gather_params`
puts whole params back together and :func:`global_norm` is the clip's
norm over the blocks.
"""

from __future__ import annotations

import fnmatch
import math
from dataclasses import dataclass

import torch
import torch.distributed as dist


FSDP = "__fsdp__"  # placeholder resolved to policy.fsdp_axes
MODEL = "model"
HEADQ = "__headq__"  # model axis iff cfg.n_heads divides it (else replicate)
HEADKV = "__headkv__"  # model axis iff cfg.n_kv_heads divides it
FLEET = "fleet"  # the stacked agent axis of the fleet engine


@dataclass(frozen=True)
class ShardingPolicy:
    """The reference's policy, field for field.  Every run reads
    ``loss_chunk``, ``microbatches`` and ``remat`` (the train step's
    ``chunked_xent`` chunk, gradient accumulation and per-layer
    rematerialisation); a run on a mesh also the layout
    fields (``batch_axes``, ``model_axis``, ``fsdp_axes``, ``seq_shard``,
    ``tensor_parallel``) and ``hoist_dense_gathers`` (the dense-FFN
    weights gathered once a step, not once a microbatch).  ``q_chunk``
    and ``kv_chunk`` are carried as in the reference, whose model does
    not read them either (its attention runs at their defaults, 512 and
    1024).  ``remat`` (default on, as in the reference): the train step
    checkpoints each group of layers and each block inside it
    (``models/model.py::forward``), and the planner walks the step so."""

    batch_axes: tuple[str, ...] = ("data",)
    model_axis: str = "model"
    fsdp_axes: tuple[str, ...] = ("data",)
    seq_shard: bool = True  # sequence-parallel activations at boundaries
    remat: bool = True  # per-layer-group activation checkpointing
    tensor_parallel: bool = True  # False: model axis carries batch (pure DP)
    q_chunk: int = 512
    kv_chunk: int = 1024
    loss_chunk: int = 2048
    microbatches: int = 1  # gradient accumulation (memory knob)
    hoist_dense_gathers: bool = False


# (pattern, per-dim template). First match wins. Templates use mesh-axis
# names or FSDP; dims beyond the template are replicated.
_RULES = [
    ("embed/tok", (MODEL, FSDP)),
    ("embed/head/w", (FSDP, MODEL)),
    ("*/wq/w", (FSDP, HEADQ)),
    ("*/wk/w", (FSDP, HEADKV)),
    ("*/wv/w", (FSDP, HEADKV)),
    ("*/wq/b", (HEADQ,)),
    ("*/wk/b", (HEADKV,)),
    ("*/wv/b", (HEADKV,)),
    ("*/wo/w", (HEADQ, FSDP)),
    ("*/wo/b", (None,)),
    ("*/wi/w", (FSDP, MODEL)),
    ("*/wg/w", (FSDP, MODEL)),
    ("*/wi/b", (MODEL,)),
    ("*/router", (None, None)),
    ("*/w1", (MODEL, FSDP, None)),
    ("*/w3", (MODEL, FSDP, None)),
    ("*/w2", (MODEL, None, FSDP)),
    ("*/in_proj/w", (FSDP, MODEL)),
    ("*/conv_w", (MODEL, None)),
    ("*/conv_b", (MODEL,)),
    ("*/x_proj/w", (MODEL, None)),
    ("*/dt_proj/w", (None, MODEL)),
    ("*/dt_proj/b", (MODEL,)),
    ("*/a_log", (MODEL, None)),
    ("*/d_skip", (MODEL,)),
    ("*/out_proj/w", (MODEL, FSDP)),
    ("*/w_if/w", (MODEL, None)),
    ("*/w_x/w", (FSDP, MODEL)),
    ("*/w_x/b", (MODEL,)),
    ("*/r_h", (None, MODEL, None, None)),
    ("*/ffn_up/w", (FSDP, MODEL)),
    ("*/ffn_down/w", (MODEL, FSDP)),
    ("*/w_dkv/w", (FSDP, None)),
    ("*/w_krope/w", (FSDP, None)),
    ("*/w_uk/w", (None, HEADQ)),
    ("*/w_uv/w", (None, HEADQ)),
    ("*/w_dq/w", (FSDP, None)),
    ("*/w_uq/w", (None, HEADQ)),
]


def axis_size(mesh_shape: dict[str, int], axes) -> int:
    """The number of devices ``axes`` (None, a name or a tuple) span."""
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    return math.prod(mesh_shape[a] for a in axes)


def leaf_pspec(
    path: str, shape, mesh_shape: dict[str, int], policy: ShardingPolicy, cfg=None
) -> tuple:
    """path: 'groups/b0/mixer/wq/w'. Leading 'groups/*' gets a stacked dim."""
    stacked = path.startswith("groups/")
    core_shape = shape[1:] if stacked else shape
    template = None
    for pat, tpl in _RULES:
        if fnmatch.fnmatch(path, pat):
            template = tpl
            break
    msize = mesh_shape[policy.model_axis]
    dims = []
    used: set = set()
    for i, size in enumerate(core_shape):
        ax = template[i] if template and i < len(template) else None
        if not policy.tensor_parallel and ax in (MODEL, HEADQ, HEADKV):
            ax = FSDP  # pure-DP: weights FSDP-shard, never TP
        if ax == FSDP:
            ax = (
                policy.fsdp_axes
                if len(policy.fsdp_axes) > 1
                else (policy.fsdp_axes[0] if policy.fsdp_axes else None)
            )
        elif ax == HEADQ:
            ok = cfg is None or cfg.n_heads % msize == 0
            ax = policy.model_axis if ok else None
        elif ax == HEADKV:
            ok = cfg is None or cfg.n_kv_heads % msize == 0
            ax = policy.model_axis if ok else None
        if ax is not None and size % axis_size(mesh_shape, ax) != 0:
            ax = None
        # a mesh axis may appear at most once per spec
        flat = (ax,) if (ax is None or isinstance(ax, str)) else tuple(ax)
        if ax is not None and any(a in used for a in flat):
            ax = None
        else:
            used.update(a for a in flat if a)
        dims.append(ax)
    if stacked:
        dims = [None] + dims
    return tuple(dims)


def _map_with_path(fn, tree, prefix: str = ""):
    """``fn(path, leaf)`` over a nested dict of tensors, ``path`` the keys
    joined by '/' (the reference's pytree path of a dict)."""
    if isinstance(tree, dict):
        return {
            k: _map_with_path(fn, v, f"{prefix}/{k}" if prefix else str(k))
            for k, v in tree.items()
        }
    return fn(prefix, tree)


def tree_pspecs(tree, mesh_shape: dict[str, int], policy: ShardingPolicy, cfg=None):
    """Nested dict of specs mirroring ``tree`` (of tensors)."""
    return _map_with_path(
        lambda path, leaf: leaf_pspec(path, tuple(leaf.shape), mesh_shape, policy, cfg),
        tree,
    )


def cache_pspec(
    path: str, shape, mesh_shape: dict[str, int], policy: ShardingPolicy
) -> tuple:
    """KV-cache / recurrent-state sharding.

    [B, S, H, D] k/v: batch->data; heads->model if divisible, else seq->model.
    latent/state tensors: batch->data, widest divisible dim->model.
    """
    batch = tuple(a for a in policy.batch_axes if a in mesh_shape)
    b_ax = batch if len(batch) > 1 else (batch[0] if batch else None)
    msize = mesh_shape[policy.model_axis]
    name = path.rsplit("/", 1)[-1]
    stacked = path.startswith("groups/")
    core = shape[1:] if stacked else shape
    if shape and core and core[0] % axis_size(mesh_shape, b_ax or ()) != 0:
        b_ax = None
    dims = [b_ax] + [None] * (len(core) - 1)
    if name in ("k", "v"):
        if core[2] % msize == 0:
            dims[2] = policy.model_axis
        elif core[1] % msize == 0:
            dims[1] = policy.model_axis
    elif name in ("ckv", "krope", "kpos"):
        if name != "kpos" and len(core) > 2 and core[1] % msize == 0:
            dims[1] = policy.model_axis
    elif name in ("ssm", "conv", "c", "n", "m", "h"):
        # shard the channel/head dim over model when divisible
        for i in range(1, len(core)):
            if core[i] % msize == 0 and core[i] >= msize:
                dims[i] = policy.model_axis
                break
    if stacked:
        dims = [None] + dims
    return tuple(dims)


def cache_shardings(tree, mesh_shape: dict[str, int], policy: ShardingPolicy):
    """Nested dict of :func:`cache_pspec` specs mirroring a cache ``tree``."""
    return _map_with_path(
        lambda path, leaf: cache_pspec(path, tuple(leaf.shape), mesh_shape, policy),
        tree,
    )


def stored_cache_specs(
    cfg, batch: int, seq_len: int, mesh_shape: dict, policy: ShardingPolicy
) -> dict:
    """``{path: spec}`` of every decode-cache leaf of ``cfg`` (``batch``
    rows, ``seq_len`` tokens) as a rank on a mesh of ``mesh_shape`` holds
    it: :func:`cache_pspec` at the global shapes, a stacked ``groups/...``
    leaf's spec with its leading group axis.  Without tensor parallelism
    ``model`` splits only the rows (``cache_pspec`` would name it twice)."""
    from repro_torch.models.model import META, init_caches

    specs: dict = {}

    def one(path, leaf):
        spec = cache_pspec(path, tuple(leaf.shape), mesh_shape, policy)
        if not policy.tensor_parallel:
            lead = 2 if path.startswith("groups/") else 1  # the rows' dim, then
            spec = spec[:lead] + tuple(
                None if a == policy.model_axis else a for a in spec[lead:]
            )
        specs[path] = spec

    _map_with_path(one, init_caches(cfg, batch, seq_len, META))
    return specs


# ---------------------------------------------------------------------------
# The zoo on a (data, model) DeviceMesh: each rank's blocks
# ---------------------------------------------------------------------------
def mesh_axes(mesh) -> dict[str, int]:
    """``{axis name: size}`` of a ``torch.distributed`` ``DeviceMesh``."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def mesh_coord(mesh, ax) -> tuple[int, int]:
    """(index, count) of this rank along ``ax``, an axis name or a tuple
    of them (row-major, as a spec's tuple splits a dimension)."""
    names = (ax,) if isinstance(ax, str) else tuple(ax)
    axes = mesh_axes(mesh)
    idx = 0
    for a in names:
        idx = idx * axes[a] + mesh.get_local_rank(a)
    return idx, axis_size(axes, names)


def take_slice(t: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """This rank's block of ``t`` under ``spec`` (one entry per dim: None,
    an axis name or a tuple of names): a copy of the block, or ``t``
    itself when every dim stays whole (a mesh of one rank keeps the
    tensors it was given)."""
    sliced = False
    for dim, ax in enumerate(spec):
        if ax is None:
            continue
        idx, n = mesh_coord(mesh, ax)
        if n > 1:
            size = t.shape[dim] // n
            t = t.narrow(dim, idx * size, size)
            sliced = True
    return t.clone() if sliced else t


def param_specs(cfg, mesh_shape: dict, policy: ShardingPolicy = ShardingPolicy()) -> dict:
    """``{path: stored spec}`` of every parameter of ``cfg`` (a stacked
    ``groups/...`` leaf's spec with its leading group axis), from the
    params' global shapes on ``meta``.  Raises for a config the mesh
    paths do not support (the KDA mixer, a held share of the experts)."""
    from repro_torch.configs.base import refuse_unplanned
    from repro_torch.models.model import meta_params

    refuse_unplanned(cfg, "the (data, model) mesh")
    specs: dict = {}

    def one(path, leaf):
        specs[path] = leaf_pspec(path, tuple(leaf.shape), mesh_shape, policy, cfg)

    _map_with_path(one, meta_params(cfg))
    return specs


def shard_params(cfg, params: dict, mesh, policy: ShardingPolicy = ShardingPolicy()):
    """A rank's own blocks of whole params on ``mesh``: every leaf under
    the reference's rules (:func:`leaf_pspec`: tensor parallel over
    ``model``, FSDP over ``data``).  A stacked ``[G, ...]`` leaf keeps its
    group axis whole."""
    axes = mesh_axes(mesh)

    def one(path, leaf):
        spec = leaf_pspec(path, tuple(leaf.shape), axes, policy, cfg)
        return take_slice(leaf, spec, mesh)

    return _map_with_path(one, params)


def gather_params(cfg, params: dict, mesh, policy: ShardingPolicy = ShardingPolicy()):
    """The whole params on every rank, all-gathered from the ranks' blocks
    (:func:`shard_params`'s inverse; no gradient)."""
    from repro_torch.models.spmd import all_gather, axis_names

    specs = param_specs(cfg, mesh_axes(mesh), policy)

    def one(path, leaf):
        for dim, ax in enumerate(specs[path]):
            for a in reversed(axis_names(ax)):
                leaf = all_gather(leaf, mesh.get_group(a), dim)
        return leaf

    with torch.no_grad():
        return _map_with_path(one, params)


def _sorted_items(tree, prefix: str = "") -> list:
    """``(path, leaf)`` in ``tree_leaves`` order (keys sorted)."""
    if isinstance(tree, dict):
        return [
            item
            for k in sorted(tree)
            for item in _sorted_items(tree[k], f"{prefix}/{k}" if prefix else str(k))
        ]
    return [(prefix, tree)]


def global_norm(grads: dict, mesh, policy: ShardingPolicy, cfg) -> torch.Tensor:
    """The global gradient norm of params held as :func:`shard_params`
    holds them: each leaf's float32 sum of squares summed over exactly
    the mesh axes that split it (a replicated leaf counts once), the
    leaves added in ``tree_leaves`` order as ``tree_global_norm`` adds
    them.  One all-reduce per axis for the leaves it splits."""
    from repro_torch.models.spmd import axis_names
    from repro_torch.optim.adamw import _chunks

    specs = param_specs(cfg, mesh_axes(mesh), policy)
    items = _sorted_items(grads)
    sq = [sum(c.float().square().sum() for c in _chunks(g)) for _, g in items]
    for a in mesh_axes(mesh):
        idx = [i for i, (path, _) in enumerate(items)
               if any(a in axis_names(ax) for ax in specs[path])]  # fmt: skip
        if idx:
            part = torch.stack([sq[i] for i in idx])
            dist.all_reduce(part, group=mesh.get_group(a))
            for j, i in enumerate(idx):
                sq[i] = part[j]
    total = 0
    for s in sq:
        total = total + s
    return torch.sqrt(total)


# ---------------------------------------------------------------------------
# Fleet-axis mesh
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class FleetMesh:
    """A 1-D device mesh for the fleet's stacked agent axis: the
    counterpart of the reference's 1-D ``jax.sharding.Mesh``.

    ``devices`` holds one entry per shard and may repeat a device: a
    mesh of ``(torch.device("cpu"),) * 8`` or ``(cuda:0,) * 4`` runs
    every part of the sharded path (the partition of slots, per-shard
    launches, gathers and scatters) on one device, which is how the
    tests and ``chip_smoke.py`` run it without several cards.  The size
    is a power of two, so the engine's pow2 capacities always divide
    it, and every device is of one type.  :func:`make_fleet_mesh` never
    builds a mesh of one device; the fleet engine keeps one internally
    for its single-device path."""

    devices: tuple[torch.device, ...]
    axis: str = FLEET

    def __post_init__(self):
        devices = tuple(torch.device(d) for d in self.devices)
        object.__setattr__(self, "devices", devices)
        n = len(devices)
        if n == 0 or n & (n - 1):
            raise ValueError(f"fleet mesh size must be a power of two, not {n}")
        if len({d.type for d in devices}) != 1:
            raise ValueError(f"a fleet mesh holds one type of device, not {devices}")

    @property
    def size(self) -> int:
        return len(self.devices)


def make_fleet_mesh(
    n_devices: int | None = None,
    *,
    axis: str = FLEET,
    device: str | torch.device | None = None,
) -> FleetMesh | None:
    """A 1-D mesh of the devices that ``device`` names, for the fleet's
    stacked agent axis: the reference's rule over them.

    ``device`` is the caller's device (``None`` = CUDA, as everywhere in
    the port): ``cuda`` names every visible card, ``cuda:i`` only card
    i, and ``cpu`` no card, so a CPU caller never gets a mesh.
    ``n_devices`` caps how many join (``None``/``-1`` = all of them);
    the count is rounded down to a power of two.  Returns ``None`` when
    at most one device would join, and callers then stay on the
    single-device path, so the call is safe on any host.  Nothing is
    allocated on the cards."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        count = 0
    elif dev.index is not None:
        count = 1
    else:
        count = torch.cuda.device_count()
    n = count if n_devices is None or n_devices < 0 else n_devices
    n = min(n, count)
    if n <= 1:
        return None
    n = 1 << (n.bit_length() - 1)  # pow2 floor
    return FleetMesh(tuple(torch.device("cuda", i) for i in range(n)), axis)


@dataclass(frozen=True)
class FleetSharding:
    """Where each slot of the fleet engine's stacked agent axis lives on
    a :class:`FleetMesh`: slot ``i`` is row ``i // n`` of shard
    ``i % n``, held by ``mesh.devices[i % n]``.

    The reference shards its capacity in contiguous blocks (``P(axis)``),
    so a slot's device there depends on the capacity and moves when the
    resident axis grows.  Round-robin placement gives each slot one
    device for its whole life: growth appends rows to every shard and
    moves no slot, so an agent's evaluation, its ERB copies and the
    serving snapshot never follow a moved slot.  The per-slot numbers
    are the same either way: no computation crosses slots."""

    mesh: FleetMesh

    @property
    def size(self) -> int:
        return self.mesh.size

    @property
    def devices(self) -> tuple[torch.device, ...]:
        return self.mesh.devices

    def shard_of(self, slot: int) -> int:
        return slot % self.mesh.size

    def row_of(self, slot: int) -> int:
        return slot // self.mesh.size

    def device_of(self, slot: int) -> torch.device:
        return self.mesh.devices[slot % self.mesh.size]

    def groups(self, slots) -> list[tuple[int, list[int], list[int]]]:
        """``(shard, positions, rows)`` for each shard that holds some of
        ``slots``, in shard order: ``positions`` index ``slots``, and
        ``rows`` are those slots' rows within the shard, in the same
        order."""
        n = self.mesh.size
        by: dict[int, tuple[list[int], list[int]]] = {}
        for pos, slot in enumerate(slots):
            positions, rows = by.setdefault(slot % n, ([], []))
            positions.append(pos)
            rows.append(slot // n)
        return [(j, *by[j]) for j in sorted(by)]

    def take(self, x: torch.Tensor, shard: int) -> torch.Tensor:
        """Shard ``shard``'s ``[capacity // n, ...]`` rows of a stacked
        ``[capacity, ...]`` tensor in slot order, on its device."""
        n = self.mesh.size
        dev = self.mesh.devices[shard]
        return x.to(dev) if n == 1 else x[shard::n].to(dev).contiguous()

    def gather(self, parts) -> torch.Tensor:
        """The inverse of :meth:`take`: every shard's rows interleaved
        back into slot order, on the mesh's first device."""
        if len(parts) == 1:
            return parts[0]
        home = self.mesh.devices[0]
        return torch.stack([p.to(home) for p in parts], 1).flatten(0, 1)


__all__ = [
    "FLEET",
    "FleetMesh",
    "FleetSharding",
    "ShardingPolicy",
    "axis_size",
    "cache_pspec",
    "cache_shardings",
    "gather_params",
    "global_norm",
    "leaf_pspec",
    "make_fleet_mesh",
    "mesh_axes",
    "mesh_coord",
    "param_specs",
    "shard_params",
    "stored_cache_specs",
    "take_slice",
    "tree_pspecs",
]
