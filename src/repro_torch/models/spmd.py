"""The zoo on a ``(data, model)`` ``DeviceMesh``: the layout of one call,
and the collectives with their written-out transposes.

Each rank runs one process and holds plain local tensors: its block of
every parameter under ``models/sharding.py``'s rules and its part of
every activation.  The model issues the collectives itself, as autograd
functions whose backward is the transpose JAX gives the reference's
program (its GSPMD constraints and its ``shard_map``).  The convention
is JAX's: a tensor that is the same on every rank of an axis holds the
whole gradient on each of them, and a tensor that varies over an axis
(each rank its own rows, tokens, heads or partial sums) holds the
gradient of its own part.  So a collective that turns a varying tensor
into a replicated one (an all-gather, a sum) has a backward that takes
a part back (the rank's block, the gradient itself), and a replicated
tensor used where the computation varies (a weight, the stream entering
a tensor-parallel product) sums its gradient over the axes that vary.

One call's :class:`Layout` says how it is split:

* the rows (batch) over ``batch`` (the policy's batch axes, when the
  global batch divides over them; whole otherwise);
* the residual stream ``[B/d, S/m, D]`` sequence-sharded over ``model``
  in train and prefill when ``seq`` (the reference's ``act_spec``),
  ``[B/d, S, D]`` otherwise;
* tensor-parallel regions (column-parallel products, attention and MLA
  over the rank's heads, Mamba's, mLSTM's and sLSTM's recurrences over
  the rank's channels or heads, row-parallel products, the
  vocab-parallel embedding and logits) over ``model`` when ``tp``; a
  region whose width does not divide over ``model`` (heads, ``d_inner``,
  ``d_ff``, the vocabulary) runs whole on each rank;
* the decode caches as the reference's ``cache_pspec`` lays them out
  (``caches``): rows over the batch axes, heads, channels or the
  sequence over ``model``.  A cache held in sequence blocks is read by a
  split-K combine (:class:`SeqSplit`).

:func:`use` turns a rank's stored block of a weight into the block a
region computes with: an all-gather over each axis that splits it and
the region does not (FSDP's gather over ``data``; its backward a
reduce-scatter), a slice where the region wants a block the rank does
not store, and in the backward a sum over the axes the region varies
over but the stored block does not.

On a mesh every collective is issued, whatever its axis's size: a mesh
of one rank runs the whole sharded body over groups of one, so one card
drives every collective the multi-rank path issues.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import torch
import torch.distributed as dist

from repro_torch.models.sharding import ShardingPolicy, mesh_axes, mesh_coord

# the names ``all_gather_into_tensor`` and ``reduce_scatter_tensor`` took
# in newer PyTorch; either is the same collective
_ALL_GATHER = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_REDUCE_SCATTER = (
    getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor
)


# ---------------------------------------------------------------------------
# plain collectives (every buffer that enters one is made contiguous)
# ---------------------------------------------------------------------------
def group_size(group) -> int:
    return dist.get_world_size(group)


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous()  # a gradient may come transposed; blocks are rows
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The group's blocks of ``x`` concatenated along ``dim`` in rank order."""
    src = x.movedim(dim, 0).contiguous()
    out = src.new_empty((group_size(group) * src.shape[0], *src.shape[1:]))
    _ALL_GATHER(out, src, group=group)
    return out.movedim(0, dim).contiguous()


def reduce_scatter(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The sum of ``x`` over the group, this rank's block of ``dim``."""
    src = x.movedim(dim, 0).contiguous()
    out = src.new_empty((src.shape[0] // group_size(group), *src.shape[1:]))
    _REDUCE_SCATTER(out, src, group=group)
    return out.movedim(0, dim).contiguous()


def own_block(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's block of ``dim`` (a contiguous copy)."""
    size = x.shape[dim] // group_size(group)
    return x.narrow(dim, dist.get_rank(group) * size, size).contiguous()


def all_reduce(x: torch.Tensor, groups, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``x`` reduced over each group in turn (a new tensor)."""
    out = x.contiguous().clone()
    for group in groups:
        dist.all_reduce(out, op=op, group=group)
    return out


# ---------------------------------------------------------------------------
# collectives with their gradients
# ---------------------------------------------------------------------------
class _AllToAll(torch.autograd.Function):
    """``all_to_all_single`` of equal splits of dim 0 over ``group``: the
    reference's ``all_to_all(split_axis=0, concat_axis=0)``.  Block ``i``
    goes to rank ``i`` and block ``j`` of the result came from rank ``j``,
    so the exchange is its own transpose."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_to_all(g, ctx.group), None


class _Enter(torch.autograd.Function):
    """A replicated tensor entering a computation that varies over
    ``groups``: forward its block ``index`` (a tuple of slices; None: the
    whole tensor, a view), backward the block's gradient put back in place
    in zeros and summed over ``groups`` (JAX's transpose of ``pvary`` and
    a slice at the axis index)."""

    @staticmethod
    def forward(ctx, t, index, groups):
        ctx.shape, ctx.index, ctx.groups = t.shape, index, groups
        return t.view_as(t) if index is None else t[index].clone(memory_format=torch.contiguous_format)

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
    """All-gather along ``dim`` over ``group``.  ``reduce=False``: what
    follows runs identically on every rank of the group, so the backward
    is the rank's own block of the gradient.  ``reduce=True``: what
    follows varies over the group (FSDP's gather of weights each rank
    uses on its own rows; the sequence gathered into a tensor-parallel
    region); the backward is a reduce-scatter."""

    @staticmethod
    def forward(ctx, t, group, dim, reduce):
        ctx.group, ctx.dim, ctx.reduce = group, dim, reduce
        return all_gather(t, group, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.reduce:
            return reduce_scatter(g, ctx.group, ctx.dim), None, None, None
        return own_block(g, ctx.group, ctx.dim), None, None, None


class _ReduceScatter(torch.autograd.Function):
    """Partial sums reduce-scattered along ``dim`` over ``group`` (a
    row-parallel product's output onto the sequence-sharded stream); the
    backward all-gathers the blocks' gradients."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return reduce_scatter(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.group, ctx.dim), None, None


class _AllReduceSum(torch.autograd.Function):
    """``psum`` over ``group`` into a replicated result: the backward
    hands every rank the whole gradient (JAX's transpose of ``psum``)."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, (group,))

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Combine(torch.autograd.Function):
    """Partial sums over ``group`` into a sum that each rank then uses on
    its own part of a region (its channels, its heads): forward and
    backward both all-reduce (JAX's ``psum`` followed by ``pvary``)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x, (group,))

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, (ctx.group,)), None


class _Mean(torch.autograd.Function):
    """The mean of each rank's value over ``groups`` (``n`` ranks in all),
    replicated: the backward gives each rank ``1 / n`` of the gradient."""

    @staticmethod
    def forward(ctx, x, groups, n):
        ctx.n = n
        return all_reduce(x, groups) / n

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None, None


class _VocabLSE(torch.autograd.Function):
    """``logsumexp`` over the last dim of logits split over ``group`` along
    the vocabulary: the max and the sum of exponentials all-reduced.  The
    same operations as ``torch.logsumexp`` (max, ``exp(x - max)`` summed,
    log, max added back) and the same backward (``g * exp(x - lse)``), so
    a group of one gives its numbers bit for bit."""

    @staticmethod
    def forward(ctx, x, group):
        m = x.amax(-1, keepdim=True)
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
        m.masked_fill_(m.abs() == float("inf"), 0)
        s = (x - m).exp_().sum(-1)
        dist.all_reduce(s, group=group)
        lse = s.log_().add_(m[..., 0])
        ctx.save_for_backward(x, lse)
        return lse

    @staticmethod
    def backward(ctx, g):
        x, lse = ctx.saved_tensors
        return g[..., None] * (x - lse[..., None]).exp(), None


class _Use(torch.autograd.Function):
    """A stored weight block into a region's compute block (see
    :func:`use`): forward the gathers in order, then the narrow; backward
    the narrow's gradient put back in zeros, each gather's transpose in
    reverse order, and the sum over ``sums``."""

    @staticmethod
    def forward(ctx, w, gathers, narrow, sums):
        ctx.gathers, ctx.narrow, ctx.sums = gathers, narrow, sums
        out = w
        for dim, group, _ in gathers:
            out = all_gather(out, group, dim)
        ctx.shape = out.shape
        if narrow is not None:
            dim, pieces = narrow
            out = torch.cat([out.narrow(dim, a, n) for a, n in pieces], dim)
        return out.view_as(out) if out is w else out

    @staticmethod
    def backward(ctx, g):
        if ctx.narrow is not None:
            dim, pieces = ctx.narrow
            full = g.new_zeros(ctx.shape)
            at = 0
            for a, n in pieces:
                full.narrow(dim, a, n).copy_(g.narrow(dim, at, n))
                at += n
            g = full
        for dim, group, reduce in reversed(ctx.gathers):
            g = reduce_scatter(g, group, dim) if reduce else own_block(g, group, dim)
        if ctx.sums:
            g = all_reduce(g, ctx.sums)
        return g, None, None, None


# ---------------------------------------------------------------------------
# one call's layout
# ---------------------------------------------------------------------------
HOIST_PATTERNS = ("/ffn/wi/", "/ffn/wg/", "/ffn/wo/")


def axis_names(ax) -> tuple[str, ...]:
    """A spec entry (None, a name or a tuple of names) as a tuple."""
    if ax is None:
        return ()
    return (ax,) if isinstance(ax, str) else tuple(ax)


def hoisted(path: str) -> bool:
    """A dense-FFN leaf, gathered once outside the microbatch loop under
    ``hoist_dense_gathers`` (the reference's ``hoist_constrain``)."""
    return any(pat in "/" + path + "/" for pat in HOIST_PATTERNS)


@dataclass(frozen=True)
class Layout:
    """How one call splits over a ``(data, model)`` ``DeviceMesh``.

    ``specs``: each leaf's stored spec by path (a group leaf's without its
    stacked axis; a hoisted leaf's with the FSDP axes dropped: it arrives
    gathered).  ``batch``: the axes splitting the rows (empty: every rank
    has them all).  ``seq``: the stream sequence-sharded over ``model``.
    ``tp``: tensor-parallel regions over ``model``.  ``hoist``: the paths
    whose reduction over the FSDP axes waits for the train step.
    ``caches``: each decode-cache leaf's stored spec by path (a group
    leaf's without its stacked axis; empty in train mode)."""

    mesh: object
    policy: ShardingPolicy
    specs: dict
    batch: tuple[str, ...]
    seq: bool
    tp: bool
    hoist: frozenset = frozenset()
    caches: dict = field(default_factory=dict)

    @property
    def axes(self) -> dict[str, int]:
        return mesh_axes(self.mesh)

    @property
    def model(self) -> str:
        return self.policy.model_axis

    @property
    def n_model(self) -> int:
        return self.axes[self.model]

    def group(self, axis: str):
        return self.mesh.get_group(axis)

    def rank(self, axis: str) -> int:
        return self.mesh.get_local_rank(axis)

    def groups(self, axes) -> list:
        return [self.group(a) for a in axes]

    @property
    def vary_stream(self) -> tuple[str, ...]:
        """The axes the residual stream varies over."""
        return self.batch + ((self.model,) if self.seq else ())

    @property
    def vary_tp(self) -> tuple[str, ...]:
        """The axes a tensor-parallel region varies over."""
        return self.batch + (self.model,)

    @property
    def vary_whole(self) -> tuple[str, ...]:
        """The axes a region run whole on every model rank varies over."""
        return self.batch

    def rows(self, b: int) -> slice:
        """This rank's rows of a global batch of ``b``."""
        if not self.batch:
            return slice(0, b)
        i, n = mesh_coord(self.mesh, self.batch)
        return slice(i * (b // n), (i + 1) * (b // n))

    def seq_block(self, s: int) -> slice:
        """This rank's block of a sequence of ``s`` on the stream."""
        if not self.seq:
            return slice(0, s)
        n = self.n_model
        r = self.rank(self.model)
        return slice(r * (s // n), (r + 1) * (s // n))

    def block(self, width: int) -> tuple[int, int] | None:
        """``(start, size)`` of this rank's block of a tensor-parallel
        width, None where the region runs whole (no ``tp``, or ``width``
        does not divide over ``model``)."""
        if not self.tp or width % self.n_model:
            return None
        size = width // self.n_model
        return self.rank(self.model) * size, size

    def cache_dim(self, path: str) -> int | None:
        """The dimension of cache leaf ``path`` that ``model`` splits (past
        the rows), None where the leaf is whole over ``model``."""
        spec = self.caches[path]
        for dim in range(1, len(spec)):
            if self.model in axis_names(spec[dim]):
                return dim
        return None


def make_layout(
    mesh,
    policy: ShardingPolicy,
    specs: dict,
    *,
    batch: int,
    seq_len: int,
    mode: str,
    hoist: frozenset = frozenset(),
    cache_specs: dict | None = None,
) -> Layout:
    """The layout of a call on ``batch`` x ``seq_len`` global tokens.
    ``specs``: every leaf's stored spec by path (stacked leaves with their
    leading axis), ``models/sharding.py::param_specs``; ``cache_specs``
    the same of the decode caches (``stored_cache_specs``)."""
    axes = mesh_axes(mesh)
    for a in ("data", policy.model_axis):
        if a not in axes:
            raise ValueError(f"the zoo's mesh has axes (data, model), not {tuple(axes)}")
    bt = tuple(a for a in policy.batch_axes if a in axes)
    if batch % math.prod(axes[a] for a in bt):
        bt = ()  # rows the batch axes do not divide: every rank has them all
    tp = policy.tensor_parallel
    if tp and policy.model_axis in bt:
        raise ValueError("tensor parallelism over an axis that also splits the batch")
    seq = (
        policy.seq_shard
        and tp
        and mode in ("train", "prefill")
        and seq_len % axes[policy.model_axis] == 0
    )
    local = {}
    for path, spec in specs.items():
        if path in hoist:  # gathered over the FSDP axes: those dims whole
            fsdp = set(policy.fsdp_axes)
            spec = tuple(None if set(axis_names(a)) & fsdp else a for a in spec)
        local[path] = spec[1:] if path.startswith("groups/") else spec
    caches = {
        path: spec[1:] if path.startswith("groups/") else spec
        for path, spec in (cache_specs or {}).items()
    }
    return Layout(mesh, policy, local, bt, seq, tp, frozenset(hoist), caches)


# ---------------------------------------------------------------------------
# weights and the stream
# ---------------------------------------------------------------------------
def use(
    L: Layout,
    w: torch.Tensor,
    path: str,
    vary: tuple[str, ...],
    block: tuple[int, int, int] | None = None,
) -> torch.Tensor:
    """Leaf ``path``'s stored block ``w`` as a region computes with it:
    whole, or ``block = (dim, start, size)`` of it, or ``(dim, ((start,
    size), ...))``: those pieces of ``dim`` side by side (a rank's
    channels of both halves of Mamba's ``in_proj``, its heads of all four
    of sLSTM's gates).  The region varies over ``vary``.  Each axis that
    splits the stored block is gathered (its backward a reduce-scatter
    where the region varies over it, the rank's own block where it does
    not), except ``model`` on ``dim`` when the stored block is the one
    wanted; the wanted block is then cut out; the gradient is summed over
    the axes of ``vary`` the stored block is replicated over.  A hoisted
    leaf's sum over the FSDP axes is left to the train step."""
    spec = L.specs[path]
    if path in L.hoist:
        vary = tuple(a for a in vary if a not in L.policy.fsdp_axes)
    narrow = None
    if block is not None:
        pieces = block[1] if len(block) == 2 else (block[1:],)
        narrow = (block[0], tuple(tuple(p) for p in pieces))
    gathers, split = [], set()
    for dim, ax in enumerate(spec):
        names = axis_names(ax)
        split.update(names)
        if narrow is not None and dim == narrow[0] and names == (L.model,):
            if narrow[1] == ((L.rank(L.model) * w.shape[dim], w.shape[dim]),):
                narrow = None  # the stored block is the wanted one
                continue
        for a in reversed(names):
            gathers.append((dim, L.group(a), a in vary))
    sums = tuple(L.group(a) for a in vary if a not in split)
    return _Use.apply(w, tuple(gathers), narrow, sums)


def use_tree(L: Layout, p: dict, path: str, vary) -> dict:
    """Every leaf of ``p`` (at ``path``) whole, through :func:`use`."""
    return {
        k: use_tree(L, v, f"{path}/{k}", vary)
        if isinstance(v, dict)
        else use(L, v, f"{path}/{k}", vary)
        for k, v in p.items()
    }


def enter(x: torch.Tensor, L: Layout, tp: bool) -> torch.Tensor:
    """The stream ``[B/d, S(/m), D]`` into a region: the whole sequence.
    Sequence-sharded, it is all-gathered over ``model`` (backward: a
    reduce-scatter into a tensor-parallel region, the own block into a
    whole one); replicated, it enters a tensor-parallel region as is,
    its gradient summed over ``model``."""
    if L.seq:
        return _Gather.apply(x, L.group(L.model), 1, tp)
    if tp:
        return _Enter.apply(x, None, [L.group(L.model)])
    return x


def leave(y: torch.Tensor, L: Layout, partial: bool) -> torch.Tensor:
    """A region's output ``[B/d, S, D]`` back onto the stream: partial
    sums (a tensor-parallel region) reduce-scattered along the sequence
    or all-reduced; a whole region's output cut to the rank's block of
    the sequence, or kept."""
    m = L.group(L.model)
    if partial:
        return _ReduceScatter.apply(y, m, 1) if L.seq else _AllReduceSum.apply(y, m)
    if L.seq:
        return _Enter.apply(y, (slice(None), L.seq_block(y.shape[1])), [m])
    return y


def psum(x: torch.Tensor, L: Layout, axes) -> torch.Tensor:
    """``x`` summed over ``axes`` into a replicated value (backward: the
    gradient as is)."""
    for a in axes:
        x = _AllReduceSum.apply(x, L.group(a))
    return x


def vary_model(x: torch.Tensor, L: Layout) -> torch.Tensor:
    """A tensor the same on every model rank into a computation on each
    rank's own part (forward as is; backward the gradients summed over
    ``model``)."""
    return _Enter.apply(x, None, [L.group(L.model)])


def combine(x: torch.Tensor, L: Layout) -> torch.Tensor:
    """A row-parallel product's partial sums over ``model`` into the sum
    that each model rank then uses on its own channels or heads
    (Mamba's ``x_proj``, mLSTM's gates): the backward sums the ranks'
    gradients too."""
    return _Combine.apply(x, L.group(L.model))


def gather(x: torch.Tensor, L: Layout, dim: int, vary: bool) -> torch.Tensor:
    """A region's channel-split ``x`` whole along ``dim`` (an all-gather
    over ``model``): ``vary``, what follows runs on the rank's own part
    (a reduce-scatter backward); else it runs whole on every rank (the
    own block of the gradient)."""
    return _Gather.apply(x, L.group(L.model), dim, vary)


def own(x: torch.Tensor, L: Layout, dim: int, start: int, size: int) -> torch.Tensor:
    """Block ``[start, start + size)`` of ``dim`` of a tensor the same on
    every model rank, into a computation on the rank's own part (the
    backward puts the block's gradient back in zeros and sums it over
    ``model``)."""
    index = (slice(None),) * dim + (slice(start, start + size),)
    return _Enter.apply(x, index, [L.group(L.model)])


def reblock(t: torch.Tensor, L: Layout, have: int | None, want: int | None):
    """A cache leaf held split over ``model`` along ``have`` (None: whole)
    as the rank's block along ``want`` (None: whole): an all-gather and a
    cut, no gradient (decode and the prefill's hand-over)."""
    if have == want:
        return t
    m = L.group(L.model)
    if have is not None:
        t = all_gather(t, m, have)
    return t if want is None else own_block(t, m, want)


@dataclass(frozen=True)
class SeqSplit:
    """A decode cache held in blocks of the sequence over ``model`` (the
    reference's ``cache_pspec`` for MLA's latent cache, and for a kv
    cache whose heads do not divide): this rank's slots ``[start, start +
    size)``, and the split-K (flash-decoding) combine of attention over
    the blocks.  Each rank scores the whole query against its own slots;
    the softmax's max and sum and the weighted values are all-reduced
    over ``model``.  Decode takes no gradient: plain collectives.
    ``heads``: the rank's ``(first, count)`` of the gathered query's
    heads, None where the query is whole on every rank."""

    group: object
    start: int
    size: int
    heads: tuple[int, int] | None = None

    def write(self, cache, rows, slot, value) -> None:
        """``cache[rows[i], slot[i]] = value[i]`` at the global slots this
        rank holds (a select, so nothing waits for the host)."""
        mine = (slot >= self.start) & (slot < self.start + self.size)
        local = (slot - self.start).clamp(0, self.size - 1)
        keep = cache[rows, local]
        shape = (-1,) + (1,) * (keep.dim() - 1)
        cache[rows, local] = torch.where(mine.view(shape), value.to(keep.dtype), keep)

    def max(self, x: torch.Tensor) -> torch.Tensor:
        x = x.contiguous()
        dist.all_reduce(x, op=dist.ReduceOp.MAX, group=self.group)
        return x

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        x = x.contiguous()
        dist.all_reduce(x, group=self.group)
        return x

    def whole_heads(self, q: torch.Tensor, dim: int) -> torch.Tensor:
        return q if self.heads is None else all_gather(q, self.group, dim)

    def own_heads(self, y: torch.Tensor, dim: int) -> torch.Tensor:
        if self.heads is None:
            return y
        return y.narrow(dim, *self.heads).contiguous()


def seq_split(L: Layout, path: str, heads, cache_len: int) -> SeqSplit | None:
    """The :class:`SeqSplit` of attention cache ``path`` (its ``k`` or
    ``ckv``) if ``model`` splits it along the sequence, else None;
    ``cache_len``: the slots a rank holds."""
    if L.cache_dim(path) != 1:
        return None
    return SeqSplit(L.group(L.model), L.rank(L.model) * cache_len, cache_len, heads)


__all__ = [
    "HOIST_PATTERNS",
    "Layout",
    "SeqSplit",
    "all_gather",
    "all_reduce",
    "all_to_all",
    "axis_names",
    "combine",
    "enter",
    "gather",
    "group_size",
    "hoisted",
    "leave",
    "make_layout",
    "own",
    "own_block",
    "psum",
    "reblock",
    "reduce_scatter",
    "seq_split",
    "use",
    "use_tree",
    "vary_model",
]
