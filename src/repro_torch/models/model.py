"""Model assembly: init, caches, forward, the loss and the train step,
prefill and decode.

The port of the reference's ``models/model.py``.  The parameter layout is
the reference's: the per-group leaves are stacked on a leading ``[G, ...]``
axis, so converting reference params is a dtype change, and ``forward``
loops over the groups in Python where the reference scans.  Of the
reference's ``ShardingPolicy`` (``models/sharding.py``) the train step
reads ``loss_chunk``, ``microbatches``, ``remat`` and, on a mesh, the
layout fields (``batch_axes``, ``fsdp_axes``, ``seq_shard``,
``tensor_parallel``, ``hoist_dense_gathers``).  Under ``remat`` (the
default) the train step rematerialises as the reference does: each
group of layers is checkpointed, and each block inside it again, so the
backward keeps one residual-stream tensor a group and recomputes the
rest (:func:`forward`).  Training attends through ``chunked_attention``
(``attn_impl="chunked"``), as the reference trains through its XLA path;
serving's prefill through the ``flash_attention`` kernel.

``mesh=`` (a ``(data, model)`` ``torch.distributed`` ``DeviceMesh``, one
process a rank) runs the reference's sharded program with explicit
collectives (``models/spmd.py``).  Each rank holds its block of every
parameter (:func:`~repro_torch.models.sharding.shard_params`: tensor
parallel over ``model``, FSDP over ``data``) and of the optimizer state,
and of every decode cache (``cache_pspec``).  The
steps take the global batch on every rank and each keeps its rows; the
residual stream is batch-sharded over the batch axes and, in train and
prefill, sequence-sharded over ``model`` (``act_spec``); the sequence is
all-gathered at each mixer and FFN entry (``_full_s``); logits are
vocab-sharded over ``model`` and the cross entropy is vocab parallel,
normalised by the global token count.  Prefill and decode return the
whole logits on every rank.

Decode graphs: on a card, without a mesh and outside ``named_ranges()``,
``launch/serve.py::generate`` decodes into caches of a
:class:`DecodeArena` (one a ``Model``), and ``serve_step`` replays a
captured CUDA graph of the whole step for them in place of eager
dispatch, one graph per (batch, cache length).  Any other caches run the
step eagerly.  ``make_serve_step.steps_by_route`` counts the process's
decode steps by route.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import FFN_DENSE, ModelConfig
from repro_torch.device import resolve_device
from repro_torch.kernels import graphs
from repro_torch.models import hyper
from repro_torch.models import rope as rope_lib
from repro_torch.models.blocks import block_apply, block_cache_init, block_init
from repro_torch.models.layers import (
    embed_apply,
    embed_init,
    norm_apply,
    norm_init,
    ranges_on,
    torch_dtype,
    unembed_apply,
)
from repro_torch.models.sharding import (
    ShardingPolicy,
    _map_with_path,
    gather_params,
    global_norm,
    mesh_axes,
    param_specs,
    shard_params,
    stored_cache_specs,
    take_slice,
)
from repro_torch.models.spmd import (
    _AllReduceSum,
    _VocabLSE,
    all_gather,
    all_reduce,
    axis_names,
    enter,
    hoisted,
    leave,
    make_layout,
    own_block,
    psum,
    reduce_scatter,
    use,
    use_tree,
)
from repro_torch.optim.adamw import (
    AdamWConfig,
    tree_adamw_init,
    tree_adamw_update,
    tree_leaves,
)

F32 = torch.float32
META = torch.device("meta")


def _stack(trees: list) -> Any:
    """Stack a list of same-shaped nested dicts of tensors leaf by leaf."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _index(tree: Any, g: int) -> Any:
    """Leaf ``[g]`` of every tensor of a nested dict (views, not copies)."""
    if isinstance(tree, dict):
        return {k: _index(v, g) for k, v in tree.items()}
    return tree[g]


def _unbind(tree: Any, n: int) -> list:
    """The ``n`` per-group trees of a ``[G, ...]``-stacked nested dict, as
    views.  One ``unbind`` a leaf: under autograd each leaf's G gradients
    come back in one stack, where indexing group by group would build a
    full-size gradient for every group."""
    if isinstance(tree, dict):
        parts = {k: _unbind(v, n) for k, v in tree.items()}
        return [{k: parts[k][g] for k in parts} for g in range(n)]
    return tree.unbind(0)


def _stacked_empty(tree: Any, n: int) -> Any:
    """Uninitialised ``[n, ...]`` leaves shaped like ``tree``'s."""
    if isinstance(tree, dict):
        return {k: _stacked_empty(v, n) for k, v in tree.items()}
    return tree.new_empty((n, *tree.shape))


def _put(dst: Any, src: Any, g: int) -> None:
    """Copy every leaf of ``src`` into slice ``[g]`` of ``dst``'s."""
    if isinstance(dst, dict):
        for k in dst:
            _put(dst[k], src[k], g)
    else:
        dst[g].copy_(src)


def _tree_map(fn, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _tree_from_leaves(like: Any, leaves) -> Any:
    """``like``'s structure filled from ``leaves`` in :func:`tree_leaves`
    order (an iterator, consumed)."""
    if isinstance(like, dict):
        return {k: _tree_from_leaves(like[k], leaves) for k in sorted(like)}
    return next(leaves)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
class _MetaGenerator(torch.Generator):
    """A generator whose ``device`` is ``meta``: the zoo's inits allocate
    on ``generator.device``, so under it they build ``meta`` leaves and
    draw nothing."""

    @property
    def device(self) -> torch.device:
        return META


def meta_params(cfg: ModelConfig) -> dict[str, Any]:
    """The params of ``cfg`` as ``meta`` tensors at their global shapes."""
    return init_params(cfg, _MetaGenerator())


def init_params(
    cfg: ModelConfig, generator: torch.Generator, shard=None
) -> dict[str, Any]:
    """Fresh params on the generator's device, with the reference's names,
    shapes and init scales (its distributions, not its bits): the
    unrolled dense prefix (``first_k_dense`` layers of ``prefix_mixer``,
    attention but for Kimi-Linear's KDA, and a dense FFN of
    ``first_k_dense_d_ff``) as ``prefix/l{i}``, then the groups, then the
    unrolled ``suffix`` layers as ``suffix/l{i}`` (Kimi-Linear's last
    two).  Each stacked ``[G, ...]`` leaf is allocated once and group
    ``g`` is drawn into slice ``[g]``, groups in order, so the peak holds
    the params and one group more (not twice the params); a single group
    (jamba cut to 4 layers) is its own ``[1, ...]`` view; a config with no
    group (the planner's walk of the layers outside them) gets ``{}``.

    ``shard(path, leaf)``: the block to keep of each freshly drawn leaf
    (a group's leaf one group at a time), so a mesh rank holds only its
    blocks and one group's whole leaves at a time; the numbers are the
    whole init's, sliced."""
    if shard is None:

        def shard(path, leaf):
            return leaf

    def kept(tree, prefix):
        return _map_with_path(shard, tree, prefix)

    params: dict[str, Any] = {
        "embed": kept(embed_init(cfg, generator), "embed"),
        "final_norm": kept(
            norm_init(cfg, cfg.d_model, generator.device), "final_norm"
        ),
    }
    if cfg.first_k_dense:
        d_ff = cfg.first_k_dense_d_ff or cfg.d_ff
        params["prefix"] = {
            f"l{i}": kept(
                block_init(cfg, cfg.prefix_mixer, FFN_DENSE, generator, d_ff=d_ff),
                f"prefix/l{i}",
            )
            for i in range(cfg.first_k_dense)
        }
    groups = None
    for g in range(cfg.n_groups):
        one = {
            f"b{j}": block_init(cfg, mixer, ffn, generator)
            for j, (mixer, ffn) in enumerate(cfg.pattern)
        }
        one = kept(one, "groups")
        if cfg.n_groups == 1:  # a [1, ...] view: no second copy of the params
            groups = _tree_map(lambda t: t[None], one)
            break
        if groups is None:
            groups = _stacked_empty(one, cfg.n_groups)
        _put(groups, one, g)
        del one
    params["groups"] = groups if groups is not None else {}
    if cfg.suffix:
        params["suffix"] = {
            f"l{i}": kept(block_init(cfg, mixer, ffn, generator), f"suffix/l{i}")
            for i, (mixer, ffn) in enumerate(cfg.suffix)
        }
    return params


def cache_len_for(cfg: ModelConfig, seq_len: int) -> int:
    if cfg.sliding_window is not None:
        return min(seq_len, cfg.sliding_window)
    return seq_len


def init_caches(
    cfg: ModelConfig, batch: int, seq_len: int, device, shard=None
) -> dict[str, Any]:
    """Empty decode caches of ``batch`` rows for ``seq_len`` tokens
    (ring-buffer length for SWA models; a recurrent mixer's state has no
    length): the prefix's per layer, the groups' stacked ``[G, ...]`` like
    the params.  ``shard(path, leaf)``: the block to keep of each layer's
    leaf (a group's before stacking), as :func:`init_params` takes it."""
    dtype = torch_dtype(cfg.dtype)
    clen = cache_len_for(cfg, seq_len)

    def kept(tree, prefix):
        return tree if shard is None else _map_with_path(shard, tree, prefix)

    caches: dict[str, Any] = {}
    if cfg.first_k_dense:
        caches["prefix"] = {
            f"l{i}": kept(
                block_cache_init(cfg, cfg.prefix_mixer, batch, clen, dtype, device),
                f"prefix/l{i}",
            )
            for i in range(cfg.first_k_dense)
        }
    one = {
        f"b{j}": block_cache_init(cfg, mixer, batch, clen, dtype, device)
        for j, (mixer, _) in enumerate(cfg.pattern)
    }
    one = kept(one, "groups")
    groups = _stacked_empty(one, cfg.n_groups)
    for g in range(cfg.n_groups):
        _put(groups, one, g)
    caches["groups"] = groups
    if cfg.suffix:
        caches["suffix"] = {
            f"l{i}": kept(
                block_cache_init(cfg, mixer, batch, clen, dtype, device), f"suffix/l{i}"
            )
            for i, (mixer, _) in enumerate(cfg.suffix)
        }
    return caches


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------
def forward(
    cfg: ModelConfig,
    params: dict[str, Any],
    inputs: torch.Tensor,
    positions: torch.Tensor,
    *,
    mode: str,
    caches: dict[str, Any] | None = None,
    attn_impl: str = "kernel",
    layout=None,
    remat: bool = False,
):
    """inputs: tokens [B,S] int or embeds [B,S,D]; positions [B,S] (or
    M-RoPE's [3,B,S]).

    With ``cfg.hc_mult`` the embedding is copied into the mHC stream's
    rows, every block runs on that stream and its rows are summed before
    the final norm (``models/hyper.py``).

    Returns (hidden [B,S,D], aux, caches): ``aux`` is the sum of the MoE
    layers' router losses (a float32 scalar, 0 without MoE); the caches
    are, in prefill mode, the ones to hand to decode (kv caches and
    recurrent states, stacked per group), in decode mode ``caches``
    written in place (a recurrent mixer's new state copied into its
    group's slice), in train mode (the teacher-forced forward) None.
    ``attn_impl``: ``"kernel"`` (serving) or ``"chunked"`` (training; see
    ``attention.gqa_apply``).

    ``layout`` (``models/spmd.py::Layout``): on a mesh, ``inputs`` and
    ``positions`` are this rank's rows, ``params`` and ``caches`` its
    blocks, and ``hidden`` its part of the stream (``[B/d, S/m, D]``
    where the stream is sequence-sharded).

    ``remat`` (``ShardingPolicy.remat``; read in train mode under
    autograd only): each group runs inside one non-reentrant checkpoint
    and each of its blocks inside another, the reference's
    ``jax.checkpoint`` of the scanned group body around one of every
    block.  The backward then holds each group's input and recomputes
    the group's blocks but the last (the checkpoint's early stop: the
    group's recompute ends where the last block's input is saved), then
    each block's internals while its own backward runs.  The dense prefix
    and the final norm stay outside, as in the reference."""
    L = layout
    if inputs.dtype in (torch.int32, torch.int64):
        if L is None:
            x = embed_apply(params["embed"], inputs)
        else:
            x = _embed_on_mesh(cfg, params["embed"], inputs, L)
    else:
        x = inputs.to(torch_dtype(cfg.dtype))
        if L is not None:
            x = x[:, L.seq_block(x.shape[1])]
        x = x.contiguous()
    if cfg.hc_mult:  # the mHC stream: the embedding in each of its rows
        x = hyper.expand(cfg, x)
    aux = torch.zeros((), dtype=F32, device=x.device)
    kw = dict(mode=mode, positions=positions, attn_impl=attn_impl, layout=L)
    handed: dict[str, Any] = {}
    if cfg.first_k_dense:
        kinds = ((cfg.prefix_mixer, FFN_DENSE),) * cfg.first_k_dense
        x, aux, handed["prefix"] = _unrolled(
            cfg, params, caches, "prefix", kinds, x, aux, kw
        )
    groups = _unbind(params["groups"], cfg.n_groups)
    in_groups = {f"b{j}": [] for j in range(len(cfg.pattern))}
    if remat and mode == "train" and torch.is_grad_enabled():
        for gp in groups:
            x, aux = _remat(_group_train, cfg, gp, x, aux=aux, kw=kw)
    else:
        for g, gp in enumerate(groups):
            for j, (mixer, ffn) in enumerate(cfg.pattern):
                c = _index(caches["groups"][f"b{j}"], g) if caches is not None else None
                x, nc, a = block_apply(
                    cfg, gp[f"b{j}"], x, mixer=mixer, ffn=ffn, cache=c,
                    path=f"groups/b{j}", **kw,
                )  # fmt: skip
                if mode == "decode" and nc is not c:
                    # a recurrent mixer's next state, into the caches in place
                    _put(caches["groups"][f"b{j}"], nc, g)
                in_groups[f"b{j}"].append(nc)
                if a is not None:
                    aux = aux + a
    if cfg.suffix:
        x, aux, handed["suffix"] = _unrolled(
            cfg, params, caches, "suffix", cfg.suffix, x, aux, kw
        )
    if cfg.hc_mult:
        x = hyper.readout(x)
    final = params["final_norm"]
    if L is not None:
        final = use_tree(L, final, "final_norm", L.vary_stream)
    x = norm_apply(cfg, final, x)
    if mode == "prefill":
        handed["groups"] = {k: _stack(v) for k, v in in_groups.items() if v}
        return x, aux, handed
    return x, aux, caches


def _unrolled(cfg: ModelConfig, params, caches, where: str, kinds, x, aux, kw: dict):
    """The unrolled layers ``params[where]`` (the dense prefix, the
    suffix) of ``kinds``, in order, outside any checkpoint: ``(x, aux,
    their caches)``.  A decode cache is written in place."""
    handed = {}
    for i, (mixer, ffn) in enumerate(kinds):
        name = f"l{i}"
        c = caches[where][name] if caches is not None else None
        x, nc, a = block_apply(
            cfg, params[where][name], x, mixer=mixer, ffn=ffn, cache=c,
            path=f"{where}/{name}", **kw,
        )  # fmt: skip
        handed[name] = nc
        if a is not None:
            aux = aux + a
    return x, aux, handed


def _remat(fn, *args, **kw):
    """``fn(*args, **kw)`` under a non-reentrant checkpoint.  The zoo's
    forward draws no random numbers, so no generator state is stashed
    for the recompute (``preserve_rng_state=False``)."""
    return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False, **kw)


def _group_train(cfg: ModelConfig, gp: dict, x, *, aux, kw: dict):
    """One group's blocks in train mode, each rematerialised: ``(x, aux)``
    after them (the router losses added in the order the plain loop adds
    them, so the two give the same bits).  ``aux`` comes as a keyword:
    the checkpoint saves its positional tensors, and the group's one saved
    input is the stream ``x``."""
    for j, (mixer, ffn) in enumerate(cfg.pattern):
        x, _, a = _remat(
            block_apply, cfg, gp[f"b{j}"], x, mixer=mixer, ffn=ffn, path=f"groups/b{j}",
            **kw,
        )  # fmt: skip
        if a is not None:
            aux = aux + a
    return x, aux


def logits_fn(cfg: ModelConfig, params: dict[str, Any], hidden: torch.Tensor):
    return unembed_apply(cfg, params["embed"], hidden)


def _xent_chunk(cfg: ModelConfig, embed: dict, h: torch.Tensor, lab: torch.Tensor):
    logits = unembed_apply(cfg, embed, h).float()
    lse = torch.logsumexp(logits, -1)
    gold = logits.gather(-1, lab.clamp(min=0).long()[..., None])[..., 0]
    mask = (lab >= 0).to(F32)
    return ((lse - gold) * mask).sum(), mask.sum()


def chunked_xent(
    cfg: ModelConfig,
    params: dict[str, Any],
    hidden: torch.Tensor,
    labels: torch.Tensor,
    *,
    loss_chunk: int = 2048,
    layout=None,
):
    """Cross entropy over S in chunks of ``min(loss_chunk, S)`` tokens:
    the float32 logsumexp minus the gold logit, labels < 0 masked out.
    Returns ``(sum_nll, n_valid)``, float32 scalars.  Under autograd each
    chunk is checkpointed (the reference's ``jax.checkpoint``), so the
    ``[B, S, V]`` logits are never held, in the forward or the backward.

    ``layout``: on a mesh, ``hidden`` is this rank's part of the stream
    and ``labels`` its rows; the sequence is gathered, the logits are
    this rank's block of the vocabulary (where it divides over
    ``model``), the logsumexp's max and sum of exponentials are
    all-reduced over ``model`` and the gold logit comes from the rank
    that holds it; both sums are over the global batch."""
    if layout is not None:
        return _chunked_xent_on_mesh(cfg, params, hidden, labels, layout, loss_chunk)
    b, s, _ = hidden.shape
    c = _loss_chunk(s, loss_chunk)
    nll = torch.zeros((), dtype=F32, device=hidden.device)
    n = torch.zeros((), dtype=F32, device=hidden.device)
    for i in range(s // c):
        args = (cfg, params["embed"], hidden[:, i * c : (i + 1) * c])
        lab = labels[:, i * c : (i + 1) * c]
        if torch.is_grad_enabled():
            dn, dc = checkpoint(_xent_chunk, *args, lab, use_reentrant=False)
        else:
            dn, dc = _xent_chunk(*args, lab)
        nll, n = nll + dn, n + dc
    return nll, n


def _loss_chunk(s: int, loss_chunk: int) -> int:
    c = min(loss_chunk, s)
    if s % c:
        raise ValueError(f"chunked_xent: S={s} is no multiple of the chunk {c}")
    return c


# ---------------------------------------------------------------------------
# the embedding, the logits and the cross entropy on a mesh
# ---------------------------------------------------------------------------
def _embed_on_mesh(cfg: ModelConfig, p: dict, tokens: torch.Tensor, L) -> torch.Tensor:
    """A vocab-parallel lookup onto the stream: each rank looks up the
    tokens in its block of the vocabulary (zeros elsewhere) and the
    partial sums are reduced over ``model``; the whole table on each
    rank where the vocabulary does not divide."""
    blk = L.block(cfg.vocab_size)
    if blk is None:
        tok = use(L, p["tok"], "embed/tok", L.vary_whole)
        return leave(tok[tokens.long()], L, False)
    lo, n = blk
    tok = use(L, p["tok"], "embed/tok", L.vary_tp, (0, lo, n))
    ids = tokens.long() - lo
    inside = (ids >= 0) & (ids < n)
    e = tok[ids.clamp(0, n - 1)].masked_fill(~inside[..., None], 0)
    return leave(e, L, True)


def _unembed_weight(cfg: ModelConfig, p: dict, L):
    """``(w [D, V/m or V], first vocab id, vocab parallel)``: the head (or
    the tied table, transposed) as the logits use it."""
    blk = L.block(cfg.vocab_size)
    vary = L.vary_tp if blk is not None else L.vary_whole
    if cfg.tie_embeddings:
        block = None if blk is None else (0, *blk)
        w = use(L, p["tok"], "embed/tok", vary, block).T
    else:
        block = None if blk is None else (1, *blk)
        w = use(L, p["head"]["w"], "embed/head/w", vary, block)
    return w, (0 if blk is None else blk[0]), blk is not None


def _xent_chunk_on_mesh(h, w, lab, lo, group):
    """One chunk's ``(sum nll, n valid)`` over this rank's rows: the
    logits ``h @ w`` in float32, the vocab block's logsumexp and gold
    logit combined over ``group`` (None: the whole vocabulary here)."""
    logits = (h @ w).float()
    if group is None:
        lse = torch.logsumexp(logits, -1)
        gold = logits.gather(-1, lab.clamp(min=0).long()[..., None])[..., 0]
    else:
        v = logits.shape[-1]
        lse = _VocabLSE.apply(logits, group)
        ids = lab.clamp(min=0).long() - lo
        inside = (ids >= 0) & (ids < v)
        gold = logits.gather(-1, ids.clamp(0, v - 1)[..., None])[..., 0]
        gold = _AllReduceSum.apply(gold.masked_fill(~inside, 0), group)
    mask = (lab >= 0).to(F32)
    return ((lse - gold) * mask).sum(), mask.sum()


def _chunked_xent_on_mesh(cfg, params, hidden, labels, L, loss_chunk):
    w, lo, vp = _unembed_weight(cfg, params["embed"], L)
    h = enter(hidden, L, vp)
    group = L.group(L.model) if vp else None
    b, s, _ = h.shape
    c = _loss_chunk(s, loss_chunk)
    nll = torch.zeros((), dtype=F32, device=h.device)
    n = torch.zeros((), dtype=F32, device=h.device)
    for i in range(s // c):
        args = (h[:, i * c : (i + 1) * c], w, labels[:, i * c : (i + 1) * c], lo, group)
        if torch.is_grad_enabled():
            dn, dc = checkpoint(_xent_chunk_on_mesh, *args, use_reentrant=False)
        else:
            dn, dc = _xent_chunk_on_mesh(*args)
        nll, n = nll + dn, n + dc
    # the rows' sums over the global batch
    return psum(nll, L, L.batch), all_reduce(n, L.groups(L.batch))


def _whole_logits(cfg: ModelConfig, params: dict, h: torch.Tensor, L) -> torch.Tensor:
    """``h`` [B/d, 1, D] (the same on every model rank) -> the whole
    logits [B, 1, V] on every rank: this rank's vocabulary block
    gathered over ``model``, its rows over the batch axes."""
    w, _, vp = _unembed_weight(cfg, params["embed"], L)
    logits = h @ w
    if vp:
        logits = all_gather(logits, L.group(L.model), 2)
    for a in reversed(L.batch):
        logits = all_gather(logits, L.group(a), 0)
    return logits


def _last_hidden(hidden: torch.Tensor, L) -> torch.Tensor:
    """The stream's last position [B/d, 1, D] on every model rank (the
    last model rank holds it when the stream is sequence-sharded)."""
    last = hidden[:, -1:]
    if L.seq:
        last = all_gather(last, L.group(L.model), 1)[:, -1:]
    return last


def _rows(batch: dict, L, b: int) -> dict:
    """This rank's rows of every leaf of a global batch (M-RoPE's
    ``[3, B, S]`` positions along their batch axis)."""
    rows = L.rows(b)
    return {
        k: x[:, rows] if (k == "positions" and x.dim() == 3) else x[rows]
        for k, x in batch.items()
    }


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------
def _inputs_positions(cfg: ModelConfig, batch: dict):
    inputs = batch.get("tokens", batch.get("embeds"))
    b, s = inputs.shape[:2]
    positions = batch.get("positions")
    if positions is None:
        positions = rope_lib.positions_for(cfg, b, s, device=inputs.device)
    return inputs, positions, b, s


def make_loss_fn(
    cfg: ModelConfig,
    *,
    attn_impl: str = "chunked",
    loss_chunk: int = 2048,
    mesh=None,
    policy: ShardingPolicy = ShardingPolicy(),
    hoist: frozenset = frozenset(),
):
    """``(params, batch{tokens|embeds, labels[, positions]}) -> (total,
    {"loss", "aux", "n_tokens"})``: the mean next-token loss over the
    labels >= 0, plus the router loss (0 without MoE) at the config's
    weight.  ``policy.remat``: the forward rematerialises per group and
    per block (:func:`forward`).  On a ``mesh`` the batch is the global
    one (every rank the same; each keeps its rows), ``params`` this rank's
    blocks, and the loss and ``n_tokens`` are the global batch's on every
    rank.
    ``hoist``: paths whose leaves arrive gathered over the FSDP axes
    (the train step's ``hoist_dense_gathers``)."""
    specs = None if mesh is None else param_specs(cfg, mesh_axes(mesh), policy)

    def loss_fn(params, batch):
        inputs, positions, b, s = _inputs_positions(cfg, batch)
        L = None
        if mesh is not None:
            L = make_layout(
                mesh, policy, specs, batch=b, seq_len=s, mode="train", hoist=hoist
            )
            local = _rows({"x": inputs, "labels": batch["labels"],
                           "positions": positions}, L, b)  # fmt: skip
            inputs, positions = local["x"], local["positions"]
            labels = local["labels"]
        else:
            labels = batch["labels"]
        hidden, aux, _ = forward(
            cfg, params, inputs, positions, mode="train", attn_impl=attn_impl,
            layout=L, remat=policy.remat,
        )  # fmt: skip
        nll, n = chunked_xent(
            cfg, params, hidden, labels, loss_chunk=loss_chunk, layout=L
        )
        loss = nll / torch.clamp(n, min=1.0)
        total = loss + cfg.moe.router_aux_weight * aux
        return total, {"loss": loss, "aux": aux, "n_tokens": n}

    return loss_fn


def init_train_state(
    cfg: ModelConfig, generator: torch.Generator, opt_cfg: AdamWConfig
) -> dict[str, Any]:
    params = init_params(cfg, generator)
    return {"params": params, "opt": tree_adamw_init(opt_cfg, params)}


def value_and_grad(loss_fn, params, batch):
    """``(total, metrics, grads)`` of ``loss_fn`` at ``params`` (which stay
    untouched and need no ``requires_grad``): grads in each leaf's dtype,
    shaped like ``params``.  A leaf the loss does not reach (the token
    table of an embeds config) gets zeros, as under ``jax.grad``."""
    live = _tree_map(lambda t: t.detach().requires_grad_(True), params)
    total, metrics = loss_fn(live, batch)
    grads = torch.autograd.grad(total, tree_leaves(live), materialize_grads=True)
    metrics = {k: v.detach() for k, v in metrics.items()}
    return total.detach(), metrics, _tree_from_leaves(params, iter(grads))


def _gather_hoisted(params: dict, specs: dict, paths, mesh, policy) -> dict:
    """``params`` with the hoisted leaves gathered over the FSDP axes that
    split them (plain tensors: their gradients accumulate gathered)."""
    fsdp = set(policy.fsdp_axes)

    def one(path, leaf):
        if path not in paths:
            return leaf
        with torch.no_grad():
            for dim, ax in enumerate(specs[path]):
                for a in reversed(axis_names(ax)):
                    if a in fsdp:
                        leaf = all_gather(leaf, mesh.get_group(a), dim)
        return leaf

    return _map_with_path(one, params)


def _reduce_hoisted(grads: dict, specs: dict, paths, mesh, policy, batch_axes):
    """The hoisted leaves' gradients back to the params' blocks: summed
    over the FSDP axes that split the rows (a reduce-scatter where the
    leaf is split over the axis, an all-reduce where it is not), the
    rank's block over an FSDP axis that does not split the rows."""
    fsdp = set(policy.fsdp_axes)

    def one(path, g):
        if path not in paths:
            return g
        split = set()
        for dim, ax in enumerate(specs[path]):
            for a in axis_names(ax):
                if a in fsdp:
                    split.add(a)
                    group = mesh.get_group(a)
                    if a in batch_axes:
                        g = reduce_scatter(g, group, dim)
                    else:
                        g = own_block(g, group, dim)
        summed = [mesh.get_group(a) for a in batch_axes if a in fsdp - split]
        return all_reduce(g, summed) if summed else g

    return _map_with_path(one, grads)


def make_train_step(
    cfg: ModelConfig,
    opt_cfg: AdamWConfig,
    *,
    attn_impl: str = "chunked",
    loss_chunk: int = 2048,
    microbatches: int = 1,
    mesh=None,
    policy: ShardingPolicy = ShardingPolicy(),
):
    """``(state{params, opt}, batch) -> (state, metrics)``: the gradient of
    :func:`make_loss_fn`'s total, then one AdamW step (in place: the
    returned state holds the same tensors).  With ``microbatches=k`` the
    batch's leading axis splits as the reference splits it (microbatch
    ``i`` takes rows ``i, i+k, ...``), and M-RoPE positions ``[3, B, S]``
    split along their batch axis alike (the reference splits any
    ``positions`` along axis 1, which for ``[B, S]`` ones would be the
    sequence: here those split with the batch); the gradients (in the
    params' dtype), the totals and the metrics are summed over the
    microbatches and divided by k (``n_tokens`` stays a sum).  Metrics:
    ``loss, aux, n_tokens, total, grad_norm``.

    On a ``mesh`` the batch is the global one and ``state`` this rank's
    blocks; a rank's part of microbatch ``i`` is its own rows ``i, i+k,
    ...`` of the batch.  Each gradient arrives in its param's block,
    summed over exactly the axes whose ranks computed parts of it.  Under
    ``policy.hoist_dense_gathers`` the dense-FFN weights are gathered
    over the FSDP axes once before the microbatches, their gradients
    accumulate gathered and are reduce-scattered once after.  AdamW runs
    on the blocks; its clip reads the global norm over them
    (:func:`~repro_torch.models.sharding.global_norm`)."""
    specs = None if mesh is None else param_specs(cfg, mesh_axes(mesh), policy)
    hoist = frozenset()
    if mesh is not None and policy.hoist_dense_gathers:
        hoist = frozenset(p for p in specs if hoisted(p))
    loss_fn = make_loss_fn(
        cfg, attn_impl=attn_impl, loss_chunk=loss_chunk, mesh=mesh, policy=policy,
        hoist=hoist,
    )  # fmt: skip
    k = microbatches

    def train_step(state, batch):
        params = state["params"]
        if hoist:
            params = _gather_hoisted(params, specs, hoist, mesh, policy)
        if k == 1:
            total, metrics, grads = value_and_grad(loss_fn, params, batch)
        else:
            first = tree_leaves(batch)[0]
            lead = first.shape[0]

            def microbatch(key, x, i):
                if key == "positions" and x.dim() == 3:  # M-RoPE [3, B, S]
                    return x[:, i::k]
                if x.dim() >= 1 and x.shape[0] == lead:
                    return x.reshape(lead // k, k, *x.shape[1:])[:, i]
                return x

            grads = _tree_map(torch.zeros_like, params)
            total = torch.zeros((), dtype=F32, device=first.device)
            metrics = dict.fromkeys(("loss", "aux", "n_tokens"), total)
            for i in range(k):
                mb = {key: microbatch(key, x, i) for key, x in batch.items()}
                t, m, g = value_and_grad(loss_fn, params, mb)
                for acc, gi in zip(tree_leaves(grads), tree_leaves(g), strict=True):
                    acc.add_(gi)
                del g
                total = total + t
                metrics = {key: metrics[key] + m[key] for key in metrics}
            grads = _tree_map(lambda g: g / k, grads)
            total = total / k
            metrics = {
                "loss": metrics["loss"] / k,
                "aux": metrics["aux"] / k,
                "n_tokens": metrics["n_tokens"],
            }
        gnorm = None
        if mesh is not None:
            if hoist:
                inputs = batch.get("tokens", batch.get("embeds"))
                bt = make_layout(
                    mesh, policy, specs, batch=inputs.shape[0] // k, seq_len=1,
                    mode="train",
                ).batch  # fmt: skip
                grads = _reduce_hoisted(grads, specs, hoist, mesh, policy, bt)
            gnorm = global_norm(grads, mesh, policy, cfg)
        params, opt, gnorm = tree_adamw_update(
            opt_cfg, state["params"], grads, state["opt"], gnorm
        )
        metrics = dict(metrics, total=total, grad_norm=gnorm)
        return {"params": params, "opt": opt}, metrics

    return train_step


# ---------------------------------------------------------------------------
# steps
# ---------------------------------------------------------------------------
def _cache_specs_for(cfg: ModelConfig, mesh, policy: ShardingPolicy):
    """``(batch, seq_len) -> stored_cache_specs``, remembered (the specs
    of a decode call are the same step after step)."""
    axes = mesh_axes(mesh)
    return functools.lru_cache(maxsize=8)(
        lambda b, s: stored_cache_specs(cfg, b, s, axes, policy)
    )


SLOT_LEAVES = ("k", "v", "ckv", "krope")  # the cache leaves with a slot axis


def _leaf(tree: dict, path: str):
    for k in path.split("/"):
        tree = tree[k]
    return tree


def _cache_len(caches: dict) -> int:
    """The slots of a decode cache: any ``kpos`` leaf's length (whole on
    every model rank); 1 where the caches are all recurrent states."""
    if isinstance(caches, dict):
        if "kpos" in caches:
            return caches["kpos"].shape[-1]
        return max((_cache_len(v) for v in caches.values()), default=1)
    return 1


def load_prefill(caches, pre_caches, fills=None):
    """Copy the prefill's caches (k/v/kpos, MLA's latent ckv/krope/kpos,
    the dense prefix's and the groups') into the decode caches (the
    reference's ``_load_prefill``).

    Every prefill leaf must either match its decode leaf exactly or be a
    same-rank prefix of it (kv caches sized for the whole conversation);
    anything else is a wiring bug, and silently keeping the empty decode
    cache would serve garbage, so it raises.

    ``fills`` (a tree like ``caches``: each leaf's empty value, ``kpos``'s
    -1): load in place, into caches that may hold an earlier
    conversation.  Every leaf keeps its tensor (a CUDA graph reads them),
    and a leaf the prefill fills only in part is emptied first, so the
    slots past the prompt hold no earlier request's entries."""
    if isinstance(caches, dict):
        if not isinstance(pre_caches, dict) or caches.keys() != pre_caches.keys():
            raise ValueError("prefill caches do not have the decode caches' leaves")
        fill = dict.fromkeys(caches) if fills is None else fills
        return {k: load_prefill(caches[k], pre_caches[k], fill[k]) for k in caches}
    dst, src = caches, pre_caches
    if dst.shape == src.shape:
        return src.to(dst.dtype) if fills is None else dst.copy_(src)
    if dst.dim() == src.dim() and all(
        sd <= dd for sd, dd in zip(src.shape, dst.shape, strict=True)
    ):
        if fills is not None:
            dst.fill_(fills)
        # group-stacked kv: [G, B, L, H, D] <- [G, B, s, H, D]
        dst[tuple(slice(0, n) for n in src.shape)] = src.to(dst.dtype)
        return dst
    raise ValueError(
        f"prefill cache leaf {tuple(src.shape)} does not fit decode cache "
        f"leaf {tuple(dst.shape)} (rank or axis mismatch)"
    )


def make_prefill_step(
    cfg: ModelConfig, *, mesh=None, policy: ShardingPolicy = ShardingPolicy()
):
    """(params, batch{tokens|embeds[, positions]}) -> (last logits [B, V],
    caches to hand to decode).  On a ``mesh``: the global batch in, the
    whole logits on every rank, this rank's blocks of the caches
    (``cache_pspec`` at the prompt's length: its rows; its kv heads, or
    its block of the sequence, or its channels or heads of a state)."""
    specs = None if mesh is None else param_specs(cfg, mesh_axes(mesh), policy)
    cache_specs = None if mesh is None else _cache_specs_for(cfg, mesh, policy)

    def prefill_step(params, batch):
        inputs, positions, b, s = _inputs_positions(cfg, batch)
        if mesh is None:
            hidden, _, caches = forward(cfg, params, inputs, positions, mode="prefill")
            return logits_fn(cfg, params, hidden[:, -1:])[:, 0], caches
        L = make_layout(
            mesh, policy, specs, batch=b, seq_len=s, mode="prefill",
            cache_specs=cache_specs(b, s),
        )  # fmt: skip
        local = _rows({"x": inputs, "positions": positions}, L, b)
        hidden, _, caches = forward(
            cfg, params, local["x"], local["positions"], mode="prefill", layout=L
        )
        last = _whole_logits(cfg, params, _last_hidden(hidden, L), L)
        return last[:, 0], caches

    return prefill_step


def make_serve_step(
    cfg: ModelConfig,
    *,
    mesh=None,
    policy: ShardingPolicy = ShardingPolicy(),
    arena: DecodeArena | None = None,
):
    """One decode step: (params, caches, batch{tokens|embeds, pos [B]}) ->
    (logits [B, V], caches).  The caches are written in place and
    returned.  On a ``mesh``: the global batch in, the whole logits on
    every rank, the caches this rank's blocks (``Model.init_caches``).
    Caches of ``arena`` (:meth:`DecodeArena.load`) run the step as the
    arena's CUDA graph of their shape, captured on its first step; any
    other caches run it eagerly."""
    specs = None if mesh is None else param_specs(cfg, mesh_axes(mesh), policy)
    cache_specs = None if mesh is None else _cache_specs_for(cfg, mesh, policy)

    def serve_step(params, caches, batch):
        graph = None if arena is None else arena.graph_of(caches)
        if graph is not None:
            return arena.step(graph, eager_step, params, batch)
        make_serve_step.steps_by_route["eager"] += 1
        return eager_step(params, caches, batch)

    def eager_step(params, caches, batch):
        inputs = batch.get("tokens", batch.get("embeds"))
        pos = batch["pos"]
        L = None
        if mesh is not None:
            b = inputs.shape[0]
            L = make_layout(
                mesh, policy, specs, batch=b, seq_len=1, mode="decode",
                cache_specs=cache_specs(b, _cache_len(caches)),
            )  # fmt: skip
            local = _rows({"x": inputs, "pos": pos}, L, b)
            inputs, pos = local["x"], local["pos"]
        positions = pos[:, None]
        if cfg.rope == "mrope":
            positions = positions[None].expand(3, *positions.shape)
        hidden, _, new_caches = forward(
            cfg, params, inputs, positions, mode="decode", caches=caches, layout=L
        )
        if L is None:
            return logits_fn(cfg, params, hidden)[:, 0], new_caches
        return _whole_logits(cfg, params, hidden, L)[:, 0], new_caches

    return serve_step


# The process's decode steps by route: run eagerly, captured (a graph's
# first step: its work runs eagerly on the capture stream, then is
# recorded) or replayed.
make_serve_step.steps_by_route = dict.fromkeys(("eager", "capture", "replay"), 0)


# ---------------------------------------------------------------------------
# decode graphs
# ---------------------------------------------------------------------------
GRAPH_SLOTS = 64  # the graph path's cache lengths are multiples of this


def graph_cache_len(seq_len: int) -> int:
    """The graph path's cache length for ``seq_len`` tokens: the next
    multiple of :data:`GRAPH_SLOTS`, so conversations of nearby lengths
    share a graph."""
    return -(-seq_len // GRAPH_SLOTS) * GRAPH_SLOTS


def graphs_apply(model) -> bool:
    """Whether ``model``'s decode takes the graph path: a CUDA device, no
    mesh, and no ``named_ranges()`` open (a replay emits no ranges)."""
    return model.device.type == "cuda" and model.mesh is None and not ranges_on()


@dataclasses.dataclass(eq=False)
class _DecodeGraph:
    """One (batch, cache length) of a :class:`DecodeArena`: its static
    caches, and once captured its static inputs, its graph (whose output
    is the logits) and what it was captured on (the params' addresses,
    the inputs' shapes and dtypes)."""

    caches: dict
    inputs: dict = dataclasses.field(default_factory=dict)
    graph: graphs.Graph | None = None
    key: tuple | None = None


class DecodeArena:
    """The decode caches and CUDA graphs of one ``Model`` on its card,
    freed with it.  One entry a (batch, cache length), built on the
    first decode of that shape: caches with ``init_caches``' layout, and
    a graph of the whole serve step (forward, cache writes, logits) over
    them.  A leaf is one static tensor per (leaf path, shape, dtype), so
    entries of one batch share every leaf whose shape does not depend on
    the cache length (a recurrent state, a convolution's tail, a window's
    ring): entries never run at once, and :meth:`load` rewrites every
    leaf before a decode.  The graphs are recorded and replayed by
    :mod:`repro_torch.kernels.graphs`, in one memory pool of the arena's;
    each replay's logits are copied out before the next replay."""

    def __init__(self, cfg: ModelConfig, device: torch.device):
        self.cfg = cfg
        self.device = device
        self.graphs: dict[tuple[int, int], _DecodeGraph] = {}
        self._leaves: dict[tuple, torch.Tensor] = {}
        self._fills = None
        self._pool = None

    def load(self, pre_caches: dict, batch: int, seq_len: int) -> dict:
        """The caches of ``batch`` rows for ``seq_len`` tokens (the
        length rounded up by :func:`graph_cache_len`), the prefill's
        caches copied in and every slot past the prompt's empty again
        (:func:`load_prefill` in place)."""
        entry = self._entry(batch, graph_cache_len(seq_len))
        if self._fills is None:  # init_caches' value of each leaf
            self._fills = _tree_map(_fill_value, init_caches(self.cfg, 1, 1, "cpu"))
        with torch.no_grad():
            load_prefill(entry.caches, pre_caches, fills=self._fills)
        return entry.caches

    def _entry(self, batch: int, cache_len: int) -> _DecodeGraph:
        entry = self.graphs.get((batch, cache_len))
        if entry is None:
            shapes = init_caches(self.cfg, batch, cache_len, META)
            entry = _DecodeGraph(_map_with_path(self._leaf, shapes))
            self.graphs[(batch, cache_len)] = entry
        return entry

    def _leaf(self, path: str, like: torch.Tensor) -> torch.Tensor:
        key = (path, tuple(like.shape), like.dtype)
        if key not in self._leaves:
            self._leaves[key] = torch.empty_like(like, device=self.device)
        return self._leaves[key]

    def graph_of(self, caches) -> _DecodeGraph | None:
        """The entry whose caches ``caches`` are, else None."""
        return next((e for e in self.graphs.values() if e.caches is caches), None)

    def step(self, entry: _DecodeGraph, eager_step, params: dict, batch: dict):
        """One decode step on ``entry``'s caches: a replay of its graph,
        or, on its first step or where the params' addresses or the
        inputs' shapes differ from its graph's, a capture.  Returns a
        copy of the logits (the next replay overwrites its graph's)."""
        key = (
            tuple(t.data_ptr() for t in tree_leaves(params)),
            tuple((k, v.shape, v.dtype) for k, v in sorted(batch.items())),
        )
        if entry.graph is None or key != entry.key:
            return self._capture(entry, eager_step, params, batch, key)
        for k, v in batch.items():
            entry.inputs[k].copy_(v)
        make_serve_step.steps_by_route["replay"] += 1
        return graphs.replay(entry.graph).clone(), entry.caches

    def _capture(self, entry: _DecodeGraph, eager_step, params, batch, key):
        """Warm the step up (its logits are this step's), then record it
        into a new graph over ``entry``'s caches and static copies of
        ``batch``."""
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        entry.graph = None
        entry.inputs = {k: v.clone() for k, v in batch.items()}

        def run():
            return eager_step(params, entry.caches, entry.inputs)[0]

        logits = graphs.warm_up(run, self.device)
        entry.graph = graphs.capture(run, self.device, self._pool)
        entry.key = key
        make_serve_step.steps_by_route["capture"] += 1
        return logits, entry.caches


def _fill_value(leaf: torch.Tensor):
    """The one value a freshly initialised cache leaf holds."""
    value = leaf.reshape(-1)[0]
    if not bool((leaf == value).all()):
        raise ValueError("a cache leaf's init is not one value")
    return value.item()


class Model:
    """The functional API bound to a config, a device (``None`` = the CUDA
    card; raises without one), a sharding policy and an optimizer config.
    Of the policy the loss reads ``loss_chunk`` and ``remat`` and the
    train step those and ``microbatches``.  Under ``remat`` (the default,
    as in the reference) the train step checkpoints each group of layers
    and each block inside it (:func:`forward`); with or without it, it
    checkpoints the attention's query chunks, the cross entropy's chunks
    and the recurrences' chunks.

    ``mesh``: a ``(data, model)`` ``DeviceMesh`` of the process group this
    rank joined (every rank builds the same ``Model``).  Then each rank
    holds its blocks (``models/sharding.py::shard_params``): every leaf
    tensor parallel over ``model`` and FSDP over ``data`` (``policy``'s
    rules; ``dp_over_model``: FSDP over ``data``, whole over ``model``).
    ``init_params`` and ``init_train_state`` keep the rank's blocks,
    ``init_caches`` and :meth:`load_prefill` its blocks of the caches,
    and the steps take the global batch on every rank (the module
    docstring says how the work is split)."""

    def __init__(
        self,
        cfg: ModelConfig,
        device: str | torch.device | None = None,
        *,
        policy: ShardingPolicy = ShardingPolicy(),
        opt_cfg: AdamWConfig = AdamWConfig(),
        mesh=None,
    ):
        self.cfg = cfg
        self.policy = policy
        self.opt_cfg = opt_cfg
        self.mesh = mesh
        self.device = resolve_device(device)
        self.specs = None if mesh is None else param_specs(cfg, mesh_axes(mesh), policy)
        sh = dict(mesh=mesh, policy=policy)
        self.loss_fn = make_loss_fn(cfg, loss_chunk=policy.loss_chunk, **sh)
        self.train_step = make_train_step(
            cfg,
            opt_cfg,
            loss_chunk=policy.loss_chunk,
            microbatches=policy.microbatches,
            **sh,
        )
        self.prefill_step = make_prefill_step(cfg, **sh)
        # the decode graph path's caches and graphs (launch/serve.py::generate)
        self.arena = DecodeArena(cfg, self.device)
        self.serve_step = make_serve_step(cfg, arena=self.arena, **sh)

    def _generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(seed)

    def _keep(self, path: str, leaf: torch.Tensor) -> torch.Tensor:
        """This rank's block of a freshly drawn leaf (a group leaf one
        group at a time: its stacked spec without the group axis)."""
        spec = self.specs[path]
        if path.startswith("groups/"):
            spec = spec[1:]
        return take_slice(leaf, spec, self.mesh)

    def shard(self, params: dict[str, Any]) -> dict[str, Any]:
        """This rank's blocks of whole params (themselves without a mesh)."""
        if self.mesh is None:
            return params
        return shard_params(self.cfg, params, self.mesh, self.policy)

    def gather(self, params: dict[str, Any]) -> dict[str, Any]:
        """Whole params from the ranks' blocks (themselves without a mesh)."""
        if self.mesh is None:
            return params
        return gather_params(self.cfg, params, self.mesh, self.policy)

    def init_params(self, seed: int) -> dict[str, Any]:
        shard = None if self.mesh is None else self._keep
        return init_params(self.cfg, self._generator(seed), shard)

    def init_train_state(self, seed: int) -> dict[str, Any]:
        params = self.init_params(seed)
        return {"params": params, "opt": tree_adamw_init(self.opt_cfg, params)}

    def init_caches(self, batch: int, seq_len: int) -> dict[str, Any]:
        """Empty caches for ``batch`` rows (on a mesh, this rank's blocks
        under ``cache_pspec``: its rows, and its kv heads, block of the
        sequence, or channels or heads of a state; built a layer at a
        time)."""
        if self.mesh is None:
            return init_caches(self.cfg, batch, seq_len, self.device)
        L = make_layout(
            self.mesh, self.policy, self.specs, batch=batch, seq_len=1, mode="decode"
        )
        rows = L.rows(batch)
        specs = stored_cache_specs(
            self.cfg, batch, seq_len, mesh_axes(self.mesh), self.policy
        )

        def keep(path, leaf):  # the rows are this rank's already
            spec = specs[path][1:] if path.startswith("groups/") else specs[path]
            return take_slice(leaf, (None, *spec[1:]), self.mesh)

        n = rows.stop - rows.start
        return init_caches(self.cfg, n, seq_len, self.device, keep)

    def load_prefill(self, caches: dict[str, Any], pre_caches: dict[str, Any]):
        """The prefill's caches into decode caches from
        :meth:`init_caches` (:func:`load_prefill`).  On a mesh
        a cache that ``model`` splits along the sequence at the prompt's
        length or at the decode caches' is all-gathered and cut to the
        rank's slots first."""
        if self.mesh is None:
            return load_prefill(caches, pre_caches)
        axes = mesh_axes(self.mesh)
        b = 1  # the rows' spec is not read
        want, have = (
            stored_cache_specs(self.cfg, b, _cache_len(c), axes, self.policy)
            for c in (caches, pre_caches)
        )
        group = self.mesh.get_group(self.policy.model_axis)
        rank = self.mesh.get_local_rank(self.policy.model_axis)

        def seq_split(spec, dim):
            return self.policy.model_axis in axis_names(spec[dim])

        def one(path, src):
            if path.rsplit("/", 1)[-1] not in SLOT_LEAVES:
                return src  # a state, or kpos (whole over model)
            dim = 2 if path.startswith("groups/") else 1  # the slots
            if seq_split(have[path], dim):  # the prompt's slots, all of them
                src = all_gather(src, group, dim)
            if seq_split(want[path], dim):  # this rank's of the decode cache's
                n = _leaf(caches, path).shape[dim]
                lo = min(rank * n, src.shape[dim])
                src = src.narrow(dim, lo, min(n, src.shape[dim] - lo))
            return src

        with torch.no_grad():
            return load_prefill(caches, _map_with_path(one, pre_caches))


def build_model(cfg: ModelConfig, **kw) -> Model:
    """``Model(cfg, **kw)``, the reference's entry point."""
    return Model(cfg, **kw)


__all__ = [
    "DecodeArena",
    "Model",
    "build_model",
    "cache_len_for",
    "chunked_xent",
    "forward",
    "graph_cache_len",
    "graphs_apply",
    "init_caches",
    "init_params",
    "init_train_state",
    "load_prefill",
    "logits_fn",
    "make_loss_fn",
    "make_prefill_step",
    "make_serve_step",
    "make_train_step",
    "meta_params",
    "value_and_grad",
]
