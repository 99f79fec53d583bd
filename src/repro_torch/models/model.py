"""Model assembly: init, caches, forward, the loss and the train step,
prefill and decode.

The port of the reference's ``models/model.py``.  The parameter layout is
the reference's: the per-group leaves are stacked on a leading ``[G, ...]``
axis, so converting reference params is a dtype change, and ``forward``
loops over the groups in Python where the reference scans.  Of the
reference's ``ShardingPolicy`` (``models/sharding.py``) the train step
keeps the knobs that change what is computed or held (``loss_chunk``,
``microbatches``), which :class:`Model` reads from its policy; per-layer
rematerialisation and the mesh's gather hoisting change no number and are
left out.  ``mesh=`` (a ``(data, model)`` ``torch.distributed``
``DeviceMesh``, one process a rank) reaches the MoE layers, which run
expert parallel as the reference's do (``models/moe.py``; the policy's
``batch_axes`` and ``tensor_parallel``); every other layer runs whole on
each rank, and each rank holds the params :func:`shard_params` gives it
(its slice of the experts).  Training attends through ``chunked_attention``
(``attn_impl="chunked"``), as the reference trains through its XLA path;
serving's prefill through the ``flash_attention`` kernel.
"""

from __future__ import annotations

from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ATTN, FFN_DENSE, ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import rope as rope_lib
from repro_torch.models.blocks import block_apply, block_cache_init, block_init
from repro_torch.models.layers import (
    embed_apply,
    embed_init,
    norm_apply,
    norm_init,
    torch_dtype,
    unembed_apply,
)
from repro_torch.models.sharding import ShardingPolicy, global_norm, shard_params
from repro_torch.optim.adamw import (
    AdamWConfig,
    tree_adamw_init,
    tree_adamw_update,
    tree_leaves,
)

F32 = torch.float32


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
def init_params(cfg: ModelConfig, generator: torch.Generator) -> dict[str, Any]:
    """Fresh params on the generator's device, with the reference's names,
    shapes and init scales (its distributions, not its bits): the
    unrolled dense prefix (``first_k_dense`` layers of attention and a
    dense FFN of ``first_k_dense_d_ff``) as ``prefix/l{i}``, then the
    groups.  Each stacked ``[G, ...]`` leaf is allocated once and group
    ``g`` is drawn into slice ``[g]``, groups in order, so the peak holds
    the params and one group more (not twice the params); a single group
    (jamba cut to 4 layers) is its own ``[1, ...]`` view; a config with no
    group (the planner's walk of the layers outside them) gets ``{}``."""
    params: dict[str, Any] = {
        "embed": embed_init(cfg, generator),
        "final_norm": norm_init(cfg, cfg.d_model, generator.device),
    }
    if cfg.first_k_dense:
        d_ff = cfg.first_k_dense_d_ff or cfg.d_ff
        params["prefix"] = {
            f"l{i}": block_init(cfg, ATTN, FFN_DENSE, generator, d_ff=d_ff)
            for i in range(cfg.first_k_dense)
        }
    groups = None
    for g in range(cfg.n_groups):
        one = {
            f"b{j}": block_init(cfg, mixer, ffn, generator)
            for j, (mixer, ffn) in enumerate(cfg.pattern)
        }
        if cfg.n_groups == 1:  # a [1, ...] view: no second copy of the params
            groups = _tree_map(lambda t: t[None], one)
            break
        if groups is None:
            groups = _stacked_empty(one, cfg.n_groups)
        _put(groups, one, g)
        del one
    params["groups"] = groups if groups is not None else {}
    return params


def cache_len_for(cfg: ModelConfig, seq_len: int) -> int:
    if cfg.sliding_window is not None:
        return min(seq_len, cfg.sliding_window)
    return seq_len


def init_caches(cfg: ModelConfig, batch: int, seq_len: int, device) -> dict[str, Any]:
    """Empty decode caches for ``seq_len`` tokens (ring-buffer length for
    SWA models; a recurrent mixer's state has no length): the prefix's
    per layer, the groups' stacked ``[G, ...]`` like the params."""
    dtype = torch_dtype(cfg.dtype)
    clen = cache_len_for(cfg, seq_len)
    caches: dict[str, Any] = {}
    if cfg.first_k_dense:
        caches["prefix"] = {
            f"l{i}": block_cache_init(cfg, ATTN, batch, clen, dtype, device)
            for i in range(cfg.first_k_dense)
        }
    one = {
        f"b{j}": block_cache_init(cfg, mixer, batch, clen, dtype, device)
        for j, (mixer, _) in enumerate(cfg.pattern)
    }
    groups = _stacked_empty(one, cfg.n_groups)
    for g in range(cfg.n_groups):
        _put(groups, one, g)
    caches["groups"] = groups
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
    mesh=None,
    policy: ShardingPolicy = ShardingPolicy(),
):
    """inputs: tokens [B,S] int or embeds [B,S,D]; positions [B,S] (or
    M-RoPE's [3,B,S]).  ``mesh``: see the module docstring.

    Returns (hidden [B,S,D], aux, caches): ``aux`` is the sum of the MoE
    layers' router losses (a float32 scalar, 0 without MoE); the caches
    are, in prefill mode, the ones to hand to decode (kv caches and
    recurrent states, stacked per group), in decode mode ``caches``
    written in place (a recurrent mixer's new state copied into its
    group's slice), in train mode (the teacher-forced forward) None.
    ``attn_impl``: ``"kernel"`` (serving) or ``"chunked"`` (training; see
    ``attention.gqa_apply``)."""
    if inputs.dtype in (torch.int32, torch.int64):
        x = embed_apply(params["embed"], inputs)
    else:
        x = inputs.to(torch_dtype(cfg.dtype)).contiguous()
    aux = torch.zeros((), dtype=F32, device=x.device)
    kw = dict(
        mode=mode,
        positions=positions,
        attn_impl=attn_impl,
        mesh=mesh,
        batch_axes=policy.batch_axes,
        tp=policy.tensor_parallel,
    )
    handed: dict[str, Any] = {}
    if cfg.first_k_dense:
        handed["prefix"] = {}
        for i in range(cfg.first_k_dense):
            name = f"l{i}"
            c = caches["prefix"][name] if caches is not None else None
            x, nc, _ = block_apply(
                cfg, params["prefix"][name], x, mixer=ATTN, ffn=FFN_DENSE, cache=c, **kw
            )
            handed["prefix"][name] = nc
    in_groups = {f"b{j}": [] for j in range(len(cfg.pattern))}
    for g, gp in enumerate(_unbind(params["groups"], cfg.n_groups)):
        for j, (mixer, ffn) in enumerate(cfg.pattern):
            c = _index(caches["groups"][f"b{j}"], g) if caches is not None else None
            x, nc, a = block_apply(
                cfg, gp[f"b{j}"], x, mixer=mixer, ffn=ffn, cache=c, **kw
            )
            if mode == "decode" and nc is not c:
                # a recurrent mixer's next state, into the caches in place
                _put(caches["groups"][f"b{j}"], nc, g)
            in_groups[f"b{j}"].append(nc)
            if a is not None:
                aux = aux + a
    x = norm_apply(cfg, params["final_norm"], x)
    if mode == "prefill":
        handed["groups"] = {k: _stack(v) for k, v in in_groups.items() if v}
        return x, aux, handed
    return x, aux, caches


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
):
    """Cross entropy over S in chunks of ``min(loss_chunk, S)`` tokens:
    the float32 logsumexp minus the gold logit, labels < 0 masked out.
    Returns ``(sum_nll, n_valid)``, float32 scalars.  Under autograd each
    chunk is checkpointed (the reference's ``jax.checkpoint``), so the
    ``[B, S, V]`` logits are never held, in the forward or the backward."""
    b, s, _ = hidden.shape
    c = min(loss_chunk, s)
    if s % c:
        raise ValueError(f"chunked_xent: S={s} is no multiple of the chunk {c}")
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


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------
def make_loss_fn(
    cfg: ModelConfig,
    *,
    attn_impl: str = "chunked",
    loss_chunk: int = 2048,
    mesh=None,
    policy: ShardingPolicy = ShardingPolicy(),
):
    """``(params, batch{tokens|embeds, labels[, positions]}) -> (total,
    {"loss", "aux", "n_tokens"})``: the mean next-token loss over the
    labels >= 0, plus the router loss (0 without MoE) at the config's
    weight."""

    def loss_fn(params, batch):
        inputs = batch.get("tokens", batch.get("embeds"))
        b, s = inputs.shape[:2]
        positions = batch.get("positions")
        if positions is None:
            positions = rope_lib.positions_for(cfg, b, s, device=inputs.device)
        hidden, aux, _ = forward(
            cfg,
            params,
            inputs,
            positions,
            mode="train",
            attn_impl=attn_impl,
            mesh=mesh,
            policy=policy,
        )
        nll, n = chunked_xent(
            cfg, params, hidden, batch["labels"], loss_chunk=loss_chunk
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
    microbatches and divided by k (``n_tokens`` stays a sum).  Metrics: ``loss, aux,
    n_tokens, total, grad_norm``.  On a ``mesh`` each rank updates its own
    params; the clip reads the global norm over the ranks' expert slices."""
    loss_fn = make_loss_fn(
        cfg, attn_impl=attn_impl, loss_chunk=loss_chunk, mesh=mesh, policy=policy
    )
    k = microbatches

    def train_step(state, batch):
        params = state["params"]
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
        gnorm = None if mesh is None else global_norm(grads, mesh, policy, cfg)
        params, opt, gnorm = tree_adamw_update(
            opt_cfg, params, grads, state["opt"], gnorm
        )
        metrics = dict(metrics, total=total, grad_norm=gnorm)
        return {"params": params, "opt": opt}, metrics

    return train_step


# ---------------------------------------------------------------------------
# steps
# ---------------------------------------------------------------------------
def make_prefill_step(
    cfg: ModelConfig, *, mesh=None, policy: ShardingPolicy = ShardingPolicy()
):
    """(params, batch{tokens|embeds[, positions]}) -> (last logits [B, V],
    caches to hand to decode)."""

    def prefill_step(params, batch):
        inputs = batch.get("tokens", batch.get("embeds"))
        b, s = inputs.shape[:2]
        positions = batch.get("positions")
        if positions is None:
            positions = rope_lib.positions_for(cfg, b, s, device=inputs.device)
        hidden, _, caches = forward(
            cfg, params, inputs, positions, mode="prefill", mesh=mesh, policy=policy
        )
        last = logits_fn(cfg, params, hidden[:, -1:])
        return last[:, 0], caches

    return prefill_step


def make_serve_step(
    cfg: ModelConfig, *, mesh=None, policy: ShardingPolicy = ShardingPolicy()
):
    """One decode step: (params, caches, batch{tokens|embeds, pos [B]}) ->
    (logits [B, V], caches).  The caches are written in place and
    returned."""

    def serve_step(params, caches, batch):
        inputs = batch.get("tokens", batch.get("embeds"))
        positions = batch["pos"][:, None]
        if cfg.rope == "mrope":
            positions = positions[None].expand(3, *positions.shape)
        hidden, _, new_caches = forward(
            cfg,
            params,
            inputs,
            positions,
            mode="decode",
            caches=caches,
            mesh=mesh,
            policy=policy,
        )
        return logits_fn(cfg, params, hidden)[:, 0], new_caches

    return serve_step


class Model:
    """The functional API bound to a config, a device (``None`` = the CUDA
    card; raises without one), a sharding policy and an optimizer config.
    Of the policy the loss reads ``loss_chunk`` and the train step
    ``loss_chunk`` and ``microbatches``; ``remat`` is not read: the port does
    not rematerialise per layer (ROADMAP queue 1 item 3.2); it checkpoints
    the attention's query chunks, the cross entropy's chunks and the
    recurrences' chunks.  ``mesh``: a ``(data, model)`` ``DeviceMesh`` of
    the process group this rank joined; the MoE layers run expert
    parallel on it, and ``init_params``/``init_train_state`` keep this
    rank's slice of the experts."""

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
        self.serve_step = make_serve_step(cfg, **sh)

    def _generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(seed)

    def shard(self, params: dict[str, Any]) -> dict[str, Any]:
        """This rank's part of whole params (themselves without a mesh)."""
        if self.mesh is None:
            return params
        return shard_params(self.cfg, params, self.mesh, self.policy)

    def init_params(self, seed: int) -> dict[str, Any]:
        return self.shard(init_params(self.cfg, self._generator(seed)))

    def init_train_state(self, seed: int) -> dict[str, Any]:
        params = self.init_params(seed)
        return {"params": params, "opt": tree_adamw_init(self.opt_cfg, params)}

    def init_caches(self, batch: int, seq_len: int) -> dict[str, Any]:
        return init_caches(self.cfg, batch, seq_len, self.device)


def build_model(cfg: ModelConfig, **kw) -> Model:
    """``Model(cfg, **kw)``, the reference's entry point."""
    return Model(cfg, **kw)


__all__ = [
    "Model",
    "build_model",
    "cache_len_for",
    "chunked_xent",
    "forward",
    "init_caches",
    "init_params",
    "init_train_state",
    "logits_fn",
    "make_loss_fn",
    "make_prefill_step",
    "make_serve_step",
    "make_train_step",
    "value_and_grad",
]
