"""AdamW with global-norm clipping and cosine schedule over stacked agents.

Every tensor carries a leading agent axis N (one slot of the fleet per
row), and each agent's update is exactly the reference's
``optim/adamw.py::adamw_update`` on its own pytree:

* the clip norm is per agent, over all of that agent's leaves, summed
  in the reference's leaf order (sorted layer names, ``b`` before ``w``);
* the cosine schedule and the bias corrections ``1 - b1**c``,
  ``1 - b2**c`` are computed in float32 tensors from each slot's own
  ``count``, as JAX does (Python doubles would round differently);
* weight decay is added to the step before the ``lr`` multiply.

Not ``torch.optim.AdamW``: that one has no per-agent norm or schedule
and rounds its bias correction in double precision.

The model zoo's language models train one tree with one ``count``
(:func:`tree_adamw_init`, :func:`tree_adamw_update`): the reference's
arithmetic leaf by leaf in its pytree order, the moments stored in
``opt_dtype`` (bfloat16 for the largest configs,
``launch/specs.py::opt_cfg_for``), updated in place.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

F32 = torch.float32


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    opt_dtype: str = "float32"  # the LM tree's moments; the fleet's are f32


def leaves(tree: dict) -> list[torch.Tensor]:
    """A params dict's leaves in the reference's pytree order."""
    return [tree[k][n] for k in sorted(tree) for n in sorted(tree[k])]


def cosine_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    step = step.to(F32)
    warm = step / max(1.0, cfg.warmup_steps)
    frac = (step - cfg.warmup_steps) / max(1.0, cfg.total_steps - cfg.warmup_steps)
    frac = frac.clamp(0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * frac))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def _zeros_like(params: dict) -> dict:
    return {
        k: {n: torch.zeros_like(t) for n, t in v.items()} for k, v in params.items()
    }


def adamw_init(params: dict) -> dict:
    """Zero moments shaped like the stacked ``params``, zero count per slot."""
    first = leaves(params)[0]
    return {
        "m": _zeros_like(params),
        "v": _zeros_like(params),
        "count": torch.zeros(first.shape[0], dtype=torch.int32, device=first.device),
    }


def _per_agent(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """[N] -> [N, 1, ...] broadcastable against a stacked leaf."""
    return x.reshape(-1, *([1] * (like.dim() - 1)))


def adamw_update(cfg: AdamWConfig, params: dict, grads: dict, opt: dict):
    """One AdamW step for every agent row.  Returns new ``(params, opt,
    gnorm [N])``; the inputs are not modified."""
    count = opt["count"] + 1
    gnorm = torch.sqrt(
        sum(g.square().reshape(g.shape[0], -1).sum(1) for g in leaves(grads))
    )
    # `python_float / tensor` is reciprocal-then-multiply in torch; divide
    # tensor by tensor to round like the reference
    clip = torch.full_like(gnorm, cfg.clip_norm)
    scale = torch.clamp(clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    lr = cosine_schedule(cfg, count)
    c = count.to(F32)
    bc1 = 1.0 - torch.pow(torch.full_like(c, cfg.b1), c)
    bc2 = 1.0 - torch.pow(torch.full_like(c, cfg.b2), c)
    new_p, new_m, new_v = {}, {}, {}
    for k in params:
        new_p[k], new_m[k], new_v[k] = {}, {}, {}
        for n, p in params[k].items():
            g = grads[k][n] * _per_agent(scale, p)
            m = opt["m"][k][n] * cfg.b1 + (1 - cfg.b1) * g
            v = opt["v"][k][n] * cfg.b2 + (1 - cfg.b2) * g * g
            step = (m / _per_agent(bc1, p)) / (
                torch.sqrt(v / _per_agent(bc2, p)) + cfg.eps
            )
            step = step + cfg.weight_decay * p
            new_p[k][n] = p - _per_agent(lr, p) * step
            new_m[k][n], new_v[k][n] = m, v
    return new_p, {"m": new_m, "v": new_v, "count": count}, gnorm


# ---------------------------------------------------------------------------
# one tree (the model zoo's language models)
# ---------------------------------------------------------------------------
_CHUNK = 1 << 26  # elements a float32 temporary of the tree update holds


def tree_leaves(tree) -> list[torch.Tensor]:
    """A nested dict's tensors in ``jax.tree_util.tree_leaves`` order
    (keys sorted at every level)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def _chunks(t: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """Views of ``t`` split along its first axis into pieces of at most
    about :data:`_CHUNK` elements (the update is elementwise, so the
    pieces give the same numbers as the whole; they bound the float32
    temporaries of a bf16 leaf of several GB)."""
    if t.dim() == 0 or t.numel() <= _CHUNK:
        return (t,)
    return t.split(max(1, _CHUNK // (t.numel() // t.shape[0])))


def tree_adamw_init(cfg: AdamWConfig, params: dict) -> dict:
    """Zero moments in ``cfg.opt_dtype`` shaped like ``params``, count 0."""
    dt = getattr(torch, cfg.opt_dtype)

    def zeros(tree):
        if isinstance(tree, dict):
            return {k: zeros(v) for k, v in tree.items()}
        return torch.zeros(tree.shape, dtype=dt, device=tree.device)

    first = tree_leaves(params)[0]
    return {
        "m": zeros(params),
        "v": zeros(params),
        "count": torch.zeros((), dtype=torch.int32, device=first.device),
    }


def tree_global_norm(grads) -> torch.Tensor:
    """sqrt of the sum, over the leaves in order, of each leaf's float32
    sum of squares (the reference's ``global_norm``)."""
    total = 0
    for g in tree_leaves(grads):
        total = total + sum(c.float().square().sum() for c in _chunks(g))
    return torch.sqrt(total)


@torch.no_grad()
def tree_adamw_update(
    cfg: AdamWConfig,
    params: dict,
    grads: dict,
    opt: dict,
    gnorm: torch.Tensor | None = None,
):
    """One AdamW step of the reference's ``adamw_update`` on one tree, in
    place: ``params``, ``opt["m"]`` and ``opt["v"]`` are overwritten (the
    reference's train step donates its state the same way) and
    ``opt["count"]`` replaced.  Returns ``(params, opt, gnorm)``.  Every
    leaf is updated in float32 and stored back in its own dtype (the
    moments in ``opt_dtype``); the schedule, the clip scale and the bias
    corrections are float32 tensors, as JAX computes them.  ``gnorm``:
    the global norm the clip reads, where the tree is one rank's part of
    the params (``models/sharding.py::global_norm``); by default the
    tree's own."""
    count = opt["count"] + 1
    if gnorm is None:
        gnorm = tree_global_norm(grads)
    clip = torch.full_like(gnorm, cfg.clip_norm)
    scale = torch.clamp(clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    lr = cosine_schedule(cfg, count)
    c = count.to(F32)
    bc1 = 1.0 - torch.pow(torch.full_like(c, cfg.b1), c)
    bc2 = 1.0 - torch.pow(torch.full_like(c, cfg.b2), c)
    flat = zip(
        tree_leaves(params),
        tree_leaves(grads),
        tree_leaves(opt["m"]),
        tree_leaves(opt["v"]),
        strict=True,
    )
    for p, g, m, v in flat:
        for pc, gc, mc, vc in zip(_chunks(p), _chunks(g), _chunks(m), _chunks(v)):
            gf = gc.float() * scale
            m32 = mc.float() * cfg.b1 + (1 - cfg.b1) * gf
            v32 = vc.float() * cfg.b2 + (1 - cfg.b2) * gf * gf
            step = (m32 / bc1) / (torch.sqrt(v32 / bc2) + cfg.eps)
            step = step + cfg.weight_decay * pc.float()
            pc.copy_(pc.float() - lr * step)
            mc.copy_(m32)
            vc.copy_(v32)
    opt["count"] = count
    return params, opt, gnorm


__all__ = [
    "AdamWConfig",
    "adamw_init",
    "adamw_update",
    "cosine_schedule",
    "leaves",
    "tree_adamw_init",
    "tree_adamw_update",
    "tree_global_norm",
    "tree_leaves",
]
