"""Norms, MLPs, embeddings — shared building blocks of the model zoo.

The port of the reference's ``models/layers.py``.  Parameters are nested
dicts of tensors with the reference's names and its ``x @ w`` layout, so
converted reference params drop in (``repro_torch.convert``).  Inits draw
from a ``torch.Generator`` on the device the params live on: the same
distributions as the reference's, not its bits.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from contextlib import contextmanager, nullcontext
from contextvars import ContextVar

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.rmsnorm import RMSNorm

F32 = torch.float32
# Named ranges on the profiler's timeline (``torch.profiler.record_function``)
# around the zoo's own mixers and dispatch: "kda.prefill", "kda.step",
# "moe.held" (a layer's local dispatch over the experts the card holds:
# all of them unless the config holds a share), and "mhc.pre" and
# "mhc.post" (an mHC site's entry and exit, kernel G).  Off unless a profiling entry point opens
# :func:`named_ranges` (``launch/profile_serve.py``): the profiler records
# each range as a device-side annotation too, which a reader of device
# operations would count as one.
_RANGES: ContextVar[bool] = ContextVar("zoo_named_ranges", default=False)


@contextmanager
def named_ranges():
    """The zoo's named ranges on for the work inside the block, and off
    again (as they were) when it ends."""
    token = _RANGES.set(True)
    try:
        yield
    finally:
        _RANGES.reset(token)


def ranges_on() -> bool:
    """Whether a :func:`named_ranges` block is open."""
    return _RANGES.get()


def span(name: str):
    """``record_function(name)`` inside :func:`named_ranges`, else nothing."""
    return torch.profiler.record_function(name) if _RANGES.get() else nullcontext()


def torch_dtype(name: str) -> torch.dtype:
    """A config's dtype name (``"bfloat16"``, ``"float32"``) as a torch dtype."""
    return getattr(torch, name)


def truncated_normal(
    shape: tuple[int, ...], scale: float, dtype: torch.dtype, generator: torch.Generator
) -> torch.Tensor:
    """``scale`` x a standard normal truncated to [-2, 2], drawn in float32
    on the generator's device, then cast to ``dtype``."""
    x = torch.empty(shape, dtype=F32, device=generator.device)
    torch.nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=generator)
    # scaled in place: one float32 temporary, not two (jamba's [16, 8192,
    # 24576] expert weights are 12.9 GB of float32 each)
    return x.mul_(scale).to(dtype)


def dense_init(
    d_in: int,
    d_out: int,
    dtype: torch.dtype,
    generator: torch.Generator,
    *,
    bias: bool = False,
    scale: float | None = None,
) -> dict[str, torch.Tensor]:
    p = {"w": truncated_normal((d_in, d_out), scale or d_in**-0.5, dtype, generator)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=generator.device)
    return p


def dense_apply(p: dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


# ---------------------------------------------------------------------------
# Norms (computed in f32, cast back)
# ---------------------------------------------------------------------------
def norm_init(
    cfg: ModelConfig, d: int, device: torch.device
) -> dict[str, torch.Tensor]:
    p = {"scale": torch.ones((d,), dtype=F32, device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=F32, device=device)
    return p


def norm_apply(
    cfg: ModelConfig, p: dict[str, torch.Tensor], x: torch.Tensor
) -> torch.Tensor:
    """RMSNorm through the ``rmsnorm`` kernel (``RMSNorm``: differentiable,
    its backward in plain torch); LayerNorm (which no TPU kernel backs) in
    plain torch.  Both in float32, cast back."""
    if cfg.norm != "layernorm":
        return RMSNorm.apply(x, p["scale"], cfg.norm_eps)
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + cfg.norm_eps)
    return (y * p["scale"] + p["bias"]).to(x.dtype)


# ---------------------------------------------------------------------------
# MLP (swiglu or gelu variant)
# ---------------------------------------------------------------------------
def mlp_init(
    cfg: ModelConfig, d_model: int, d_ff: int, generator: torch.Generator
) -> dict[str, dict[str, torch.Tensor]]:
    dtype = torch_dtype(cfg.dtype)
    if cfg.mlp_variant == "swiglu":
        return {
            "wi": dense_init(d_model, d_ff, dtype, generator),
            "wg": dense_init(d_model, d_ff, dtype, generator),
            "wo": dense_init(d_ff, d_model, dtype, generator),
        }
    return {
        "wi": dense_init(d_model, d_ff, dtype, generator, bias=True),
        "wo": dense_init(d_ff, d_model, dtype, generator, bias=True),
    }


def mlp_apply(cfg: ModelConfig, p, x: torch.Tensor) -> torch.Tensor:
    if cfg.mlp_variant == "swiglu":
        h = F.silu(dense_apply(p["wg"], x)) * dense_apply(p["wi"], x)
    else:
        h = F.gelu(dense_apply(p["wi"], x), approximate="tanh")  # jax.nn.gelu
    return dense_apply(p["wo"], h)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------
def embed_init(cfg: ModelConfig, generator: torch.Generator):
    dtype = torch_dtype(cfg.dtype)
    p = {"tok": truncated_normal((cfg.vocab_size, cfg.d_model), 0.02, dtype, generator)}
    if not cfg.tie_embeddings:
        p["head"] = dense_init(
            cfg.d_model, cfg.vocab_size, dtype, generator, scale=cfg.d_model**-0.5
        )
    return p


def embed_apply(p, tokens: torch.Tensor) -> torch.Tensor:
    return p["tok"][tokens.long()]


def unembed_apply(cfg: ModelConfig, p, x: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        return x @ p["tok"].T
    return dense_apply(p["head"], x)


__all__ = [
    "dense_apply",
    "dense_init",
    "embed_apply",
    "embed_init",
    "mlp_apply",
    "mlp_init",
    "named_ranges",
    "norm_apply",
    "norm_init",
    "ranges_on",
    "span",
    "torch_dtype",
    "truncated_normal",
    "unembed_apply",
]
