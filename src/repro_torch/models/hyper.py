"""Manifold-constrained hyper-connections (mHC), the residual path of
Xing4.0 (DeepSeek-AI, "mHC: Manifold-Constrained Hyper-Connections",
2025-12, after Zhu et al., "Hyper-Connections", 2024).

With ``cfg.hc_mult = n > 0`` the residual stream of a token is ``n`` rows
of ``d_model = C``, ``X [n, C]``, and every residual sublayer ``F`` (each
block's mixer and its FFN, each with its own pre-norm as without mHC) sits
in a site of its own::

    x_hat = RMSNorm_{nC}(vec X)                          (its scale w [n C])
    [h_pre (n), h_post (n), h_res (n^2)] = alpha (.) (x_hat phi) + b
    H_pre = sigmoid(h_pre),  H_post = 2 sigmoid(h_post)
    H_res = Sinkhorn(exp(clamp(h_res, lo, hi)))           (n x n)
    u = H_pre X                                          (a C-vector)
    y = F(RMSNorm(u))
    X <- H_res X + H_post^T y

``phi [n C, 2n + n^2]`` is the site's projection, ``alpha`` one scale a
group (pre, post, res), ``b`` the bias; ``Sinkhorn`` runs
:data:`SINKHORN_ITERS` (20) alternations of row then column normalisation,
each sum plus :data:`SINKHORN_EPS` (1e-6); ``(lo, hi)`` is
:data:`RES_CLAMP` (-30, 30).  These are Xing4.0's published
``hc_sinkhorn_iters``, ``hc_eps`` and ``mhc_h_res_clamp_*``, fixed for the
one model with mHC (kernel G's constants too).  The norm over ``n C``
takes ``norm_eps``.  At the ends the embedding is copied into the ``n``
rows (:func:`expand`) and the rows are summed before the final norm
(:func:`readout`).

The stream is held in the model's dtype, as the single stream is; the
norm, the coefficients and the Sinkhorn are computed in float32 (kernel G,
``kernels/mhc.py``: on a card where no gradient is recorded two launches a
site; on the CPU the plain PyTorch forms, which training runs: G has no
backward, and a card's site that autograd would record raises).  A
site's leaves (:func:`hc_init`): ``phi/w`` (a matrix at fan-in ** -0.5),
``alpha/scale`` (ones), ``b`` (zeros) and ``norm/scale`` (ones), all
float32; a block's sites are
``hc1`` (around the mixer) and ``hc2`` (around the FFN).  Inside
``models/layers.py::named_ranges`` each site shows as ``mhc.pre`` and
``mhc.post``.  One card only: the mesh paths refuse ``hc_mult > 0``.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.mhc import RES_CLAMP, SINKHORN_EPS, SINKHORN_ITERS, mhc
from repro_torch.models.layers import span, truncated_normal

F32 = torch.float32


def hc_init(cfg: ModelConfig, generator: torch.Generator) -> dict:
    n, d = cfg.hc_mult, cfg.d_model
    cols = 2 * n + n * n
    dev = generator.device
    return {
        "phi": {"w": truncated_normal((n * d, cols), (n * d) ** -0.5, F32, generator)},
        "alpha": {"scale": torch.ones((3,), dtype=F32, device=dev)},
        "b": torch.zeros((cols,), dtype=F32, device=dev),
        "norm": {"scale": torch.ones((n * d,), dtype=F32, device=dev)},
    }


def expand(cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """The embedding ``[B, S, C]`` copied into the stream's ``n`` rows."""
    b, s, c = x.shape
    return x[:, :, None, :].expand(b, s, cfg.hc_mult, c).contiguous()


def readout(x: torch.Tensor) -> torch.Tensor:
    """The stream ``[B, S, n, C]``'s rows summed (in float32) to ``[B, S, C]``."""
    return x.float().sum(2).to(x.dtype)


def pre(cfg: ModelConfig, p: dict, x: torch.Tensor):
    """A site's entry: ``(u [B, S, C], coefficients)`` for the stream ``x
    [B, S, n, C]``; the coefficients go to :func:`post`."""
    b, s, n, c = x.shape
    with span("mhc.pre"):
        u, h_post, h_res = mhc.pre(
            x.reshape(b * s, n, c), p["phi"]["w"], p["alpha"]["scale"], p["b"],
            p["norm"]["scale"], norm_eps=cfg.norm_eps,
        )  # fmt: skip
    return u.reshape(b, s, c), (h_post, h_res)


def post(x: torch.Tensor, y: torch.Tensor, coef) -> torch.Tensor:
    """A site's exit: ``H_res x + H_post^T y`` for the sublayer's output
    ``y [B, S, C]``."""
    b, s, n, c = x.shape
    with span("mhc.post"):
        out = mhc.post(x.reshape(b * s, n, c), y.reshape(b * s, c).contiguous(), *coef)
    return out.reshape(b, s, n, c)


__all__ = [
    "RES_CLAMP",
    "SINKHORN_EPS",
    "SINKHORN_ITERS",
    "expand",
    "hc_init",
    "post",
    "pre",
    "readout",
]
