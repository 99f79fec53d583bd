"""Rotary position embeddings (standard RoPE, rotate-half).

The port of the reference's ``models/rope.py``.  Qwen2-VL's M-RoPE waits
for the zoo slice that ports that config and raises here.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig

F32 = torch.float32
_MROPE = (
    "M-RoPE is not ported yet: it comes with the zoo slice of qwen2-vl-2b "
    "(ROADMAP queue 1)"
)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """[head_dim/2] inverse frequencies (f32)."""
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(half, dtype=F32, device=device) / half))


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float):
    """positions [...] int -> cos/sin of shape [..., head_dim/2] (f32)."""
    freqs = rope_freqs(head_dim, theta, positions.device)
    ang = positions.to(F32)[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def mrope_cos_sin(positions3, head_dim: int, theta: float, sections):
    raise NotImplementedError(_MROPE)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [..., S, H, D]; cos/sin broadcastable [..., S, 1, D/2].

    Rotate-half convention (llama): pairs are (x[:D/2], x[D/2:]); computed
    in float32 and cast back."""
    xf = x.float()
    half = xf.shape[-1] // 2
    x1, x2 = xf[..., :half], xf[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def positions_for(
    cfg: ModelConfig, batch: int, seq: int, offset: int = 0, device=None
) -> torch.Tensor:
    """Default position ids [B, S] (int32)."""
    if cfg.rope == "mrope":
        raise NotImplementedError(_MROPE)
    pos = torch.arange(seq, dtype=torch.int32, device=device)[None, :] + offset
    return pos.expand(batch, seq)


def cos_sin_for(cfg: ModelConfig, positions: torch.Tensor, head_dim: int | None = None):
    """positions [B,S] -> cos, sin [B,S,1,D/2]; None without rope."""
    hd = head_dim if head_dim is not None else cfg.resolved_head_dim
    if cfg.rope == "none":
        return None
    if cfg.rope == "mrope":
        cos, sin = mrope_cos_sin(positions, hd, cfg.rope_theta, cfg.mrope_sections)
    else:
        cos, sin = rope_cos_sin(positions, hd, cfg.rope_theta)
    return cos[..., None, :], sin[..., None, :]


__all__ = [
    "apply_rope",
    "cos_sin_for",
    "mrope_cos_sin",
    "positions_for",
    "rope_cos_sin",
    "rope_freqs",
]
