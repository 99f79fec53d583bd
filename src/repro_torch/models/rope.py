"""Rotary position embeddings: standard RoPE (rotate-half) and
Qwen2-VL's M-RoPE.

The port of the reference's ``models/rope.py``.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig

F32 = torch.float32


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """[head_dim/2] inverse frequencies (f32)."""
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(half, dtype=F32, device=device) / half))


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float):
    """positions [...] int -> cos/sin of shape [..., head_dim/2] (f32)."""
    freqs = rope_freqs(head_dim, theta, positions.device)
    ang = positions.to(F32)[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def mrope_cos_sin(
    positions3: torch.Tensor, head_dim: int, theta: float, sections
) -> tuple[torch.Tensor, torch.Tensor]:
    """Qwen2-VL multimodal RoPE.

    positions3: [3, ...] (t, h, w) position ids.  ``sections`` splits the
    head_dim/2 frequency bands among (t, h, w), in that order; each band
    rotates by its own coordinate.  Returns cos/sin [..., head_dim/2]."""
    half = head_dim // 2
    if sum(sections) != half:
        raise ValueError(f"M-RoPE sections {tuple(sections)} do not sum to {half}")
    freqs = rope_freqs(head_dim, theta, positions3.device)
    ang = positions3.to(F32)[..., None] * freqs  # [3, ..., half]
    bands, start = [], 0
    for coord, width in enumerate(sections):
        bands.append(ang[coord, ..., start : start + width])
        start += width
    sel = torch.cat(bands, -1)  # [..., half]
    return torch.cos(sel), torch.sin(sel)


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
    """Default position ids: [B, S] (int32), or [3, B, S] for M-RoPE with
    the three coordinates equal (Qwen2-VL's ids for a text-only segment)."""
    pos = torch.arange(seq, dtype=torch.int32, device=device)[None, :] + offset
    pos = pos.expand(batch, seq)
    if cfg.rope == "mrope":
        return pos[None].expand(3, batch, seq)
    return pos


def cos_sin_for(cfg: ModelConfig, positions: torch.Tensor, head_dim: int | None = None):
    """positions [B,S] (rope) or [3,B,S] (M-RoPE) -> cos, sin [B,S,1,D/2];
    None without rope."""
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
