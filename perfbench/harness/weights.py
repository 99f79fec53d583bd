"""Weights made by the benchmark from the seed, on the device, in a few
large calls: one standard normal truncated to [-2, 2] drawn into one
flat buffer of the served dtype, chunk by chunk, then cut into leaves
and each leaf scaled.  Both the program and the reference are handed
these tensors."""

from __future__ import annotations

import math

import torch

CHUNK = 1 << 28  # elements of one float32 draw


def generator(seed: int, device: torch.device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))


def draw_flat(n: int, seed: int, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    gen = generator(seed, device)
    out = torch.empty(n, dtype=dtype, device=device)
    tmp = torch.empty(min(n, CHUNK), dtype=torch.float32, device=device)
    for lo in range(0, n, CHUNK):
        piece = tmp[: min(CHUNK, n - lo)]
        torch.nn.init.trunc_normal_(piece, 0.0, 1.0, -2.0, 2.0, generator=gen)
        out[lo : lo + piece.numel()].copy_(piece)
    return out


def make_leaves(
    specs: list[tuple[tuple, tuple[int, ...], float, torch.dtype]],
    seed: int,
    device: torch.device,
) -> dict:
    """``specs``: ``(path, shape, scale, dtype)`` per leaf; a scale of 0
    gives zeros and None ones (norm scales).  Returns ``{path: tensor}``,
    the drawn leaves views of one buffer per dtype."""
    out = {}
    by_dtype: dict[torch.dtype, list] = {}
    for spec in specs:
        by_dtype.setdefault(spec[3], []).append(spec)
    for i, (dtype, group) in enumerate(sorted(by_dtype.items(), key=lambda kv: str(kv[0]))):
        drawn = [s for s in group if s[2] not in (0, None)]
        total = sum(math.prod(s[1]) for s in drawn)
        flat = draw_flat(total, seed * 8 + i, device, dtype) if total else None
        lo = 0
        for path, shape, scale, _ in group:
            if scale is None:
                out[path] = torch.ones(shape, dtype=dtype, device=device)
            elif scale == 0:
                out[path] = torch.zeros(shape, dtype=dtype, device=device)
            else:
                n = math.prod(shape)
                out[path] = flat[lo : lo + n].view(shape).mul_(scale)
                lo += n
    return out


def nest(flat: dict) -> dict:
    """``{(a, b, ...): tensor}`` -> nested dicts."""
    root: dict = {}
    for path, t in flat.items():
        node = root
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = t
    return root
