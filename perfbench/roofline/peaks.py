"""Published peaks of the card (NVIDIA's H100 SXM data sheet, dense
rates without sparsity, at the 700 W power limit).  A card set below
that limit runs slower: the result line names the card, and the shares
are of these published numbers."""

from __future__ import annotations

import torch

H100 = {
    "bf16_flops": 989e12,
    "tf32_flops": 495e12,
    "fp32_flops": 67e12,  # outside the tensor cores
    "hbm_bytes": 3.35e12,
}


def peaks(device: torch.device) -> dict | None:
    """The peaks of ``device``'s card, None for a card not in the table."""
    if device.type != "cuda" or "H100" not in torch.cuda.get_device_name(device):
        return None
    return H100


def float32_peak(p: dict, tf32: bool) -> float:
    """The float32 products' peak: TF32 on the tensor cores where TF32 is
    on, else the float32 units."""
    return p["tf32_flops"] if tf32 else p["fp32_flops"]


def roofline_share(
    flops: float, nbytes: float, seconds: float, p: dict, flops_peak: float
) -> float:
    """The least time the card could take (the larger of the operations
    over the peak and the bytes over the bandwidth) over the time taken,
    in percent: the kernel table's arithmetic (PERF.md section 6)."""
    bound = max(flops / flops_peak, nbytes / p["hbm_bytes"])
    return 100.0 * bound / seconds
