"""Where the port runs, and at what precision.

Every entry point (``ADFLLSystem``, ``FleetEngine``, ``DQNAgent``, the
runner and the CLI) takes ``device=None``, which means the CUDA card.
Running on the CPU is something a caller asks for (``device="cpu"``, as
the tests do); a missing card is an error, never a silent fallback.

The fleet path is float32 throughout.  On Hopper, cuDNN runs float32
convolutions in TF32 by default (``torch.backends.cudnn.allow_tf32`` is
True), which keeps about three decimal digits and would break every
float32 tolerance the port is held to against the reference.  So
:func:`resolve_device` turns TF32 off for cuDNN convolutions and for
cuBLAS matmuls before anything runs on the card.  The model zoo runs in
bfloat16; cuBLAS may reduce a bf16 product's partial sums in bf16
(``allow_bf16_reduced_precision_reduction``), where the reference's TPU
matmuls accumulate in float32, so that is turned off too.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` -> ``cuda``; raise if CUDA is asked for and missing."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run on the CPU explicitly"
            )
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device: {dev}")
    return dev


def device_type(device: str | torch.device | None = None) -> str:
    """The type (``"cuda"`` or ``"cpu"``) that ``device`` names, ``None``
    meaning the CUDA card, without touching the card: what a result
    records so that it is never read back as another device's."""
    return torch.device("cuda" if device is None else device).type


__all__ = ["device_type", "resolve_device"]
