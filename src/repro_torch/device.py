"""Where the port runs, and at what precision.

Every entry point (``ADFLLSystem``, ``FleetEngine``, ``DQNAgent``, the
runner and the CLI) takes ``device=None``, which means the CUDA card.
Running on the CPU is something a caller asks for (``device="cpu"``, as
the tests do); a missing card is an error, never a silent fallback.

The path is float32 throughout.  On Hopper, cuDNN runs float32
convolutions in TF32 by default (``torch.backends.cudnn.allow_tf32`` is
True), which keeps about three decimal digits and would break every
float32 tolerance the port is held to against the reference.  So
:func:`resolve_device` turns TF32 off for cuDNN convolutions and for
cuBLAS matmuls before anything runs on the card.
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
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device: {dev}")
    return dev


__all__ = ["resolve_device"]
