"""The optimizer config a model-zoo config trains with.

The one function of the reference's ``repro/launch/specs.py`` that a run
needs (the rest of that file is TPU mesh planning, not ported)."""

from __future__ import annotations

from repro_torch.configs.base import ModelConfig, param_count
from repro_torch.optim.adamw import AdamWConfig


def opt_cfg_for(cfg: ModelConfig) -> AdamWConfig:
    """bf16 moments above 1e11 parameters (the reference's rule, sized for
    its sharded TPU memory), f32 moments below."""
    total, _ = param_count(cfg)
    dtype = "bfloat16" if total > 1e11 else "float32"
    return AdamWConfig(opt_dtype=dtype)


__all__ = ["opt_cfg_for"]
