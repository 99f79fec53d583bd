"""Flattened-path ``.npz`` checkpoints (the reference's format)."""

from repro_torch.checkpoint.ckpt import restore_pytree, save_pytree

__all__ = ["restore_pytree", "save_pytree"]
