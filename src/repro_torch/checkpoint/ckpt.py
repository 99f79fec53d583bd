"""Checkpoints of nested dicts of tensors as a flattened-path ``.npz``.

The reference's ``repro/checkpoint/ckpt.py`` for the port's trees: keys
are the tree path joined with ``|`` (the reference's
``tree_flatten_with_path`` keys for nested dicts and lists), and
``restore_pytree`` rebuilds against a reference structure, so a shape
mismatch fails loudly.  The files cross between the packages both ways.

numpy has no bfloat16 of its own (the reference's leaves use
``ml_dtypes``', which the card's machine does not have), so a bfloat16
leaf is written as float32, which holds it exactly; the reference's
``restore_pytree`` casts it back to its tree's dtype.  A bfloat16 leaf
written by the reference reads back as its bits: ``bfloat16`` where
``ml_dtypes`` is loaded, a 2-byte void (``|V2``) where it is not.
"""

from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch

_SEP = "|"


def _items(tree: Any, prefix: tuple = ()):
    """``(path, leaf)`` pairs in the reference's flattening order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _items(tree[k], (*prefix, str(k)))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _items(v, (*prefix, str(i)))
    else:
        yield _SEP.join(prefix), tree


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return np.asarray(leaf)


def _to_tensor(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    if arr.dtype.itemsize == 2 and arr.dtype.kind not in "fiub":
        # a reference bfloat16 leaf: ml_dtypes' bfloat16 or raw 2-byte void
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(arr))
    return t.to(device=like.device, dtype=like.dtype)


def save_pytree(path: str, tree: Any) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **{k: _to_numpy(v) for k, v in _items(tree)})
    # np.savez appends .npz if missing; keep the name asked for
    if not path.endswith(".npz") and os.path.exists(path + ".npz"):
        os.replace(path + ".npz", path)


def restore_pytree(path: str, like: Any) -> Any:
    """The tree saved at ``path``, shaped, typed and placed like ``like``."""
    with np.load(path) as data:

        def build(tree, prefix):
            if isinstance(tree, dict):
                return {k: build(v, (*prefix, str(k))) for k, v in tree.items()}
            if isinstance(tree, (list, tuple)):
                return type(tree)(
                    build(v, (*prefix, str(i))) for i, v in enumerate(tree)
                )
            key = _SEP.join(prefix)
            arr = data[key]
            if tuple(arr.shape) != tuple(tree.shape):
                raise ValueError(
                    f"shape mismatch at {key}: {arr.shape} vs {tuple(tree.shape)}"
                )
            return _to_tensor(arr, tree)

        return build(like, ())


__all__ = ["restore_pytree", "save_pytree"]
