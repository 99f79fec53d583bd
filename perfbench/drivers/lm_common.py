"""What the language-model drivers share: the port's config from the
configuration file, the weights the benchmark draws, and token batches.

The configuration file holds the published ``config.json`` keys (the
depth cut where ``reduced`` says so; where the port runs otherwise,
``departures`` says how) and the port's config id under ``arch``.  The
port's config is that id's, with the depth, the norm's epsilon, the
experts' capacity factor and the router loss's weight taken from the
file; every width is checked against the file, so the file says what
runs.
"""

from __future__ import annotations

from dataclasses import replace

import torch

from perfbench.harness.weights import generator, make_leaves


def port_config(c: dict):
    from repro_torch.configs.base import get_config

    base = get_config(c["arch"])
    moe = replace(
        base.moe,
        capacity_factor=float(c["capacity_factor"]),
        router_aux_weight=float(c["router_aux_weight"]),
    )
    cfg = replace(
        base, n_layers=int(c["num_hidden_layers"]), norm_eps=float(c["rms_norm_eps"]), moe=moe
    )
    want = {
        "d_model": c["hidden_size"],
        "n_heads": c["num_attention_heads"],
        "d_ff": c["intermediate_size"],
        "vocab_size": c["vocab_size"],
        "first_k_dense": c["first_k_dense_replace"],
        "head_dim": c["head_dim"],
        "rope_theta": c["rope_theta"],
        "dtype": c["dtype"],
        "moe.n_experts": c["n_routed_experts"],
        "moe.top_k": c["num_experts_per_tok"],
        "moe.n_shared_experts": c["n_shared_experts"],
        "moe.d_ff_expert": c["moe_intermediate_size"],
        "mla.kv_lora_rank": c["kv_lora_rank"],
        "mla.rope_head_dim": c["qk_rope_head_dim"],
        "mla.nope_head_dim": c["qk_nope_head_dim"],
        "mla.v_head_dim": c["v_head_dim"],
    }
    for key, value in want.items():
        obj = cfg
        for part in key.split("."):
            obj = getattr(obj, part)
        if obj != value:
            raise ValueError(f"{c['name']}: the port runs {key}={obj!r}, the file says {value!r}")
    return cfg


def weight_specs(cfg) -> list:
    """(path, shape, scale, dtype) of every leaf of the port's parameter
    tree at its global shape: matrices at fan-in ** -0.5 (the fan-in the
    next-to-last axis), the token table at 0.02, norm scales ones."""
    from repro_torch.models.model import meta_params

    specs = []

    def walk(tree, path):
        for k in sorted(tree):
            v = tree[k]
            if isinstance(v, dict):
                walk(v, path + (k,))
                continue
            p = path + (k,)
            if p[-1] == "scale":
                scale = None
            elif p[-2:] == ("embed", "tok"):
                scale = 0.02
            elif p[-1] == "b":
                scale = 0
            else:
                scale = v.shape[-2] ** -0.5
            specs.append((p, tuple(v.shape), scale, v.dtype))

    walk(meta_params(cfg), ())
    return specs


def draw_params(cfg, seed: int, device: torch.device) -> dict:
    from perfbench.harness.weights import nest

    return nest(make_leaves(weight_specs(cfg), seed, device))


class TokenStream:
    """Token ids drawn on the device from the seed, uniform over the
    vocabulary; each call the next ``[B, S + 1]`` block."""

    def __init__(self, seed: int, vocab: int, device: torch.device):
        self.gen = generator(seed + 7919, device)
        self.vocab = vocab
        self.device = device

    def __call__(self, b: int, s: int) -> torch.Tensor:
        return torch.randint(
            0, self.vocab, (b, s), generator=self.gen, device=self.device, dtype=torch.int64
        )


def leaf_slices(tree: dict):
    """(key, tensor) of every leaf, a stacked group leaf cut into its
    groups, keyed ``(path, group)`` as the reference keys them."""

    def items(t, prefix=()):
        for k in sorted(t):
            v = t[k]
            if isinstance(v, dict):
                yield from items(v, prefix + (k,))
            else:
                yield prefix + (k,), v

    for path, t in items(tree):
        if path[0] == "groups":
            for g in range(t.shape[0]):
                yield (path, g), t[g]
        else:
            yield (path, None), t
