"""Kimi-Linear's serving work, from the configuration file's keys
(``configs/kimi-linear-48b-a3b-ep4.json``): the model's own operations,
whatever implements them, with no capacity padding.  Each layer by its
published kind (``linear_attn_config``); the routed experts at this
card's share (``experts_held`` of ``num_experts``)."""

from __future__ import annotations


def _kinds(c: dict) -> list[tuple[str, str]]:
    la = c["linear_attn_config"]
    nd = c["first_k_dense_replace"]
    out = []
    for i in range(c["num_hidden_layers"]):
        mixer = "kda" if i + 1 in la["kda_layers"] else "mla"
        out.append((mixer, "dense" if i < nd else "moe"))
    return out


def kda_matmul_params(c: dict) -> int:
    """A KDA layer's projections: q, k, v, the decay's and the gate's low
    ranks, beta and out."""
    la = c["linear_attn_config"]
    d, hk, r = c["hidden_size"], la["num_heads"] * la["head_dim"], c["kda_lowrank"]
    return 3 * d * hk + 2 * (d * r + r * hk) + d * la["num_heads"] + hk * d


def kda_recurrence_flops(c: dict) -> int:
    """A token's step of the recurrence: 6 d_k d_v a head (the decay, the
    delta's product and update, the read-out)."""
    la = c["linear_attn_config"]
    return 6 * la["num_heads"] * la["head_dim"] ** 2


def mla_matmul_params(c: dict) -> int:
    d, h = c["hidden_size"], c["num_attention_heads"]
    nope, rope = c["qk_nope_head_dim"], c["qk_rope_head_dim"]
    vd, r = c["v_head_dim"], c["kv_lora_rank"]
    q = d * h * (nope + rope)
    return q + d * r + d * rope + r * h * nope + r * h * vd + h * vd * d


def mla_attention_flops(c: dict, keys: float) -> float:
    """A token's scores and weighted values over ``keys`` keys."""
    h = c["num_attention_heads"]
    qk = c["qk_nope_head_dim"] + c["qk_rope_head_dim"]
    return 2 * h * (qk + c["v_head_dim"]) * keys


def ffn_matmul_params(c: dict, kind: str) -> float:
    """A token's FFN weights: the dense SwiGLU, or the router, the shared
    experts and ``num_experts_per_token`` routed ones at this card's
    share."""
    d = c["hidden_size"]
    if kind == "dense":
        return 3 * d * c["intermediate_size"]
    e, f = c["num_experts"], c["moe_intermediate_size"]
    share = c["experts_held"] / e
    routed = share * c["num_experts_per_token"] * 3 * d * f
    return d * e + 3 * d * f * c["num_shared_experts"] + routed


def token_flops(c: dict, keys: float) -> float:
    """One token through every layer (not the head), its MLA layers over
    ``keys`` keys."""
    out = 0.0
    for mixer, ffn in _kinds(c):
        if mixer == "kda":
            out += 2 * kda_matmul_params(c) + kda_recurrence_flops(c)
        else:
            out += 2 * mla_matmul_params(c) + mla_attention_flops(c, keys)
        out += 2 * ffn_matmul_params(c, ffn)
    return out


def head_flops(c: dict) -> int:
    return 2 * c["hidden_size"] * c["vocab_size"]


def prefill_flops(c: dict, b: int, length: int) -> float:
    """``b`` prompts of ``length``: every layer over every token, the MLA
    layers causal (``(length + 1) / 2`` keys on average), the head over
    each prompt's last token."""
    return b * length * token_flops(c, (length + 1) / 2) + b * head_flops(c)


def decode_step_flops(c: dict, b: int, keys: int) -> float:
    """One decode step of ``b`` sequences whose token attends ``keys``
    keys: every layer and the head."""
    return b * (token_flops(c, keys) + head_flops(c))


def served_flops(c: dict, traffic: dict, steps: int) -> float:
    """The work of a window of the ``lm_decode`` driver up to its
    ``steps``-th decode step (counted from the window's start): the
    traffic's fixed ``cycle`` of prompt lengths, ``gen`` decode steps a
    batch of ``batch``, each batch's prefill before its first step."""
    b, gen, cycle = traffic["batch"], traffic["gen"], traffic["cycle"]
    total = 0.0
    for i in range((steps + gen - 1) // gen):
        length = cycle[i % len(cycle)]
        total += prefill_flops(c, b, length)
        for j in range(1, min(gen, steps - i * gen) + 1):
            total += decode_step_flops(c, b, length + j)
    return total
