"""Xing4.0's serving work, from the configuration file's keys
(``configs/xing4.0-29b-a4b-ep4.json``): the model's own operations,
whatever implements them, with no capacity padding; the routed experts
at this card's share (``experts_held`` of ``n_routed_experts``).  And the
bytes of kernel G (``mhc_pre_kernel``, ``mhc_post_kernel``), one site of
the mHC residual, the least each launch must move."""

from __future__ import annotations

DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def mla_matmul_params(c: dict) -> int:
    """A token's MLA weights: the q latent and its expansion, the kv
    latent, the shared rope key, the per-head keys and values, out."""
    d, h = c["hidden_size"], c["num_attention_heads"]
    nope, rope = c["qk_nope_head_dim"], c["qk_rope_head_dim"]
    vd, r, rq = c["v_head_dim"], c["kv_lora_rank"], c["q_lora_rank"]
    q = d * rq + rq * h * (nope + rope)
    return q + d * r + d * rope + r * h * nope + r * h * vd + h * vd * d


def mla_attention_flops(c: dict, keys: float) -> float:
    """A token's scores and weighted values over ``keys`` keys."""
    h = c["num_attention_heads"]
    qk = c["qk_nope_head_dim"] + c["qk_rope_head_dim"]
    return 2 * h * (qk + c["v_head_dim"]) * keys


def ffn_matmul_params(c: dict, kind: str) -> float:
    """A token's FFN weights: the dense SwiGLU, or the router, the shared
    experts and ``num_experts_per_tok`` routed ones at this card's
    share."""
    d = c["hidden_size"]
    if kind == "dense":
        return 3 * d * c["intermediate_size"]
    e, f = c["n_routed_experts"], c["moe_intermediate_size"]
    share = c["experts_held"] / e
    routed = share * c["num_experts_per_tok"] * 3 * d * f
    return d * e + 3 * d * f * c["n_shared_experts"] + routed


def site_flops(c: dict) -> int:
    """A token's mHC site: the projection of its ``n C`` stream onto the
    ``2n + n^2`` coefficients, ``u = H_pre X`` and ``H_res X + H_post^T
    y`` (a multiply-add each)."""
    n, d = c["hc_mult"], c["hidden_size"]
    return 2 * n * d * (2 * n + n * n) + 2 * n * d + 2 * n * d * (n + 1)


def sites(c: dict) -> int:
    """mHC sites a forward passes: two a layer (the mixer's, the FFN's)."""
    return 2 * c["num_hidden_layers"]


def token_flops(c: dict, keys: float) -> float:
    """One token through every layer (not the head), its attention over
    ``keys`` keys."""
    nd = c["first_k_dense_replace"]
    out = 0.0
    for i in range(c["num_hidden_layers"]):
        out += 2 * mla_matmul_params(c) + mla_attention_flops(c, keys)
        out += 2 * ffn_matmul_params(c, "dense" if i < nd else "moe")
    return out + sites(c) * site_flops(c)


def head_flops(c: dict) -> int:
    return 2 * c["hidden_size"] * c["vocab_size"]


def prefill_flops(c: dict, b: int, length: int) -> float:
    """``b`` prompts of ``length``: every layer over every token, causal
    (``(length + 1) / 2`` keys on average), the head over each prompt's
    last token."""
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


def site_bytes(c: dict, rows: int) -> int:
    """One site's two launches over ``rows`` tokens, the least they move:
    the stream read (``mhc_pre_kernel``) and read and written
    (``mhc_post_kernel``), u written and y read in the activations' dtype;
    phi and the norm's scale read once, H_post and H_res written and read
    in float32."""
    n, d = c["hc_mult"], c["hidden_size"]
    act = DTYPE_BYTES[c["dtype"]]
    stream = rows * n * d * act
    coef = rows * (n + n * n) * 4
    return 3 * stream + 2 * rows * d * act + n * d * (2 * n + n * n + 1) * 4 + 2 * coef


def site_kernel_flops(c: dict, rows: int) -> int:
    """One site's two launches over ``rows`` tokens: :func:`site_flops`
    and the norm's squares (the float32 units' work)."""
    return rows * (site_flops(c) + 2 * c["hc_mult"] * c["hidden_size"])
