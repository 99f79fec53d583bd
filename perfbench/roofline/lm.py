"""A language model's operations and the rmsnorm kernel's bytes, from
the configuration file's keys (``configs/deepseek-v2-lite-16b*.json``):
the model's own work, whatever implements it, with no recompute and no
capacity padding."""

from __future__ import annotations


def layer_kinds(c: dict) -> list[str]:
    nd = c["first_k_dense_replace"]
    return ["dense"] * nd + ["moe"] * (c["num_hidden_layers"] - nd)


def matmul_params_per_token(c: dict) -> int:
    """Weights a token multiplies by: each dense layer's multi-head
    attention and SwiGLU, each MoE layer's MLA projections, router, its
    ``num_experts_per_tok`` routed experts and the shared ones, and the
    output head."""
    d, h = c["hidden_size"], c["num_attention_heads"]
    hd = c["head_dim"]
    nope, rope = c["qk_nope_head_dim"], c["qk_rope_head_dim"]
    vd, r = c["v_head_dim"], c["kv_lora_rank"]
    f, k = c["moe_intermediate_size"], c["num_experts_per_tok"]
    e, ns = c["n_routed_experts"], c["n_shared_experts"]
    dense = 4 * d * h * hd + 3 * d * c["intermediate_size"]
    mla = d * h * (nope + rope) + d * r + d * rope + r * h * nope + r * h * vd + h * vd * d
    moe = d * e + k * 3 * d * f + 3 * d * ns * f
    total = d * c["vocab_size"]
    for kind in layer_kinds(c):
        total += dense if kind == "dense" else mla + moe
    return total


def attention_flops_forward(c: dict, context: float) -> float:
    """One token's causal attention forward over ``context`` keys on
    average: scores and the weighted values, each a multiply-add a head
    and a dimension."""
    h = c["num_attention_heads"]
    out = 0.0
    for kind in layer_kinds(c):
        if kind == "dense":
            out += 2 * h * (2 * c["head_dim"]) * context
        else:
            qk = c["qk_nope_head_dim"] + c["qk_rope_head_dim"]
            out += 2 * h * (qk + c["v_head_dim"]) * context
    return out


def train_flops_per_token(c: dict, seq: int) -> float:
    """Forward and backward (three times the forward) of one token of a
    causal sequence of ``seq``: 6 x the weights it multiplies by, and the
    attention over ``(seq + 1) / 2`` keys on average, three times."""
    return 6 * matmul_params_per_token(c) + 3 * attention_flops_forward(c, (seq + 1) / 2)


def forward_flops(c: dict, n_tokens: int, keys: float) -> float:
    """A forward over ``n_tokens`` tokens that attend to ``keys`` keys in
    all (summed over the tokens)."""
    return 2 * matmul_params_per_token(c) * n_tokens + attention_flops_forward(c, 1.0) * keys


def rmsnorm_bytes(c: dict, rows: int, act_bytes: int = 2) -> int:
    """One rmsnorm launch over ``rows`` rows of ``hidden_size``: the rows
    read and written once in the activations' dtype, the float32 scale
    read."""
    d = c["hidden_size"]
    return 2 * rows * d * act_bytes + 4 * d


def rmsnorm_launches_per_train_step(c: dict, remat: bool = True) -> int:
    """The forward's two a layer and the final one; under remat each
    grouped layer's two again in the recompute."""
    n = c["num_hidden_layers"]
    grouped = n - c["first_k_dense_replace"]
    return 2 * n + 1 + (2 * grouped if remat else 0)


def rmsnorm_launches_per_forward(c: dict) -> int:
    return 2 * c["num_hidden_layers"] + 1


def head_params(c: dict) -> int:
    return c["hidden_size"] * c["vocab_size"]


def prefill_flops(c: dict, b: int, length: int) -> float:
    """A prefill of ``b`` prompts of ``length``: every layer over every
    token, the output head over each prompt's last token only, causal
    attention over ``length (length + 1) / 2`` keys a prompt."""
    body = matmul_params_per_token(c) - head_params(c)
    attn = attention_flops_forward(c, 1.0) * b * length * (length + 1) / 2
    return 2 * body * b * length + 2 * head_params(c) * b + attn
