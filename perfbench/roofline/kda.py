"""The bytes of Kimi Delta Attention's fused decode step, from the
configuration file's keys (``configs/kimi-linear-48b-a3b-ep4.json``),
whatever implements the step: the least it must move."""

from __future__ import annotations

DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def kda_layers(c: dict) -> int:
    """KDA layers a forward passes: one fused step each at decode."""
    return len(c["linear_attn_config"]["kda_layers"])


def kda_step_bytes(c: dict, batch: int) -> int:
    """One layer's step over ``batch`` sequences: per (sequence, head) the
    float32 state of ``head_dim`` x ``head_dim`` read and written, q, k
    and v read in the activations' dtype, the float32 decay (one a key
    channel) and beta read, o written."""
    la = c["linear_attn_config"]
    h, d = la["num_heads"], la["head_dim"]
    act = DTYPE_BYTES[c["dtype"]]
    per_head = 2 * d * d * 4 + 3 * d * act + (d + 1) * 4 + d * act
    return batch * h * per_head
