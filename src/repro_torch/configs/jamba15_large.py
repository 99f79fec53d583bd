"""Jamba-1.5-Large (398B) — hybrid Mamba + attention 7:1 interleave with MoE.
[arXiv:2403.19887] (Jamba) / Jamba-1.5 model card.
A copy of the reference's ``repro/configs/jamba15_large.py``.

One attention layer per 8-layer Jamba block; MoE FFN every other layer
(16 experts, top-2), dense FFN otherwise.
"""

from repro_torch.configs.base import (
    ATTN,
    FFN_DENSE,
    FFN_MOE,
    MAMBA,
    ModelConfig,
    MoEConfig,
    SSMConfig,
    register,
)

# 8-layer Jamba block: mamba x3, attn at index 3 (paper places the attention
# layer mid-block), mamba x4; MoE on every other FFN.
_PATTERN = (
    (MAMBA, FFN_MOE),
    (MAMBA, FFN_DENSE),
    (MAMBA, FFN_MOE),
    (ATTN, FFN_DENSE),
    (MAMBA, FFN_MOE),
    (MAMBA, FFN_DENSE),
    (MAMBA, FFN_MOE),
    (MAMBA, FFN_DENSE),
)

register(
    ModelConfig(
        name="jamba-1.5-large-398b",
        family="hybrid",
        n_layers=72,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        head_dim=128,
        d_ff=24576,
        vocab_size=65536,
        pattern=_PATTERN,
        moe=MoEConfig(n_experts=16, top_k=2, d_ff_expert=24576),
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2),
        subquadratic=True,  # mamba state + 1/8 attn layers
        rope="none",  # jamba uses no positional encoding
        source="arXiv:2403.19887; ai21labs/AI21-Jamba-1.5-Large",
    )
)
