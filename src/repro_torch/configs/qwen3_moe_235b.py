"""Qwen3-235B-A22B — 94-layer MoE, 128 experts top-8.
[hf:Qwen/Qwen3-235B-A22B via Qwen3-30B-A3B assignment]
A copy of the reference's ``repro/configs/qwen3_moe_235b.py``."""

from repro_torch.configs.base import ATTN, FFN_MOE, ModelConfig, MoEConfig, register

register(
    ModelConfig(
        name="qwen3-moe-235b-a22b",
        family="moe",
        n_layers=94,
        d_model=4096,
        n_heads=64,
        n_kv_heads=4,
        head_dim=128,
        d_ff=1536,  # expert width (qwen3-moe has no dense FFN)
        vocab_size=151936,
        pattern=((ATTN, FFN_MOE),),
        moe=MoEConfig(n_experts=128, top_k=8, d_ff_expert=1536),
        rope="rope",
        rope_theta=1_000_000.0,
        source="hf:Qwen/Qwen3-235B-A22B",
    )
)
