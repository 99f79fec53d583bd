"""DeepSeek-V2-Lite (16B, 2.4B active) — MLA attention (kv_lora_rank=512) +
fine-grained MoE: 2 shared + 64 routed top-6, first layer dense.
[arXiv:2405.04434]
A copy of the reference's ``repro/configs/deepseek_v2_lite.py``."""

from repro_torch.configs.base import (
    FFN_MOE,
    MLA,
    MLAConfig,
    ModelConfig,
    MoEConfig,
    register,
)

register(
    ModelConfig(
        name="deepseek-v2-lite-16b",
        family="moe",
        n_layers=27,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,  # MLA: all heads read the shared latent
        head_dim=128,
        d_ff=10944,  # dense FFN width (first layer)
        vocab_size=102400,
        pattern=((MLA, FFN_MOE),),
        first_k_dense=1,
        first_k_dense_d_ff=10944,
        moe=MoEConfig(n_experts=64, top_k=6, n_shared_experts=2, d_ff_expert=1408),
        mla=MLAConfig(
            kv_lora_rank=512,
            q_lora_rank=0,
            rope_head_dim=64,
            nope_head_dim=128,
            v_head_dim=128,
        ),
        rope="rope",
        rope_theta=10_000.0,
        source="arXiv:2405.04434 (DeepSeek-V2-Lite)",
    )
)
