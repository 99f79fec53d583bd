"""Moonlight-16B-A3B (moonshot-v1-16b-a3b) — DeepSeek-V3-style MoE:
64 routed experts top-6 + 2 shared. [hf:moonshotai/Moonlight-16B-A3B]
A copy of the reference's ``repro/configs/moonshot_16b.py``."""

from repro_torch.configs.base import ATTN, FFN_MOE, ModelConfig, MoEConfig, register

register(
    ModelConfig(
        name="moonshot-v1-16b-a3b",
        family="dense",  # assignment tag; architecture is MoE
        n_layers=48,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,  # MHA per assignment (GQA kv=16)
        head_dim=128,
        d_ff=11264,  # dense FFN width of the first-k-dense prefix
        vocab_size=163840,
        pattern=((ATTN, FFN_MOE),),
        first_k_dense=1,
        first_k_dense_d_ff=11264,
        moe=MoEConfig(n_experts=64, top_k=6, n_shared_experts=2, d_ff_expert=1408),
        rope="rope",
        rope_theta=50_000.0,
        source="hf:moonshotai/Moonlight-16B-A3B",
    )
)
