"""Qwen2.5-14B — dense GQA decoder with QKV bias. [hf:Qwen/Qwen2.5-14B]
A copy of the reference's ``repro/configs/qwen25_14b.py``."""

from repro_torch.configs.base import ATTN, FFN_DENSE, ModelConfig, register

register(
    ModelConfig(
        name="qwen2.5-14b",
        family="dense",
        n_layers=48,
        d_model=5120,
        n_heads=40,
        n_kv_heads=8,
        head_dim=128,
        d_ff=13824,
        vocab_size=152064,
        pattern=((ATTN, FFN_DENSE),),
        qkv_bias=True,
        rope="rope",
        rope_theta=1_000_000.0,
        source="hf:Qwen/Qwen2.5-14B (family card via Qwen2.5-0.5B assignment)",
    )
)
