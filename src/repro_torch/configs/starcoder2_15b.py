"""StarCoder2-15B — dense GQA decoder, RoPE, layernorm + gelu MLP with bias.
[arXiv:2402.19173]  A copy of the reference's
``repro/configs/starcoder2_15b.py``."""

from repro_torch.configs.base import ATTN, FFN_DENSE, ModelConfig, register

register(
    ModelConfig(
        name="starcoder2-15b",
        family="dense",
        n_layers=40,
        d_model=6144,
        n_heads=48,
        n_kv_heads=4,
        head_dim=128,
        d_ff=24576,
        vocab_size=49152,
        pattern=((ATTN, FFN_DENSE),),
        mlp_variant="gelu",
        norm="layernorm",
        qkv_bias=True,
        rope="rope",
        rope_theta=100_000.0,
        source="arXiv:2402.19173 (StarCoder2-15B)",
    )
)
