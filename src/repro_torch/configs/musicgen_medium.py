"""MusicGen-medium — decoder-only transformer over EnCodec tokens.
[arXiv:2306.05284]

Modality frontend (EnCodec + codebook interleave) is STUBBED per assignment:
``input_specs`` feeds precomputed frame embeddings of shape [B, S, d_model];
the LM head predicts the 2048-entry codebook.
A copy of the reference's ``repro/configs/musicgen_medium.py``."""

from repro_torch.configs.base import ATTN, FFN_DENSE, ModelConfig, register

register(
    ModelConfig(
        name="musicgen-medium",
        family="audio",
        n_layers=48,
        d_model=1536,
        n_heads=24,
        n_kv_heads=24,  # MHA
        head_dim=64,
        d_ff=6144,
        vocab_size=2048,
        pattern=((ATTN, FFN_DENSE),),
        input_kind="embeds",
        mlp_variant="gelu",
        norm="layernorm",
        rope="none",  # musicgen uses learned/sinusoidal pos; stubbed
        source="arXiv:2306.05284 (MusicGen medium, 1.5B decoder)",
    )
)
