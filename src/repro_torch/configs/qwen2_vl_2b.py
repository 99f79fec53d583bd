"""Qwen2-VL-2B — VLM language decoder with M-RoPE (multimodal rotary) and
dynamic-resolution vision. [arXiv:2409.12191]

Vision frontend (ViT + merger) is STUBBED per assignment: ``input_specs``
feeds precomputed patch+token embeddings [B, S, d_model] plus 3D (t,h,w)
M-RoPE position ids [3, B, S].
A copy of the reference's ``repro/configs/qwen2_vl_2b.py``."""

from repro_torch.configs.base import ATTN, FFN_DENSE, ModelConfig, register

register(
    ModelConfig(
        name="qwen2-vl-2b",
        family="vlm",
        n_layers=28,
        d_model=1536,
        n_heads=12,
        n_kv_heads=2,
        head_dim=128,
        d_ff=8960,
        vocab_size=151936,
        pattern=((ATTN, FFN_DENSE),),
        input_kind="embeds",
        qkv_bias=True,
        rope="mrope",
        mrope_sections=(16, 24, 24),  # t,h,w split of head_dim/2 = 64
        rope_theta=1_000_000.0,
        source="arXiv:2409.12191 (Qwen2-VL-2B)",
    )
)
