"""Xing4.0-29B-A4B (29B, 4B active): 40 layers of q-LoRA MLA, each
sublayer inside a 4-stream manifold-constrained hyper-connection (mHC)
residual, the first two with a dense SwiGLU, the other 38 with a
sigmoid-routed MoE of 64 experts (top-4, one shared).
[huggingface.co/XingChen-AGI/Xing4.0-29B-A4B config.json; mHC:
DeepSeek-AI, "mHC: Manifold-Constrained Hyper-Connections" (2025-12)]

The port's own config (the reference has no such model).  The layout is
the dense prefix (layers 1-2: MLA and a dense FFN of
``intermediate_size``) and one group pattern of (MLA, MoE) over the 38
layers after it.  ``head_dim`` 112 is ``hidden_size /
num_attention_heads``; no layer runs plain attention, so it sizes
nothing.  The q latent (``q_lora_rank`` 768) and the kv latent (512) each
pass an RMSNorm, as DeepSeek-V3's do.  ``hc_mult`` 4 streams is the
published key; its ``hc_sinkhorn_iters`` 20, ``hc_eps`` 1e-6 and the
clamp of ``h_res`` to [-30, 30] (``mhc_h_res_clamp_*``) are
``models/hyper.py``'s constants.

Departures, as the other MLA configs': no YaRN (plain RoPE at
``rope_theta``), expert capacity, the router's selection bias drawn as
zeros; the multi-token-prediction module is neither held nor run.

``xing4.0-29b-a4b-ep4`` is one card's share of the model served expert
parallel over four cards: experts 0-15 of each layer's 64 held, the
router 64 wide with its top-4, the shared expert and every other weight
whole.
"""

from dataclasses import replace

from repro_torch.configs.base import (
    FFN_MOE,
    MLA,
    MLAConfig,
    ModelConfig,
    MoEConfig,
    register,
)

XING4 = register(
    ModelConfig(
        name="xing4.0-29b-a4b",
        family="moe",
        n_layers=40,
        d_model=3584,
        n_heads=32,
        n_kv_heads=32,  # MLA: all heads read the shared latent
        head_dim=112,
        d_ff=9216,  # the dense prefix layers' FFN
        vocab_size=131072,
        pattern=((MLA, FFN_MOE),),
        first_k_dense=2,
        prefix_mixer=MLA,
        moe=MoEConfig(
            n_experts=64,
            top_k=4,
            n_shared_experts=1,
            d_ff_expert=1024,
            router="sigmoid",
            routed_scale=2.0,
        ),
        mla=MLAConfig(
            kv_lora_rank=512,
            q_lora_rank=768,
            rope_head_dim=64,
            nope_head_dim=128,
            v_head_dim=128,
            latent_norms=True,
        ),
        hc_mult=4,
        rope="rope",
        rope_theta=10_000.0,
        norm_eps=1e-6,
        source="huggingface.co/XingChen-AGI/Xing4.0-29B-A4B; "
        "mHC (DeepSeek-AI, 2025-12)",
    )
)

register(
    replace(
        XING4,
        name="xing4.0-29b-a4b-ep4",
        moe=replace(XING4.moe, n_held=16, held_offset=0),
    )
)
