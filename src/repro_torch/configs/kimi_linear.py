"""Kimi-Linear-48B-A3B (48B, 3B active): 20 Kimi Delta Attention layers
beside 7 MLA layers without positions, a sigmoid-routed MoE of 256
experts (top-8, one shared) in every layer but the first, whose FFN is
dense.  [arXiv:2510.26692; huggingface.co/moonshotai/Kimi-Linear-48B-A3B-Instruct
config.json]

The port's own config (the reference has no such model).  The published
layer list (1-based: MLA at 4, 8, ..., 24 and 27, KDA elsewhere) does not
tile; it is laid out as the dense prefix (layer 1: KDA and a dense FFN of
``intermediate_size``), six groups of (KDA, KDA, MLA, KDA) (layers 2-25)
and the suffix (KDA, MLA) (layers 26-27).  ``head_dim`` 72 is the
published attention head width (``hidden_size / num_attention_heads``);
no layer here runs plain attention, so it sizes nothing.

``kimi-linear-48b-a3b-ep4`` is one card's share of the model served
expert parallel over four cards: experts 0-63 of each layer's 256 held,
the router 256 wide with its top-8, the shared expert and every other
weight whole.
"""

from dataclasses import replace

from repro_torch.configs.base import (
    FFN_MOE,
    KDA,
    MLA,
    KDAConfig,
    MLAConfig,
    ModelConfig,
    MoEConfig,
    register,
)

KIMI_LINEAR = register(
    ModelConfig(
        name="kimi-linear-48b-a3b",
        family="hybrid",
        n_layers=27,
        d_model=2304,
        n_heads=32,
        n_kv_heads=32,
        head_dim=72,
        d_ff=9216,  # the dense first layer's FFN
        vocab_size=163840,
        pattern=((KDA, FFN_MOE), (KDA, FFN_MOE), (MLA, FFN_MOE), (KDA, FFN_MOE)),
        first_k_dense=1,
        prefix_mixer=KDA,
        suffix=((KDA, FFN_MOE), (MLA, FFN_MOE)),
        moe=MoEConfig(
            n_experts=256,
            top_k=8,
            n_shared_experts=1,
            d_ff_expert=1024,
            router="sigmoid",
            routed_scale=2.446,
        ),
        mla=MLAConfig(
            kv_lora_rank=512,
            q_lora_rank=0,
            rope_head_dim=64,
            nope_head_dim=128,
            v_head_dim=128,
        ),
        kda=KDAConfig(n_heads=32, head_dim=128, conv_width=4, gate_rank=128, chunk=64),
        rope="none",  # mla_use_nope: the MLA layers rotate nothing
        rope_theta=10_000.0,
        norm_eps=1e-5,
        subquadratic=True,  # 20 of 27 mixers hold a fixed state
        source="arXiv:2510.26692 (Kimi Linear); "
        "moonshotai/Kimi-Linear-48B-A3B-Instruct",
    )
)

register(
    replace(
        KIMI_LINEAR,
        name="kimi-linear-48b-a3b-ep4",
        moe=replace(KIMI_LINEAR.moe, n_held=64, held_offset=0),
    )
)
