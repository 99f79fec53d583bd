"""h2o-danube3-4b — llama+mistral mix with sliding-window attention.
[arXiv:2401.16818]  A copy of the reference's ``repro/configs/h2o_danube3.py``."""

from repro_torch.configs.base import ATTN, FFN_DENSE, ModelConfig, register

register(
    ModelConfig(
        name="h2o-danube-3-4b",
        family="dense",
        n_layers=24,
        d_model=3840,
        n_heads=32,
        n_kv_heads=8,
        head_dim=120,
        d_ff=10240,
        vocab_size=32000,
        pattern=((ATTN, FFN_DENSE),),
        sliding_window=4096,  # mistral-style SWA => sub-quadratic decode
        subquadratic=True,
        rope="rope",
        rope_theta=10_000.0,
        source="arXiv:2401.16818 (H2O-Danube); SWA per mistral lineage",
    )
)
