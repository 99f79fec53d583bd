"""xLSTM-125M — alternating mLSTM / sLSTM blocks. [arXiv:2405.04517]
A copy of the reference's ``repro/configs/xlstm125m.py``.

d_ff=0: xLSTM blocks carry their own projections (mLSTM pre-up-projection
x2, sLSTM post gated FFN x4/3).
"""

from repro_torch.configs.base import (
    FFN_NONE,
    MLSTM,
    SLSTM,
    ModelConfig,
    XLSTMConfig,
    register,
)

register(
    ModelConfig(
        name="xlstm-125m",
        family="ssm",
        n_layers=12,
        d_model=768,
        n_heads=4,
        n_kv_heads=4,
        head_dim=192,
        d_ff=0,
        vocab_size=50304,
        pattern=((MLSTM, FFN_NONE), (SLSTM, FFN_NONE)),
        xlstm=XLSTMConfig(mlstm_proj_factor=2.0, slstm_ffn_factor=4.0 / 3.0),
        subquadratic=True,  # recurrent state, O(1) decode
        rope="none",
        source="arXiv:2405.04517 (xLSTM), 125M scale",
    )
)
