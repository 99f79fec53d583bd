"""The operation and byte counts against sums by hand for small shapes."""

from __future__ import annotations

import pytest

from perfbench.roofline import dqn, lm
from perfbench.roofline.peaks import H100, float32_peak, roofline_share

DQN = {"box_size": [4, 4, 4], "conv_features": [2, 3], "hidden": [5], "n_actions": 6,
       "batch_size": 2}  # fmt: skip


def test_dqn_forward_flops():
    # conv0: 2^3 outputs x 2 x 1 x 27; conv1: 1 output x 3 x 2 x 27;
    # loc 3 x 16; fc0 (3 + 16) x 5; fc1 5 x 6; each x 2
    hand = 2 * (8 * 2 * 1 * 27 + 1 * 3 * 2 * 27 + 3 * 16 + 19 * 5 + 5 * 6)
    assert dqn.forward_flops(DQN) == hand
    assert dqn.agent_step_flops(DQN) == 4 * 2 * hand


def test_fleet_kernel_bytes():
    width = 2 * 64 + 9
    assert dqn.row_width(DQN) == width
    assert dqn.replay_gather_bytes(DQN, 3) == 3 * (2 * 4 * width + 8)
    # n=2, B=2, A=6: reads q, q_next (2*2*6 each) and 3 columns (2*2*3);
    # writes loss rows and dq (2*2 each), loss (2), grad_q (2*2*6)
    assert dqn.fused_td_bytes(DQN, 2) == 4 * (24 + 24 + 12 + 4 + 4 + 2 + 24)


LM = {
    "hidden_size": 8, "num_attention_heads": 2, "head_dim": 4, "intermediate_size": 16,
    "qk_nope_head_dim": 4, "qk_rope_head_dim": 2, "v_head_dim": 4, "kv_lora_rank": 3,
    "moe_intermediate_size": 5, "num_experts_per_tok": 2, "n_routed_experts": 4,
    "n_shared_experts": 1, "vocab_size": 11, "first_k_dense_replace": 1, "num_hidden_layers": 2,
}  # fmt: skip


def test_lm_params_per_token():
    dense = 4 * 8 * 2 * 4 + 3 * 8 * 16
    mla = 8 * 2 * 6 + 8 * 3 + 8 * 2 + 3 * 2 * 4 + 3 * 2 * 4 + 2 * 4 * 8
    moe = 8 * 4 + 2 * 3 * 8 * 5 + 3 * 8 * 5
    assert lm.matmul_params_per_token(LM) == 8 * 11 + dense + mla + moe


def test_lm_attention_and_train_flops():
    # dense layer: 2 heads x (4 + 4) dims; MLA layer: 2 heads x (6 + 4)
    per_key = 2 * 2 * 8 + 2 * 2 * 10
    assert lm.attention_flops_forward(LM, 3.0) == per_key * 3.0
    seq = 5
    want = 6 * lm.matmul_params_per_token(LM) + 3 * per_key * (seq + 1) / 2
    assert lm.train_flops_per_token(LM, seq) == pytest.approx(want)


def test_lm_prefill_and_decode_flops():
    p, head = lm.matmul_params_per_token(LM), 8 * 11
    per_key = 2 * 2 * 8 + 2 * 2 * 10
    want = 2 * (p - head) * 3 * 4 + 2 * head * 3 + per_key * 3 * 4 * 5 / 2
    assert lm.prefill_flops(LM, 3, 4) == pytest.approx(want)
    assert lm.forward_flops(LM, 3, 12) == 2 * p * 3 + per_key * 12


def test_rmsnorm_counts():
    assert lm.rmsnorm_bytes(LM, 3) == 2 * 3 * 8 * 2 + 4 * 8
    assert lm.rmsnorm_launches_per_forward(LM) == 5
    assert lm.rmsnorm_launches_per_train_step(LM) == 5 + 2


def test_roofline_share():
    p = H100
    assert float32_peak(p, False) == 67e12 and float32_peak(p, True) == 495e12
    # 3.35e6 bytes take 1 us at the bandwidth: in 2 us, a 50 % share
    assert roofline_share(0.0, 3.35e6, 2e-6, p, 1.0) == pytest.approx(50.0)
    assert roofline_share(989e6, 0.0, 4e-6, p, p["bf16_flops"]) == pytest.approx(25.0)
