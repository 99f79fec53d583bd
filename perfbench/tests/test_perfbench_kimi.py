"""The Kimi-Linear cell on the CPU at the port's smoke widths: its files,
a whole run through the harness (the reference's check of the window's
served tokens), the float8 control and an altered answer read against
the cell's limit, and the new counts by hand."""

from __future__ import annotations

import pytest

from perfbench.harness import bench, runner
from perfbench.roofline import kda, kimi_linear

CELL = "kimi-linear-48b-a3b.decode_b128"
# kimi-linear-48b-a3b-ep4-smoke: a KDA dense prefix, (KDA, MLA) once,
# then the suffix (KDA, MLA); 4 of 8 experts held, top 2, float32
SMALL_KIMI = {
    "arch": "kimi-linear-48b-a3b-ep4-smoke", "hidden_size": 256,
    "num_attention_heads": 4, "head_dim": 64, "intermediate_size": 512,
    "vocab_size": 512, "n_routed_experts": 8, "num_experts": 8, "experts_held": 4,
    "num_experts_per_tok": 2, "num_experts_per_token": 2, "n_shared_experts": 1,
    "num_shared_experts": 1, "moe_intermediate_size": 128, "kv_lora_rank": 64,
    "qk_rope_head_dim": 16, "qk_nope_head_dim": 32, "v_head_dim": 32,
    "dtype": "float32", "num_hidden_layers": 5, "kda_lowrank": 16,
    "linear_attn_config": {"num_heads": 2, "head_dim": 32, "short_conv_kernel_size": 4,
                           "kda_layers": [1, 2, 4], "full_attn_layers": [3, 5]},
    "port_layout": {"prefix": 1, "period": 2, "suffix": 2},
}  # fmt: skip
SMALL = {"config": SMALL_KIMI, "traffic": {"batch": 3, "gen": 6, "cycle": [64, 32]}}


def test_the_cell_finds_its_files():
    cell = bench.load_cell(CELL)
    assert cell.chips == 1 and cell.traffic["batch"] == 128
    assert cell.config["num_experts"] == 256 and cell.config["experts_held"] == 64
    names = {m.name for m in cell.per_layer}
    assert {"kda_step_roofline", "kda_share.kimi_decode", "mfu.kimi_decode"} <= names
    assert {"idle.decode", "ops_per_step.decode"} <= names
    assert {m.name for m in cell.end_to_end} == {"gen_tok_per_s", "setup_s"}
    assert "token_gap_mean" in cell.limits


def test_a_run_on_the_cpu_is_correct():
    """A whole run (set-up, one window of whole cycles, the reference's
    check) of the program at the smoke widths, float32 on both sides."""
    out = runner.run_cell(CELL, 2147483659, 0.0, False, device="cpu", overrides=SMALL)
    assert out["correct"], out["checks"]
    assert out["checks"]["token_gap_mean"]["value"] < 1e-4
    assert set(out["metrics"]) == {"gen_tok_per_s", "setup_s"}
    assert out["attempted"] == 3 * 2 and out["failed"] == 0


def test_the_control_and_a_fault_read_far_above_the_program():
    """The float8 control and an altered answer read at least ten times
    the program's gap at the smoke widths (the limit is the card's)."""
    kw = dict(device="cpu", overrides=SMALL)
    rows = runner.calibrate(CELL, [5], 0.0, control=True, **kw)
    prog = rows[0]["program"]["token_gap_mean"]
    ctrl = rows[0]["control"]["token_gap_mean"]
    bad = runner.calibrate(CELL, [5], 0.0, fault="altered", **kw)
    assert ctrl > 10 * max(prog, 1e-6)
    assert bad[0]["program"]["token_gap_mean"] > 10 * max(prog, 1e-6)


def test_kda_step_bytes_by_hand():
    c = bench.load_cell(CELL).config
    # per (sequence, head) at d 128 in bf16: the float32 state read and
    # written (131,072), q, k, v (768), the decay and beta (516), o (256)
    assert kda.kda_step_bytes(c, 1) == 32 * (131_072 + 768 + 516 + 256)
    assert kda.kda_layers(c) == 20


def test_kimi_flops_by_hand():
    c = dict(SMALL_KIMI, intermediate_size=16, num_experts_per_token=2, num_experts=8,
             experts_held=4, num_shared_experts=1, routed_scaling_factor=2.446,
             first_k_dense_replace=1)  # fmt: skip
    d, hk, r, h = 256, 64, 16, 2
    kda_p = 3 * d * hk + 2 * (d * r + r * hk) + d * h + hk * d
    assert kimi_linear.kda_matmul_params(c) == kda_p
    assert kimi_linear.kda_recurrence_flops(c) == 6 * h * 32 * 32
    mla_p = d * 4 * 48 + d * 64 + d * 16 + 64 * 4 * 32 + 64 * 4 * 32 + 4 * 32 * d
    assert kimi_linear.mla_matmul_params(c) == mla_p
    moe_p = d * 8 + 3 * d * 128 + 0.5 * 2 * 3 * d * 128
    assert kimi_linear.ffn_matmul_params(c, "moe") == pytest.approx(moe_p)
    keys = 10
    per_key = 2 * 4 * (32 + 16 + 32)
    want = (
        3 * (2 * kda_p + 6 * h * 32 * 32)
        + 2 * (2 * mla_p + per_key * keys)
        + 2 * 3 * d * 16
        + 4 * 2 * moe_p
    )
    assert kimi_linear.token_flops(c, keys) == pytest.approx(want)
    t = {"batch": 2, "gen": 3, "cycle": [5, 7]}
    head = 2 * d * 512
    first = kimi_linear.prefill_flops(c, 2, 5)
    assert first == pytest.approx(2 * 5 * kimi_linear.token_flops(c, 3.0) + 2 * head)
    step1 = 2 * (kimi_linear.token_flops(c, 6) + head)
    assert kimi_linear.served_flops(c, t, 1) == pytest.approx(first + step1)
    steps = sum(2 * (kimi_linear.token_flops(c, 5 + j) + head) for j in (1, 2, 3))
    whole = first + steps
    second = kimi_linear.prefill_flops(c, 2, 7)
    second += 2 * (kimi_linear.token_flops(c, 8) + head)
    assert kimi_linear.served_flops(c, t, 4) == pytest.approx(whole + second)
