"""The Xing4.0 cell on the CPU at the port's smoke widths: its files and
their keys against the port's config, a whole run through the harness
(the reference's check of the window's served tokens), the float8
control and an altered answer read against the cell's limit, the new
counts by hand, and the three new readers on a hand-made profile."""

from __future__ import annotations

import json
from types import SimpleNamespace

import pytest

from perfbench.drivers import lm_common
from perfbench.harness import bench, runner
from perfbench.harness.profiling import Profile
from perfbench.roofline import xing4
from perfbench.roofline.peaks import H100
from repro_torch.models import hyper

CELL = "xing4.0-29b-a4b.decode_b128"
# xing4.0-29b-a4b-ep4-smoke: two dense MLA layers, then (MLA, MoE) twice;
# 4 of 8 experts held, top 2, 4 streams, float32
SMALL_XING = {
    "arch": "xing4.0-29b-a4b-ep4-smoke", "hidden_size": 256, "num_attention_heads": 4,
    "head_dim": 64, "intermediate_size": 512, "vocab_size": 512, "n_routed_experts": 8,
    "experts_held": 4, "num_experts_per_tok": 2, "n_shared_experts": 1,
    "moe_intermediate_size": 128, "q_lora_rank": 32, "kv_lora_rank": 64,
    "qk_rope_head_dim": 16, "qk_nope_head_dim": 32, "v_head_dim": 32, "dtype": "float32",
    "num_hidden_layers": 4,
}  # fmt: skip
SMALL = {"config": SMALL_XING, "traffic": {"batch": 3, "gen": 6, "cycle": [64, 32]}}


def test_the_cell_finds_its_files():
    cell = bench.load_cell(CELL)
    assert cell.chips == 1 and cell.traffic["batch"] == 128
    c = cell.config
    assert (c["n_routed_experts"], c["experts_held"], c["experts_published"]) == (64, 16, 64)
    names = {m.name for m in cell.per_layer}
    assert {"mhc_roofline", "mhc_share.xing_decode", "mfu.xing_decode"} <= names
    assert {"idle.decode", "ops_per_step.decode", "graph_share.decode"} <= names
    assert not {"mfu.decode", "rmsnorm_roofline.decode"} & names
    assert {m.name for m in cell.end_to_end} == {"gen_tok_per_s", "setup_s"}
    assert set(cell.limits) == {"token_gap_mean", "token_gap"}


def test_the_files_keys_are_what_the_port_runs():
    """``port_config`` holds every width it checks to the file; the keys
    it does not check (mHC's, the q latent's, the router's, the held
    share) are held here; every other published number is the
    catalog's, as published."""
    c = bench.load_cell(CELL).config
    cfg = lm_common.port_config(c)
    assert cfg.name == c["arch"] and cfg.n_layers == 40
    assert cfg.hc_mult == c["hc_mult"]
    assert hyper.SINKHORN_ITERS == c["hc_sinkhorn_iters"]
    assert hyper.SINKHORN_EPS == c["hc_eps"]
    assert hyper.RES_CLAMP == (c["mhc_h_res_clamp_min"], c["mhc_h_res_clamp_max"])
    assert cfg.mla.q_lora_rank == c["q_lora_rank"] and cfg.mla.latent_norms
    m = cfg.moe
    assert (m.router, m.routed_scale) == (c["scoring_func"], c["routed_scaling_factor"])
    assert (m.n_held, m.held_offset) == (c["experts_held"], c["experts_offset"])
    assert cfg.norm_eps == c["rms_norm_eps"] and cfg.vocab_size == c["vocab_size"]
    assert c["port_layout"] == {"prefix": c["first_k_dense_replace"], "period": 1, "suffix": 0}
    assert c["reduced"] == ["experts_held"]
    assert json.dumps(c["rope_scaling"], sort_keys=True) == json.dumps(
        {"beta_fast": 32, "beta_slow": 1, "factor": 64, "mscale": 1, "mscale_all_dim": 1,
         "original_max_position_embeddings": 4096, "type": "yarn"}, sort_keys=True,
    )  # fmt: skip


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


def test_xing_counts_by_hand():
    """The served work and G's bytes against the widths."""
    c = bench.load_cell(CELL).config
    d, h = 3584, 32
    mla = d * 768 + 768 * h * 192 + d * 512 + d * 64 + 512 * h * 128 * 2 + h * 128 * d
    assert xing4.mla_matmul_params(c) == mla == 28_409_856
    assert xing4.ffn_matmul_params(c, "dense") == 3 * d * 9216
    # the router, the shared expert, 4 routed experts at a quarter's share
    moe = d * 64 + 3 * d * 1024 + 0.25 * 4 * 3 * d * 1024
    assert xing4.ffn_matmul_params(c, "moe") == pytest.approx(moe)
    site = 2 * 4 * d * 24 + 2 * 4 * d + 2 * 4 * d * 5
    assert xing4.site_flops(c) == site and xing4.sites(c) == 80
    keys = 100
    per_key = 2 * h * (192 + 128)
    want = 40 * (2 * mla + per_key * keys) + 2 * 2 * 3 * d * 9216 + 38 * 2 * moe + 80 * site
    assert xing4.token_flops(c, keys) == pytest.approx(want)
    head = 2 * d * 131072
    t = {"batch": 2, "gen": 3, "cycle": [5, 7]}
    first = xing4.prefill_flops(c, 2, 5)
    assert first == pytest.approx(2 * 5 * xing4.token_flops(c, 3.0) + 2 * head)
    step1 = 2 * (xing4.token_flops(c, 6) + head)
    assert xing4.served_flops(c, t, 1) == pytest.approx(first + step1)
    # a site over 128 rows: the bf16 stream (3,670,016 B) read by pre, read
    # and written by post; u and y (917,504 B each); phi and the norm's
    # scale (14,336 x 25 float32); H_post and H_res written and read
    stream, uy, coef = 128 * 4 * d * 2, 128 * d * 2, 128 * 20 * 4
    assert xing4.site_bytes(c, 128) == 3 * stream + 2 * uy + 14336 * 25 * 4 + 2 * coef
    assert xing4.site_kernel_flops(c, 128) == 128 * (site + 2 * 4 * d)


def _run(ops, busy_s=1.0, units=16):
    cell = bench.load_cell(CELL)
    prof = Profile(window_s=2.0, busy_s=busy_s, units=units, ops=ops)
    profiler = SimpleNamespace(profile=prof)
    return SimpleNamespace(cell=cell, profile=prof, profiler=profiler,
                           device=SimpleNamespace(type="cuda"), window={"batch": 128})  # fmt: skip


def test_the_readers_on_a_hand_made_profile(monkeypatch):
    """G's share of the busy time and its roofline over the launches of
    16 steps (two a site, 80 sites a step); nothing where the count is
    another; the whole step's share of the peak over the unprofiled
    steps."""
    cell = bench.load_cell(CELL)
    roof = cell.metric_reader("mhc_roofline")
    share = cell.metric_reader("mhc_share.xing_decode")
    monkeypatch.setattr(roof, "peaks", lambda dev: H100)
    ops = {"void mhc_pre_kernel<bf16, 1>": [16 * 80, 0.02],
           "void mhc_post_kernel<bf16>": [16 * 80, 0.03], "gemm": [99, 0.5]}  # fmt: skip
    run = _run(ops)
    assert share.read(run) == pytest.approx(5.0)
    c = cell.config
    bound = max(
        16 * 80 * xing4.site_kernel_flops(c, 128) / H100["fp32_flops"],
        16 * 80 * xing4.site_bytes(c, 128) / H100["hbm_bytes"],
    )
    assert roof.read(run) == pytest.approx(100 * bound / 0.05)
    ops["void mhc_post_kernel<bf16>"][0] -= 1
    assert roof.read(_run(ops)) is None
    mfu = cell.metric_reader("mfu.xing_decode")
    monkeypatch.setattr(mfu, "peaks", lambda dev: H100)
    log = [(10.0 + i, i + 1, 0.0) for i in range(70)]
    run = SimpleNamespace(cell=cell, device=None, window={"log": log, "t0": 10.0},
                          profiler=SimpleNamespace(started_at=74.5))  # fmt: skip
    flops = xing4.served_flops(c, cell.traffic, 65)
    assert mfu.read(run) == pytest.approx(100 * flops / (64.0 * H100["bf16_flops"]))
