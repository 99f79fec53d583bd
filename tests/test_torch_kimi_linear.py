"""Kimi-Linear on the port (``configs/kimi_linear.py``, ``models/kda.py``,
the sigmoid router and held share of ``models/moe.py``, MLA without
positions) against the plain reference ``tests/ref_kimi_linear.py``, on
seeded random weights at the ``-smoke`` size, in float32 on the CPU.

Each tolerance is written with its reason; a KDA computed in bfloat16
(a relative error of ~4e-3 a product) fails each of the KDA ones by
tens of times.
"""

from __future__ import annotations

import contextlib
import dataclasses

import pytest
import ref_kimi_linear as ref
import torch

from repro_torch.configs.base import (
    ASSIGNED,
    KDA,
    MLA,
    PORT_ONLY,
    get_config,
    list_configs,
    param_count,
)
from repro_torch.kernels.kda_chunk import chunk_kda, kda_chunk
from repro_torch.kernels.kda_step import kda_step, kda_step_plain
from repro_torch.launch import serve
from repro_torch.models import attention, kda, moe
from repro_torch.models.kda import kda_apply
from repro_torch.models.layers import named_ranges
from repro_torch.models.model import Model, init_caches

ARCH = "kimi-linear-48b-a3b-ep4"
F32 = torch.float32


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _cfg(arch=ARCH, **moe_kw):
    cfg = get_config(arch + "-smoke")
    if moe_kw:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe_kw))
    return cfg


def _params(cfg, seed=0):
    """The port's init, the routers' selection biases drawn too (they
    start at zero) so that they change the choice."""
    params = Model(cfg, "cpu").init_params(seed)
    gen = _gen(seed + 1)

    def bias(tree):
        for k, v in tree.items():
            if k == "bias":
                v["b"].copy_(torch.randn(v["b"].shape, generator=gen) * 0.5)
            elif isinstance(v, dict):
                bias(v)

    bias(params)
    return params


# -- the config ----------------------------------------------------------------------
def test_config_layout_and_counts():
    """The published layer list, 1-based: MLA at 4, 8, ..., 24 and 27, KDA
    elsewhere, a dense FFN in layer 1; the parameter counts of the whole
    model (~49 B, 3.5 B active) and of one card's share (~13.8 B)."""
    cfg = get_config("kimi-linear-48b-a3b")
    kinds = cfg.layer_pattern
    assert len(kinds) == 27 and cfg.n_groups == 6
    mla_layers = [4, 8, 12, 16, 20, 24, 27]
    assert [i + 1 for i, (m, _) in enumerate(kinds) if m == MLA] == mla_layers
    assert [f for _, f in kinds] == ["dense"] + ["moe"] * 26
    assert all(m == KDA for i, (m, _) in enumerate(kinds) if i + 1 not in mla_layers)
    assert param_count(cfg) == (49_122_626_688, 3_484_404_864)
    share = get_config(ARCH)
    assert (share.moe.n_experts, share.moe.n_held, share.moe.top_k) == (256, 64, 8)
    assert param_count(share)[0] == 13_789_809_792
    smoke = get_config(ARCH + "-smoke")
    assert [m for m, _ in smoke.layer_pattern] == [KDA, KDA, MLA, KDA, MLA]
    m = smoke.moe
    assert (m.router, m.n_experts, m.n_held) == ("sigmoid", 8, 4)
    assert set(PORT_ONLY) <= set(list_configs()) and not set(PORT_ONLY) & set(ASSIGNED)


@pytest.mark.parametrize("on", [False, True])
def test_named_ranges_only_when_turned_on(on):
    """``kda.prefill``, ``kda.chunk``, ``kda.step`` and ``moe.held`` appear on the
    profiler's timeline only inside ``named_ranges()`` (which
    ``launch/profile_serve.py`` opens; the benchmark's trace would count
    their device-side annotations as operations), and are off again once
    the block ends."""
    cfg = _cfg()
    model = Model(cfg, "cpu")
    params = _params(cfg)
    prompt = torch.zeros(2, 9, dtype=torch.long)
    want = {"kda.prefill", "kda.chunk", "kda.step", "moe.held"}
    with torch.profiler.profile() as prof:
        with named_ranges() if on else contextlib.nullcontext():
            serve.generate(model, params, prompt, 1)
    names = {e.name for e in prof.events()}
    assert (want <= names) if on else not (want & names)
    with torch.profiler.profile() as after:
        serve.generate(model, params, prompt, 1)
    assert not want & {e.name for e in after.events()}


def test_device_summary_keeps_named_ranges_apart():
    """A profile's named ranges are listed apart, not counted as device
    operations or busy time (``experiments/profile.py::device_summary``,
    which ``launch/profile_serve.py`` prints)."""
    from types import SimpleNamespace

    from repro_torch.experiments.profile import device_summary

    cuda = torch.autograd.DeviceType.CUDA

    def row(key, us, count, annotation=False):
        return SimpleNamespace(key=key, device_type=cuda, self_device_time_total=us,
                               count=count, is_user_annotation=annotation)  # fmt: skip

    rows = [row("kda_step_kernel", 2e5, 20), row("kda.step", 9e5, 20, True)]
    prof = SimpleNamespace(key_averages=lambda: rows)
    out = device_summary(prof, 1.0)
    assert out["device_busy_s"] == pytest.approx(0.2) and out["device_ops"] == 20
    assert [r["name"] for r in out["top"]] == ["kda_step_kernel"]
    assert out["ranges"] == [{"name": "kda.step", "count": 20, "ms": 900.0}]
    plain = SimpleNamespace(key_averages=lambda: rows[:1])
    assert "ranges" not in device_summary(plain, 1.0)


def test_mesh_and_planner_refuse_kda():
    """The mesh paths and the planner raise rather than mis-plan."""
    from repro_torch.launch import dryrun
    from repro_torch.models.sharding import param_specs

    cfg = _cfg()
    with pytest.raises(NotImplementedError, match="KDA"):
        param_specs(cfg, {"data": 2, "model": 2})
    with pytest.raises(NotImplementedError, match="KDA"):
        dryrun.run_pair(cfg, "train_4k", mesh={"data": 1, "model": 1})


# -- KDA -------------------------------------------------------------------------------
def _kda_draw(b, s, h, d, seed):
    """Random normalised q (scaled), k, v, steep decays (exp of up to
    ~e^4: a 64-token chunk's cumulative decay reaches hundreds) and
    beta."""
    gen = _gen(seed)
    q, k, v = (torch.randn(b, s, h, d, generator=gen) for _ in range(3))
    q = ref._l2(q) * d**-0.5
    k = ref._l2(k)
    g = -torch.exp(2 * torch.randn(b, s, h, d, generator=gen)).clamp(max=60.0)
    beta = torch.rand(b, s, h, generator=gen)
    return q, k, v, g, beta


@pytest.mark.parametrize("s", [1, 63, 64, 65, 200])
def test_chunked_kda_matches_token_by_token(s):
    """The chunked form against the recurrence a token at a time: output
    and final state within 1e-4 of their largest magnitudes (float32 on
    both sides, the chunk's triangular solve and sums in another order:
    ~1e-5 seen), all finite under decays whose negation overflows."""
    q, k, v, g, beta = _kda_draw(2, s, 3, 32, seed=s)
    got, state = chunk_kda(q, k, v, g, beta, chunk=64)
    want, want_state = ref.recurrence(q, k, v, g, beta)
    assert torch.isfinite(got).all() and torch.isfinite(state).all()
    for a, b in ((got, want), (state, want_state)):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())


def _l2_today(x):
    """The mixer's L2 norm before the prefill moved to ``kernels/``."""
    return x * torch.rsqrt((x * x).sum(-1, keepdim=True) + 1e-6)


@pytest.mark.parametrize("dtype", [F32, torch.bfloat16])
def test_kda_chunk_cpu_route_is_the_plain_form(dtype):
    """On the CPU ``kda_chunk`` runs the plain form: bit for bit the L2
    norms, q's scale and ``chunk_kda`` as the mixer composed them, ``o``
    cast to the asked dtype; counted as ``plain``, no launch."""
    b, s, h, d = 2, 70, 3, 32
    gen = _gen(7)
    qkv = torch.randn(b, s, 3, h, d, generator=gen)
    g = -torch.exp(2 * torch.randn(b, s, h, d, generator=gen)).clamp(max=60.0)
    beta = torch.rand(b, s, h, generator=gen)
    routes, launches = dict(kda_chunk.calls_by_route), kda_chunk.launches
    o, state = kda_chunk(qkv, g, beta, d**-0.5, 64, dtype)
    assert kda_chunk.calls_by_route == {**routes, "plain": routes["plain"] + 1}
    assert kda_chunk.launches == launches
    q, k, v = qkv.unbind(2)
    q, k = _l2_today(q) * d**-0.5, _l2_today(k)
    want, want_state = chunk_kda(q, k, v, g, beta, chunk=64)
    assert o.dtype == dtype and torch.equal(o, want.to(dtype))
    assert torch.equal(state, want_state)


def test_kda_prefill_calls_kda_chunk_once_a_slice(monkeypatch):
    """The mixer's prefill runs ``kda_chunk`` once a slice of rows
    (``SLICE_BYTES`` of float32 q a slice: here two rows of five, so three
    calls), and the slices' outputs and caches equal one call over all
    rows (each row is its own recurrence)."""
    cfg = _cfg()
    p = _params(cfg)["prefix"]["l0"]["mixer"]
    x = torch.randn(5, 70, cfg.d_model, generator=_gen(8))
    whole_y, whole = kda_apply(cfg, p, x, mode="prefill")
    hk = cfg.kda.n_heads * cfg.kda.head_dim
    monkeypatch.setattr(kda, "SLICE_BYTES", 2 * 70 * hk * 4)
    before = kda_chunk.calls_by_route["plain"]
    y, cache = kda_apply(cfg, p, x, mode="prefill")
    assert kda_chunk.calls_by_route["plain"] == before + 3
    assert torch.allclose(y, whole_y, rtol=0, atol=1e-6 * float(whole_y.abs().max()))
    for key in ("state", "conv"):
        assert torch.allclose(cache[key], whole[key], rtol=0, atol=1e-6)


def test_fused_step_plain_matches_one_reference_step():
    """``kda_step_plain`` (what the CPU runs and the kernel is held to)
    against one step of the reference's recurrence from a random state:
    the state updated in place and ``o`` within 1e-5 of their largest
    (float32, the same products in another order)."""
    b, h, d = 3, 2, 32
    gen = _gen(5)
    state = torch.randn(b, h, d, d, generator=gen)
    qkv = torch.randn(b, 3, h, d, generator=gen)
    g = -torch.exp(torch.randn(b, h, d, generator=gen))
    beta = torch.rand(b, h, generator=gen)
    q, k, v = qkv.unbind(1)
    want, want_state = ref.recurrence(
        (ref._l2(q) * d**-0.5)[:, None], ref._l2(k)[:, None], v[:, None], g[:, None],
        beta[:, None], state.clone(),
    )  # fmt: skip
    mine = state.clone()
    before = kda_step.launches
    o = kda_step(mine, qkv, g, beta, d**-0.5)
    assert kda_step.launches == before  # the CPU runs the plain version
    for a, b in ((o, want[:, 0]), (mine, want_state)):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())
    again = state.clone()
    assert torch.equal(kda_step_plain(again, qkv, g, beta, d**-0.5), o)


def test_kda_layer_prefill_and_decode_match_the_reference():
    """A KDA layer (projections, short convolutions, gates, gated norm) on
    a 70-token prompt, then 5 decode steps through its cache, against the
    reference's layer over all 75 tokens: 1e-4 of the output's scale
    (float32 throughout)."""
    cfg = _cfg()
    p = _params(cfg)["prefix"]["l0"]["mixer"]
    x = torch.randn(2, 75, cfg.d_model, generator=_gen(3))
    want = ref.kda(ref.hyper(cfg), p, x)
    y, cache = kda_apply(cfg, p, x[:, :70], mode="prefill")
    outs = [y]
    for t in range(70, 75):
        yt, cache = kda_apply(cfg, p, x[:, t : t + 1], mode="decode", state=cache)
        outs.append(yt)
    got = torch.cat(outs, 1)
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


# -- the whole model -----------------------------------------------------------------
def test_prefill_then_decode_match_the_reference_forward():
    """``launch/serve.py::generate`` (``prefill_step``, the caches loaded
    into ``init_caches``' and 6 ``serve_step``s) against the reference's
    forward over the prompt and the served tokens: every logit within
    1e-4 of the logits' scale (float32; no pair dropped at capacity
    factor 16, so one call of every token routes as serving does)."""
    cfg = _cfg(capacity_factor=16.0)
    model = Model(cfg, "cpu")
    params = _params(cfg)
    prompt = torch.randint(0, cfg.vocab_size, (2, 70), generator=_gen(4))
    out = serve.generate(model, params, prompt, 6)
    seq = torch.cat([prompt, out.tokens[:, :-1].long()], 1)
    want = ref.forward_logits(ref.hyper(cfg), params, seq)[:, 69:]
    scale = float(want.abs().max())
    first, _ = model.prefill_step(params, {"tokens": prompt})
    assert float((first - want[:, 0]).abs().max()) <= 1e-4 * scale
    got = out.logits.transpose(0, 1)
    assert float((got - want[:, 1:]).abs().max()) <= 1e-4 * scale


def test_caches_hold_both_kinds():
    """One cache tree: the KDA layers' float32 state and convolution tail
    beside the MLA layers' latent cache, stacked per group; the prefill's
    caches load into it leaf for leaf."""
    cfg = _cfg()
    caches = init_caches(cfg, 2, 40, torch.device("cpu"))
    assert set(caches) == {"prefix", "groups", "suffix"}
    assert caches["prefix"]["l0"]["state"].shape == (2, 2, 32, 32)
    assert caches["prefix"]["l0"]["state"].dtype == F32
    assert caches["groups"]["b0"]["conv"].shape == (1, 2, 3, 3 * 2 * 32)
    assert set(caches["groups"]["b1"]) == {"ckv", "krope", "kpos"}
    assert caches["suffix"]["l1"]["ckv"].shape == (2, 40, 64)
    model = Model(cfg, "cpu")
    prompt = {"tokens": torch.zeros(2, 30, dtype=torch.long)}
    _, pre = model.prefill_step(_params(cfg), prompt)
    loaded = serve.load_prefill(caches, pre)
    assert torch.equal(loaded["prefix"]["l0"]["state"], pre["prefix"]["l0"]["state"])
    suffix_ckv = loaded["suffix"]["l1"]["ckv"]
    assert torch.equal(suffix_ckv[:, :30], pre["suffix"]["l1"]["ckv"])


# -- the router and the held share ---------------------------------------------------
def test_sigmoid_router_selects_by_score_plus_bias():
    """Selection by ``s + bias``, the gates the chosen ``s`` (no bias),
    renormalised and scaled by ``routed_scale``; a bias that favours
    expert 7 puts it in every token's choice."""
    cfg = _cfg()
    gen = _gen(6)
    x = torch.randn(16, cfg.d_model, generator=gen)
    w = torch.randn(cfg.d_model, 8, generator=gen) * 0.05
    bias = torch.zeros(8)
    bias[7] = 10.0
    gates, eidx, _ = moe._route(cfg, w, x, bias)
    s = torch.sigmoid(x @ w)
    assert (eidx == 7).any(-1).all()
    assert torch.equal(eidx, torch.topk(s + bias, 2, -1).indices)
    want = s.gather(-1, eidx)
    want = want / want.sum(-1, keepdim=True) * 2.446
    assert torch.allclose(gates, want, rtol=1e-6, atol=0)
    assert torch.allclose(gates.sum(-1), torch.full((16,), 2.446), rtol=1e-6)
    c = ref.hyper(cfg)
    ridx, rgates = ref.route(c, {"router": w, "bias": {"b": bias}}, x)
    assert torch.equal(ridx, eidx) and torch.allclose(rgates, gates, rtol=1e-6)


def test_held_shares_sum_to_the_uncut_layer():
    """Four shares of 2 experts of 8 (offsets 0, 2, 4, 6): their outputs,
    the shared expert counted once, add up to the layer holding all 8,
    and each matches the reference's share; capacity drops included
    (capacity factor 1.25 over 40 tokens), since every share ranks the
    pairs of all experts."""
    whole = _cfg(n_held=0, held_offset=0)
    p = Model(whole, "cpu").init_params(7)["suffix"]["l0"]["ffn"]
    p["bias"]["b"].copy_(torch.randn(8, generator=_gen(8)) * 0.3)
    x = torch.randn(2, 20, whole.d_model, generator=_gen(9))
    y_whole, _ = moe.moe_apply(whole, p, x)
    shared = moe.mlp_apply(whole, p["shared"], x)
    parts = []
    for off in (0, 2, 4, 6):
        cfg = _cfg(n_held=2, held_offset=off)
        share = dict(p, w1=p["w1"][off : off + 2], w3=p["w3"][off : off + 2],
                     w2=p["w2"][off : off + 2])  # fmt: skip
        y, _ = moe.moe_apply(cfg, share, x)
        want = ref.moe(ref.hyper(cfg), share, x)
        assert float((y - want).abs().max()) <= 1e-5 * float(want.abs().max())
        parts.append(y - shared)
    total = sum(parts) + shared
    assert float((total - y_whole).abs().max()) <= 1e-5 * float(y_whole.abs().max())


def _softmax_route_before(cfg, router_w, x_flat):
    """``moe._route``'s softmax path as it was before the sigmoid router
    came, operation for operation."""
    m = cfg.moe
    probs = torch.softmax(x_flat.to(F32) @ router_w, dim=-1)
    gates, eidx = torch.topk(probs, m.top_k, dim=-1)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    pe = probs.mean(0)
    flat = eidx.reshape(-1)
    counts = flat.new_zeros(m.n_experts).scatter_add_(0, flat, torch.ones_like(flat))
    fe = counts.to(F32) * (1.0 / (x_flat.shape[0] * m.top_k))
    aux = m.n_experts * torch.sum(fe * pe)
    return gates.to(x_flat.dtype), eidx, aux


def test_softmax_route_unchanged_on_a_fixed_input():
    """DeepSeek-V2-Lite's softmax router gives the same bits as before
    (gates, choice and router loss), and its layer holds every expert."""
    cfg = get_config("deepseek-v2-lite-16b-smoke")
    gen = _gen(10)
    x = torch.randn(33, cfg.d_model, generator=gen).to(torch.bfloat16)
    w = torch.randn(cfg.d_model, cfg.moe.n_experts, generator=gen) * 0.1
    got = moe._route(cfg, w, x)
    want = _softmax_route_before(cfg, w, x)
    for a, b in zip(got, want, strict=True):
        assert torch.equal(a, b)
    p = Model(cfg, "cpu").init_params(0)["groups"]["b0"]["ffn"]
    assert p["w1"].shape[1] == cfg.moe.n_experts and "bias" not in p


# -- MLA without positions -----------------------------------------------------------
def test_nope_mla_is_unchanged_by_positions():
    """With ``rope == "none"`` MLA rotates nothing: prefill outputs and
    caches, and a decode step's output, are the same bits at positions
    shifted by 1000; DeepSeek's rotary MLA is not."""
    for arch, same in ((ARCH, True), ("deepseek-v2-lite-16b", False)):
        cfg = get_config(arch + "-smoke")
        p = attention.mla_init(cfg, _gen(11))
        x = torch.randn(2, 9, cfg.d_model, generator=_gen(12))
        pos = torch.arange(9)[None].expand(2, 9)
        y0, c0 = attention.mla_apply(cfg, p, x, mode="prefill", positions=pos)
        y1, c1 = attention.mla_apply(cfg, p, x, mode="prefill", positions=pos + 1000)
        assert torch.equal(y0, y1) == same
        assert torch.equal(c0["krope"], c1["krope"]) == same
    cfg = get_config(ARCH + "-smoke")
    p = attention.mla_init(cfg, _gen(13))
    x = torch.randn(2, 1, cfg.d_model, generator=_gen(14))
    outs = []
    for shift in (0, 1000):
        cache = attention.mla_cache_init(cfg, 2, 1004, F32, torch.device("cpu"))
        cache["kpos"][:, shift : shift + 3] = torch.arange(3, dtype=torch.int32) + shift
        cache["ckv"][:, shift : shift + 3] = torch.randn(3, 64, generator=_gen(15))
        pos = torch.full((2, 1), 3 + shift)
        y, _ = attention.mla_apply(cfg, p, x, mode="decode", positions=pos, cache=cache)
        outs.append(y)
    # the same keys and values at other slots: equal but for the order of
    # the softmax's sums over the masked slots
    assert torch.allclose(outs[0], outs[1], rtol=1e-6, atol=1e-7)
