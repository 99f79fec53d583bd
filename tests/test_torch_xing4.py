"""Xing4.0-29B-A4B on the port (``configs/xing4.py``, the mHC residual of
``models/hyper.py`` and kernel G's plain forms in ``kernels/mhc.py``,
q-LoRA MLA with its latent norms, the sigmoid router and held share of
``models/moe.py``) against the plain reference ``tests/ref_xing4.py``, on
seeded random weights at the ``-smoke`` size, in float32 on the CPU.

Each tolerance is written with its reason.
"""

from __future__ import annotations

import contextlib
import dataclasses

import pytest
import ref_xing4 as ref
import torch

from repro_torch.configs.base import (
    ASSIGNED,
    FFN_DENSE,
    FFN_MOE,
    MLA,
    PORT_ONLY,
    get_config,
    list_configs,
    param_count,
)
from repro_torch.kernels.mhc import mhc, mhc_post_plain, mhc_pre_plain, sinkhorn
from repro_torch.launch import serve
from repro_torch.models import attention, blocks, hyper, moe
from repro_torch.models.layers import mlp_apply, named_ranges, norm_apply
from repro_torch.models.model import Model, value_and_grad

ARCH = "xing4.0-29b-a4b-ep4"
F32 = torch.float32


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _cfg(arch=ARCH, **moe_kw):
    cfg = get_config(arch + "-smoke")
    if moe_kw:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe_kw))
    return cfg


def _params(cfg, seed=0):
    """The port's init with every site's bias, group scales and norm
    drawn away from their init (b 0, alpha and the norm 1), the latent
    norms too, and the routers' selection biases, so that each one
    changes the result."""
    params = Model(cfg, "cpu").init_params(seed)
    gen = _gen(seed + 1)

    def draw(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                if k == "bias":
                    v["b"].copy_(torch.randn(v["b"].shape, generator=gen) * 0.5)
                elif k in ("alpha", "norm", "q_norm", "kv_norm") and "scale" in v:
                    v["scale"].copy_(1 + 0.3 * torch.randn(v["scale"].shape, generator=gen))
                else:
                    draw(v)
            elif k == "b" and "phi" in tree:
                v.copy_(torch.randn(v.shape, generator=gen) * 0.5)

    draw(params)
    return params


# -- the config ----------------------------------------------------------------------
def test_config_layout_and_counts():
    """Two dense MLA layers, then 38 of MLA and a sigmoid top-4-of-64
    MoE; 80 mHC sites of 4 streams; ~29.5 B parameters (4.4 B active),
    ~9.42 B on one card's share of 16 experts; the smoke variant keeps
    every kind: the dense prefix, q-LoRA, 4 streams, 4 of 8 experts."""
    cfg = get_config("xing4.0-29b-a4b")
    kinds = cfg.layer_pattern
    assert len(kinds) == 40 and cfg.n_groups == 38
    assert all(m == MLA for m, _ in kinds)
    assert [f for _, f in kinds] == [FFN_DENSE] * 2 + [FFN_MOE] * 38
    assert cfg.hc_mult == 4
    assert (hyper.SINKHORN_ITERS, hyper.SINKHORN_EPS, hyper.RES_CLAMP) == (
        20, 1e-6, (-30.0, 30.0),
    )  # fmt: skip
    assert (cfg.mla.q_lora_rank, cfg.mla.latent_norms) == (768, True)
    assert param_count(cfg) == (29_506_359_408, 4_403_449_968)
    share = get_config(ARCH)
    assert (share.moe.n_experts, share.moe.n_held, share.moe.top_k) == (64, 16, 4)
    assert param_count(share)[0] == 9_424_031_856
    smoke = get_config(ARCH + "-smoke")
    assert [f for _, f in smoke.layer_pattern] == [FFN_DENSE] * 2 + [FFN_MOE] * 2
    m = smoke.moe
    assert (m.router, m.n_experts, m.n_held, smoke.hc_mult) == ("sigmoid", 8, 4, 4)
    assert smoke.mla.q_lora_rank and smoke.mla.latent_norms
    assert {"xing4.0-29b-a4b", ARCH} <= set(PORT_ONLY) <= set(list_configs())
    assert not set(PORT_ONLY) & set(ASSIGNED)


def test_mesh_and_planner_refuse_mhc():
    """The mesh paths and the planner raise for ``hc_mult > 0`` (the
    config without a held share: mHC alone is refused)."""
    from repro_torch.launch import dryrun
    from repro_torch.models.sharding import param_specs

    cfg = get_config("xing4.0-29b-a4b-smoke")
    assert cfg.moe.n_held == 0 and cfg.hc_mult == 4
    with pytest.raises(NotImplementedError, match="mHC"):
        param_specs(cfg, {"data": 2, "model": 2})
    with pytest.raises(NotImplementedError, match="mHC"):
        dryrun.run_pair(cfg, "train_4k", mesh={"data": 1, "model": 1})


# -- the mHC site ----------------------------------------------------------------------
def test_sinkhorn_matches_a_float64_loop():
    """20 alternations in float32 against the same loop in float64, on
    exponentials of logits up to the clamp's 30 (rows and columns of very
    different sizes, which 20 alternations do not bring to balance):
    within 1e-5 (entries at most 1; float32 on one side).  The columns,
    normalised last, sum to 1 within 1e-5; at logits of unit size the
    rows too, within 1e-3."""
    for spread, rows in ((10.0, None), (1.0, 1e-3)):
        logits = (torch.randn(64, 4, 4, generator=_gen(3)) * spread).clamp(-30, 30)
        got = sinkhorn(torch.exp(logits))
        want = ref.sinkhorn(torch.exp(logits.double()), 20, 1e-6)
        assert float((got.double() - want).abs().max()) <= 1e-5
        assert float((got.sum(-2) - 1).abs().max()) <= 1e-5
        if rows is not None:
            assert float((got.sum(-1) - 1).abs().max()) <= rows


def test_site_plain_forms_match_the_reference():
    """``mhc_pre_plain``/``mhc_post_plain`` (what the CPU runs and G is
    held to) against the reference's site at the smoke width: u, H_post,
    H_res and the new stream within 1e-6 of their scale (float32, the
    same operations grouped otherwise)."""
    cfg = _cfg()
    c = ref.hyper(cfg)
    p = _params(cfg)["groups"]["b0"]["hc1"]
    p = {k: (v[0] if not isinstance(v, dict) else {kk: vv[0] for kk, vv in v.items()})
         for k, v in p.items()}  # fmt: skip
    x = torch.randn(6, 4, cfg.d_model, generator=_gen(4))
    y = torch.randn(6, cfg.d_model, generator=_gen(5))
    u, h_post, h_res = mhc_pre_plain(
        x, p["phi"]["w"], p["alpha"]["scale"], p["b"], p["norm"]["scale"],
        norm_eps=cfg.norm_eps,
    )  # fmt: skip
    w_pre, w_post, w_res = ref.site_coefficients(c, p, x)
    out = mhc_post_plain(x, y, h_post, h_res)
    want_out, _ = ref.site(c, p, x, lambda _: (y, None))
    pairs = ((u, (w_pre[..., None] * x).sum(-2)), (h_post, w_post), (h_res, w_res),
             (out, want_out))  # fmt: skip
    for got, want in pairs:
        assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())


def test_cpu_route_is_the_plain_form_and_counted():
    """On the CPU each site runs the plain forms, counted as ``plain``
    once a site (one ``pre``), no launch: a forward of the smoke model
    runs 2 sites a layer."""
    cfg = _cfg()
    model = Model(cfg, "cpu")
    routes, launches = dict(mhc.calls_by_route), mhc.launches
    model.prefill_step(_params(cfg), {"tokens": torch.zeros(2, 9, dtype=torch.long)})
    assert mhc.calls_by_route == {**routes, "plain": routes["plain"] + 2 * cfg.n_layers}
    assert mhc.launches == launches


@pytest.mark.parametrize("on", [False, True])
def test_named_ranges_only_when_turned_on(on):
    """``mhc.pre`` and ``mhc.post`` (and ``moe.held``) appear on the
    profiler's timeline only inside ``named_ranges()``."""
    cfg = _cfg()
    model = Model(cfg, "cpu")
    prompt = torch.zeros(2, 9, dtype=torch.long)
    want = {"mhc.pre", "mhc.post", "moe.held"}
    with torch.profiler.profile() as prof:
        with named_ranges() if on else contextlib.nullcontext():
            serve.generate(model, _params(cfg), prompt, 1)
    names = {e.name for e in prof.events()}
    assert (want <= names) if on else not (want & names)


def _block_before(cfg, p, x, mixer, ffn, mode, positions):
    """``blocks.block_apply`` on one card as it was before mHC came,
    operation for operation (MLA mixers)."""
    h = norm_apply(cfg, p["norm1"], x)
    y, cache = attention.mla_apply(cfg, p["mixer"], h, mode=mode, positions=positions)
    x = x + y
    h = norm_apply(cfg, p["norm2"], x)
    if ffn == FFN_DENSE:
        return x + mlp_apply(cfg, p["ffn"], h), cache, None
    y, aux = moe.moe_apply(cfg, p["ffn"], h, mode=mode)
    return x + y, cache, aux


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "xing4.0-29b-a4b"])
def test_hc_off_leaves_a_block_bit_for_bit(arch):
    """``hc_mult = 0`` (DeepSeek's, and Xing's own layers with one
    stream): a dense and an MoE block give the same bits as the block
    before mHC, and hold no site."""
    cfg = dataclasses.replace(get_config(arch + "-smoke"), hc_mult=0)
    gen = _gen(6)
    x = torch.randn(2, 9, cfg.d_model, generator=gen)
    pos = torch.arange(9)[None].expand(2, 9)
    for ffn in (FFN_DENSE, FFN_MOE):
        p = blocks.block_init(cfg, MLA, ffn, _gen(7))
        assert "hc1" not in p and "hc2" not in p
        got = blocks.block_apply(cfg, p, x, mixer=MLA, ffn=ffn, mode="prefill", positions=pos)
        want = _block_before(cfg, p, x, MLA, ffn, "prefill", pos)
        assert torch.equal(got[0], want[0])
        assert torch.equal(got[1]["ckv"], want[1]["ckv"])


# -- the whole model -----------------------------------------------------------------
def test_forward_matches_the_reference():
    """The teacher-forced forward's logits against the reference's over
    24 tokens: within 1e-4 of the logits' scale (float32; the MLA, the
    experts' products and the site's sums in another order)."""
    cfg = _cfg()
    model = Model(cfg, "cpu")
    params = _params(cfg)
    tokens = torch.randint(0, cfg.vocab_size, (2, 24), generator=_gen(8))
    got, _ = model.prefill_step(params, {"tokens": tokens})
    from repro_torch.models.model import forward, logits_fn

    with torch.no_grad():
        h, _, _ = forward(cfg, params, tokens, torch.arange(24)[None].expand(2, 24),
                          mode="train")  # fmt: skip
        logits = logits_fn(cfg, params, h)
    want = ref.forward_logits(ref.hyper(cfg), params, tokens)
    scale = float(want.abs().max())
    assert float((logits - want).abs().max()) <= 1e-4 * scale
    assert float((got - want[:, -1]).abs().max()) <= 1e-4 * scale


def test_prefill_then_decode_match_the_reference_forward():
    """``launch/serve.py::generate`` (``prefill_step``, the caches loaded
    into ``init_caches``' and 6 ``serve_step``s through the absorbed MLA
    and the latent cache) against the reference's forward over the
    prompt and the served tokens: every logit within 1e-4 of the logits'
    scale (float32; no pair dropped at capacity factor 16, so one call of
    every token routes as serving does)."""
    cfg = _cfg(capacity_factor=16.0)
    model = Model(cfg, "cpu")
    params = _params(cfg)
    prompt = torch.randint(0, cfg.vocab_size, (2, 21), generator=_gen(9))
    out = serve.generate(model, params, prompt, 6)
    seq = torch.cat([prompt, out.tokens[:, :-1].long()], 1)
    want = ref.forward_logits(ref.hyper(cfg), params, seq)[:, 20:]
    scale = float(want.abs().max())
    first, _ = model.prefill_step(params, {"tokens": prompt})
    assert float((first - want[:, 0]).abs().max()) <= 1e-4 * scale
    got = out.logits.transpose(0, 1)
    assert float((got - want[:, 1:]).abs().max()) <= 1e-4 * scale


def test_train_gradients_match_the_reference():
    """One train step's loss and every leaf's gradient (remat on, the
    port's default) against autograd through the reference: the loss
    within 1e-6 relative, each gradient within 1e-5 of its leaf's largest
    (float32 both sides; the Sinkhorn's 20 alternations, the MoE's
    grouped products and the norms' backward in another order)."""
    cfg = _cfg()
    model = Model(cfg, "cpu")
    params = _params(cfg)
    tokens = torch.randint(0, cfg.vocab_size, (2, 17), generator=_gen(10))
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    total, _, grads = value_and_grad(model.loss_fn, params, batch)
    live = _tree(lambda t: t.detach().clone().requires_grad_(True), params)
    want = ref.loss(ref.hyper(cfg), live, batch["tokens"], batch["labels"])
    want.backward()
    want_total = float(want.detach())
    assert abs(float(total) - want_total) <= 1e-6 * abs(want_total)
    checked = 0
    for path, g in _leaves(grads):
        w = _at(live, path).grad
        w = torch.zeros_like(g) if w is None else w
        assert float((g - w).abs().max()) <= 1e-5 * float(w.abs().max()), path
        checked += 1
    assert checked == len(_leaves(params))


def _tree(fn, tree):
    return {k: _tree(fn, v) for k, v in tree.items()} if isinstance(tree, dict) else fn(tree)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k], path + (k,))]
    return [(path, tree)]


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


# -- the held share ------------------------------------------------------------------
def test_held_shares_sum_to_the_uncut_layer():
    """Four shares of 2 experts of 8 (offsets 0, 2, 4, 6) of an MoE block's
    FFN site: each share's stream ``H_res X + H_post^T (shared + its
    experts)``, with what every card computes alike (``H_res X + H_post^T
    shared``) counted once, adds up to the stream of the layer holding
    all 8, and each share's MoE matches the reference's share; capacity
    drops included (factor 1.25 over 40 tokens), since every share ranks
    the pairs of all experts.  1e-5 of the scale (float32)."""
    whole = _cfg(n_held=0, held_offset=0)
    p = Model(whole, "cpu").init_params(7)["groups"]["b0"]
    p = _tree(lambda t: t[0], p)
    p["ffn"]["bias"]["b"].copy_(torch.randn(8, generator=_gen(8)) * 0.3)
    x = torch.randn(2, 20, 4, whole.d_model, generator=_gen(9))

    def ffn_site(cfg, ffn):
        u, coef = hyper.pre(cfg, p["hc2"], x)
        y, _ = moe.moe_apply(cfg, ffn, norm_apply(cfg, p["norm2"], u))
        return hyper.post(x, y, coef), u

    want_whole, u = ffn_site(whole, p["ffn"])
    h = norm_apply(whole, p["norm2"], u)
    _, coef = hyper.pre(whole, p["hc2"], x)
    common = hyper.post(x, moe.mlp_apply(whole, p["ffn"]["shared"], h), coef)
    total = common.clone()
    for off in (0, 2, 4, 6):
        cfg = _cfg(n_held=2, held_offset=off)
        share = dict(p["ffn"], w1=p["ffn"]["w1"][off : off + 2],
                     w3=p["ffn"]["w3"][off : off + 2], w2=p["ffn"]["w2"][off : off + 2])  # fmt: skip
        y, _ = moe.moe_apply(cfg, share, h)
        want, _ = ref.moe(ref.hyper(cfg), share, h)
        assert float((y - want).abs().max()) <= 1e-5 * float(want.abs().max())
        card, _ = ffn_site(cfg, share)
        total += card - common
    scale = float(want_whole.abs().max())
    assert float((total - want_whole).abs().max()) <= 1e-5 * scale
