"""The tests' plain reference of Xing4.0-29B-A4B (not a test module): the
published definition in float32, every sequence whole, with no kernels,
no cache and no batching tricks.  It imports nothing of the port; it
reads the port's parameter tree by its names
(``perfbench/configs/xing4.0-29b-a4b-ep4.json``'s ``params``) and its
hyper-parameters from a dict with the published keys (:func:`hyper`
builds it from a config object's attributes).

It follows the port's listed departures: no YaRN (plain rotary at
``rope_theta``), each expert keeps at most ``ceil(top_k T
capacity_factor / n_routed_experts)`` of a call's pairs in token order,
and a held share (``experts_held`` from ``experts_offset``) computes its
own experts' part; the shared expert runs whole.

The residual is mHC with ``hc_mult = n`` rows (the configuration file's
``assumed`` lists what the published config leaves open).  Per sublayer
``F`` (each layer's MLA, then its FFN)::

    x_hat = RMSNorm_{nC}(vec X),  h = alpha (.) (x_hat phi) + b
    H_pre = sigmoid(h[:n]),  H_post = 2 sigmoid(h[n:2n])
    H_res = Sinkhorn(exp(clamp(h[2n:], lo, hi)))      (rows, then columns)
    X <- H_res X + H_post^T F(RMSNorm(H_pre X))

the embedding copied into the n rows at the start, the rows summed before
the final norm.  MLA with a q latent: ``q = RMSNorm(x W_dq) W_uq``, the kv
latent ``c = RMSNorm(x W_dkv)``, one shared rotary key ``x W_krope``,
rotate-half rotary on the rope parts, softmax scale ``(nope + rope) **
-0.5``.  The MoE's sigmoid router: the top-k of ``s + bias``, the chosen
``s`` renormalised (``norm_topk_prob``) and scaled by
``routed_scaling_factor``.  The training loss: the mean cross entropy
plus ``router_aux_weight`` times the layers' Switch losses ``E sum_e f_e
P_e`` (``P`` the scores normalised over the experts).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

F32 = torch.float32


def hyper(cfg) -> dict:
    """The published keys of a Xing4.0 config object (the port's
    ``ModelConfig``, read by attribute)."""
    m, a = cfg.moe, cfg.mla
    return {
        "hidden_size": cfg.d_model,
        "num_hidden_layers": cfg.n_layers,
        "first_k_dense_replace": cfg.first_k_dense,
        "num_attention_heads": cfg.n_heads,
        "q_lora_rank": a.q_lora_rank,
        "kv_lora_rank": a.kv_lora_rank,
        "qk_nope_head_dim": a.nope_head_dim,
        "qk_rope_head_dim": a.rope_head_dim,
        "v_head_dim": a.v_head_dim,
        "rope_theta": cfg.rope_theta,
        "n_routed_experts": m.n_experts,
        "num_experts_per_tok": m.top_k,
        "routed_scaling_factor": m.routed_scale,
        "norm_topk_prob": True,
        "capacity_factor": m.capacity_factor,
        "router_aux_weight": m.router_aux_weight,
        "experts_held": m.n_held or m.n_experts,
        "experts_offset": m.held_offset,
        "rms_norm_eps": cfg.norm_eps,
        "hc_mult": cfg.hc_mult,
        "hc_sinkhorn_iters": 20,
        "hc_eps": 1e-6,
        "mhc_h_res_clamp_min": -30.0,
        "mhc_h_res_clamp_max": 30.0,
    }


def rmsnorm(x, scale, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def swiglu(p, x):
    return (F.silu(x @ p["wg"]["w"]) * (x @ p["wi"]["w"])) @ p["wo"]["w"]


def rope(x, pos, theta):
    """x [B, S, H, D], pos [S]: rotate-half pairs, inverse frequencies
    ``theta ** (-i / half)``."""
    half = x.shape[-1] // 2
    inv = 1.0 / (theta ** (torch.arange(half, dtype=F32) / half))
    ang = pos.to(F32)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def mla(c, p, x):
    b, s, _ = x.shape
    h, eps = c["num_attention_heads"], c["rms_norm_eps"]
    nope, rd, vd = c["qk_nope_head_dim"], c["qk_rope_head_dim"], c["v_head_dim"]
    pos = torch.arange(s)
    q = rmsnorm(x @ p["w_dq"]["w"], p["q_norm"]["scale"], eps) @ p["w_uq"]["w"]
    q = q.reshape(b, s, h, nope + rd)
    q = torch.cat([q[..., :nope], rope(q[..., nope:], pos, c["rope_theta"])], -1)
    lat = rmsnorm(x @ p["w_dkv"]["w"], p["kv_norm"]["scale"], eps)
    kr = rope((x @ p["w_krope"]["w"])[:, :, None], pos, c["rope_theta"])
    k = torch.cat([(lat @ p["w_uk"]["w"]).reshape(b, s, h, nope), kr.expand(b, s, h, rd)], -1)
    v = (lat @ p["w_uv"]["w"]).reshape(b, s, h, vd)
    sc = torch.einsum("bqhd,bkhd->bhqk", q, k) * (nope + rd) ** -0.5
    mask = torch.ones(s, s, dtype=torch.bool).tril()
    pr = torch.softmax(sc.masked_fill(~mask, float("-inf")), -1)
    y = torch.einsum("bhqk,bkhd->bqhd", pr, v)
    return y.reshape(b, s, h * vd) @ p["wo"]["w"]


def route(c, p, xt):
    """(scores [T, E], chosen experts [T, k], their gates [T, k])."""
    scores = torch.sigmoid(xt @ p["router"])
    idx = torch.topk(scores + p["bias"]["b"], c["num_experts_per_tok"], -1).indices
    gates = scores.gather(-1, idx)
    if c["norm_topk_prob"]:
        gates = gates / gates.sum(-1, keepdim=True)
    return scores, idx, gates * c["routed_scaling_factor"]


def moe(c, p, x):
    """One call of every token: ``(this share's experts and the shared
    one, the call's Switch loss)``."""
    b, s, d = x.shape
    xt = x.reshape(-1, d)
    k, e = c["num_experts_per_tok"], c["n_routed_experts"]
    cap = max(1, math.ceil(k * xt.shape[0] * c["capacity_factor"] / e))
    scores, idx, gates = route(c, p, xt)
    parts = [swiglu(p["shared"], xt)]
    seen = [0] * e
    for t in range(xt.shape[0]):  # pairs in token order, each its slot
        row = torch.zeros_like(xt[t])
        for j in range(k):
            ex = int(idx[t, j])
            seen[ex] += 1
            i = ex - c["experts_offset"]
            if seen[ex] > cap or not 0 <= i < c["experts_held"]:
                continue
            hid = F.silu(xt[t] @ p["w1"][i]) * (xt[t] @ p["w3"][i])
            row = row + gates[t, j] * (hid @ p["w2"][i])
        parts.append(row)
    y = parts[0] + torch.stack(parts[1:])
    counts = torch.bincount(idx.reshape(-1), minlength=e).to(F32)
    probs = scores / scores.sum(-1, keepdim=True)
    aux = e * torch.sum(counts / (xt.shape[0] * k) * probs.mean(0))
    return y.reshape(b, s, d), aux


def sinkhorn(m, iters, eps):
    for _ in range(iters):
        m = m / (m.sum(-1, keepdim=True) + eps)
        m = m / (m.sum(-2, keepdim=True) + eps)
    return m


def site_coefficients(c, p, x):
    """(H_pre [.., n], H_post [.., n], H_res [.., n, n]) of the stream x
    [..., n, C]."""
    n = c["hc_mult"]
    v = x.reshape(*x.shape[:-2], -1)
    xh = rmsnorm(v, p["norm"]["scale"], c["rms_norm_eps"])
    a = p["alpha"]["scale"]
    scales = torch.cat([a[0].repeat(n), a[1].repeat(n), a[2].repeat(n * n)])
    h = (xh @ p["phi"]["w"]) * scales + p["b"]
    res = h[..., 2 * n :].clamp(c["mhc_h_res_clamp_min"], c["mhc_h_res_clamp_max"])
    m = torch.exp(res).reshape(*h.shape[:-1], n, n)
    return (
        torch.sigmoid(h[..., :n]),
        2 * torch.sigmoid(h[..., n : 2 * n]),
        sinkhorn(m, c["hc_sinkhorn_iters"], c["hc_eps"]),
    )


def site(c, p, x, fn):
    """One mHC site around the sublayer ``fn`` (its own pre-norm
    included): ``(the new stream, what fn returned beside its output)``."""
    h_pre, h_post, h_res = site_coefficients(c, p, x)
    u = (h_pre[..., None] * x).sum(-2)
    y, extra = fn(u)
    return h_res @ x + h_post[..., None] * y[..., None, :], extra


def layers(c):
    """(ffn, path, group) of each layer: the dense prefix ``prefix/l{i}``,
    then ``groups/b0`` group by group."""
    nd = c["first_k_dense_replace"]
    return [
        ("dense", ("prefix", f"l{i}"), None) if i < nd else ("moe", ("groups", "b0"), i - nd)
        for i in range(c["num_hidden_layers"])
    ]


def _layer(params, path, g):
    sub = params
    for key in path:
        sub = sub[key]

    def one(t):
        if isinstance(t, dict):
            return {k: one(v) for k, v in t.items()}
        return (t if g is None else t[g]).to(F32)

    return one(sub)


def hidden(c, params, tokens):
    """The final norm's output [B, S, C] and the sum of the Switch losses."""
    eps, n = c["rms_norm_eps"], c["hc_mult"]
    e = params["embed"]["tok"][tokens.long()].to(F32)
    x = e[:, :, None, :].expand(*e.shape[:2], n, e.shape[-1])
    aux = torch.zeros((), dtype=F32)
    for ffn, path, g in layers(c):
        p = _layer(params, path, g)

        def mixer(u, p=p):
            return mla(c, p["mixer"], rmsnorm(u, p["norm1"]["scale"], eps)), None

        def feed(u, p=p, ffn=ffn):
            h = rmsnorm(u, p["norm2"]["scale"], eps)
            return (swiglu(p["ffn"], h), None) if ffn == "dense" else moe(c, p["ffn"], h)

        x, _ = site(c, p["hc1"], x, mixer)
        x, a = site(c, p["hc2"], x, feed)
        if a is not None:
            aux = aux + a
    return rmsnorm(x.sum(-2), params["final_norm"]["scale"].to(F32), eps), aux


def forward_logits(c, params, tokens):
    """Float32 logits [B, S, V] of every position (no autograd)."""
    with torch.no_grad():
        x, _ = hidden(c, params, tokens)
        return x @ params["embed"]["head"]["w"].to(F32)


def loss(c, params, tokens, labels):
    """The training loss, differentiable in ``params``."""
    x, aux = hidden(c, params, tokens)
    logits = x @ params["embed"]["head"]["w"]
    nll = F.cross_entropy(logits.reshape(-1, logits.shape[-1]), labels.reshape(-1).long())
    return nll + c["router_aux_weight"] * aux
