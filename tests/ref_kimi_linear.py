"""The tests' plain reference of Kimi-Linear-48B-A3B (not a test module):
the published definition in float32, every sequence whole, the KDA
recurrence a token at a time, with no chunking, no cache and no batching
tricks.  It imports nothing of the port; it reads the port's parameter
tree by its names (``perfbench/configs/kimi-linear-48b-a3b-ep4.json``'s
``params``) and its hyper-parameters from a dict with the published
keys (:func:`hyper` builds it from a config object's attributes).

It follows the port's listed departures: each expert keeps at most
``ceil(top_k T capacity_factor / num_experts)`` of a call's pairs, in
token order, and the MLA latent has no RMSNorm.  A held share
(``experts_held`` from ``experts_offset``) computes its own experts'
part; the shared expert runs whole.

Per layer: ``x + mixer(RMSNorm(x))``, then ``x + ffn(RMSNorm(x))``.
KDA, per head::

    q, k, v = SiLU(ShortConv(x W_q)), SiLU(ShortConv(x W_k)),
              SiLU(ShortConv(x W_v))
    q <- q / |q| * d_k ** -0.5,  k <- k / |k|        (|x| = sqrt(sum x^2 + 1e-6))
    g = -exp(A_log) * softplus(x W_f_down W_f_up + dt_bias),  beta = sigmoid(x W_b)
    S_t = (I - beta_t k_t k_t^T) Diag(exp(g_t)) S_{t-1} + beta_t k_t v_t^T
    o_t = S_t^T q_t
    y = (RMSNorm(o) * sigmoid(x W_g_down W_g_up + b_g)) W_o

MLA without positions (the rope part a plain projection); the MoE's
sigmoid router: the top-k of ``s + bias``, the chosen ``s`` renormalised
and scaled by ``routed_scaling_factor``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

F32 = torch.float32
L2_EPS = 1e-6


def hyper(cfg) -> dict:
    """The published keys of a Kimi-Linear config object (the port's
    ``ModelConfig``, read by attribute)."""
    kinds = [m for m, _ in cfg.layer_pattern]
    m = cfg.moe
    return {
        "hidden_size": cfg.d_model,
        "num_hidden_layers": cfg.n_layers,
        "first_k_dense_replace": cfg.first_k_dense,
        "num_attention_heads": cfg.n_heads,
        "kv_lora_rank": cfg.mla.kv_lora_rank,
        "qk_nope_head_dim": cfg.mla.nope_head_dim,
        "qk_rope_head_dim": cfg.mla.rope_head_dim,
        "v_head_dim": cfg.mla.v_head_dim,
        "linear_attn_config": {
            "num_heads": cfg.kda.n_heads,
            "head_dim": cfg.kda.head_dim,
            "short_conv_kernel_size": cfg.kda.conv_width,
            "kda_layers": [i + 1 for i, k in enumerate(kinds) if k == "kda"],
            "full_attn_layers": [i + 1 for i, k in enumerate(kinds) if k == "mla"],
        },
        "num_experts": m.n_experts,
        "num_experts_per_token": m.top_k,
        "routed_scaling_factor": m.routed_scale,
        "moe_renormalize": True,
        "capacity_factor": m.capacity_factor,
        "experts_held": m.n_held or m.n_experts,
        "experts_offset": m.held_offset,
        "rms_norm_eps": cfg.norm_eps,
        "port_layout": {
            "prefix": cfg.first_k_dense,
            "period": len(cfg.pattern),
            "suffix": len(cfg.suffix),
        },
    }


def rmsnorm(x, scale, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def swiglu(p, x):
    return (F.silu(x @ p["wg"]["w"]) * (x @ p["wi"]["w"])) @ p["wo"]["w"]


def _l2(x):
    return x * torch.rsqrt((x * x).sum(-1, keepdim=True) + L2_EPS)


def recurrence(q, k, v, g, beta, state=None):
    """The gated delta rule a token at a time: q, k, v, g [B, S, H, d]
    (q, k normalised), beta [B, S, H] -> (o [B, S, H, d], final state
    [B, H, d, d])."""
    b, s, h, d = q.shape
    if state is None:
        state = q.new_zeros((b, h, d, v.shape[-1]))
    eye = torch.eye(d, dtype=q.dtype, device=q.device)
    outs = []
    for t in range(s):
        kt, bt = k[:, t], beta[:, t][..., None, None]
        a = eye - bt * kt[..., :, None] * kt[..., None, :]  # I - beta k k^T
        decayed = torch.exp(g[:, t])[..., None] * state
        state = a @ decayed + bt * kt[..., None] * v[:, t][..., None, :]
        outs.append(torch.einsum("bhkv,bhk->bhv", state, q[:, t]))
    return torch.stack(outs, 1), state


def kda_inputs(c, p, x):
    """(q, k, v, g, beta) of a KDA layer: q, k normalised, q scaled."""
    la = c["linear_attn_config"]
    b, s, _ = x.shape
    h, dk, width = la["num_heads"], la["head_dim"], la["short_conv_kernel_size"]
    padded = F.pad(x @ p["wqkv"]["w"], (0, 0, width - 1, 0))
    conv = sum(padded[:, j : j + s] * p["conv"]["w"][j] for j in range(width))
    q, k, v = F.silu(conv).reshape(b, s, 3, h, dk).unbind(2)
    z = (x @ p["f_a"]["w"]) @ p["f_b"]["w"] + p["dt_bias"]
    g = -torch.exp(p["a_log"]).reshape(h, 1) * F.softplus(z).reshape(b, s, h, dk)
    beta = torch.sigmoid(x @ p["b"]["w"])
    return _l2(q) * dk**-0.5, _l2(k), v, g, beta


def kda(c, p, x):
    b, s, _ = x.shape
    o, _ = recurrence(*kda_inputs(c, p, x))
    o = rmsnorm(o, p["o_norm"]["scale"], c["rms_norm_eps"])
    gate = torch.sigmoid((x @ p["g_a"]["w"]) @ p["g_b"]["w"] + p["g_b"]["b"])
    return (o.reshape(b, s, -1) * gate) @ p["wo"]["w"]


def mla(c, p, x):
    b, s, _ = x.shape
    h = c["num_attention_heads"]
    nope, rd, vd = c["qk_nope_head_dim"], c["qk_rope_head_dim"], c["v_head_dim"]
    q = (x @ p["wq"]["w"]).reshape(b, s, h, nope + rd)
    lat = x @ p["w_dkv"]["w"]
    kr = (x @ p["w_krope"]["w"])[:, :, None].expand(b, s, h, rd)
    k = torch.cat([(lat @ p["w_uk"]["w"]).reshape(b, s, h, nope), kr], -1)
    v = (lat @ p["w_uv"]["w"]).reshape(b, s, h, vd)
    sc = torch.einsum("bqhd,bkhd->bhqk", q, k) * (nope + rd) ** -0.5
    mask = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    pr = torch.softmax(sc.masked_fill(~mask, float("-inf")), -1)
    y = torch.einsum("bhqk,bkhd->bqhd", pr, v)
    return y.reshape(b, s, h * vd) @ p["wo"]["w"]


def route(c, p, xt):
    """(chosen experts [T, k], their gates [T, k]) of the sigmoid router."""
    scores = torch.sigmoid(xt @ p["router"])
    idx = torch.topk(scores + p["bias"]["b"], c["num_experts_per_token"], -1).indices
    gates = scores.gather(-1, idx)
    if c["moe_renormalize"]:
        gates = gates / gates.sum(-1, keepdim=True)
    return idx, gates * c["routed_scaling_factor"]


def moe(c, p, x):
    """One call of every token: this share's experts and the shared one."""
    b, s, d = x.shape
    xt = x.reshape(-1, d)
    k, e = c["num_experts_per_token"], c["num_experts"]
    cap = max(1, math.ceil(k * xt.shape[0] * c["capacity_factor"] / e))
    idx, gates = route(c, p, xt)
    y = swiglu(p["shared"], xt)
    seen = [0] * e
    for t in range(xt.shape[0]):  # pairs in token order, each its slot
        for j in range(k):
            ex = int(idx[t, j])
            seen[ex] += 1
            i = ex - c["experts_offset"]
            if seen[ex] > cap or not 0 <= i < c["experts_held"]:
                continue
            hid = F.silu(xt[t] @ p["w1"][i]) * (xt[t] @ p["w3"][i])
            y[t] = y[t] + gates[t, j] * (hid @ p["w2"][i])
    return y.reshape(b, s, d)


def layers(c):
    """(mixer, ffn, path, group) of each layer, as the benchmark's copy
    lays them out (``port_layout``)."""
    la, lay = c["linear_attn_config"], c["port_layout"]
    n = c["num_hidden_layers"]
    pre, per, suf = lay["prefix"], lay["period"], lay["suffix"]
    out = []
    for i in range(n):
        mixer = "kda" if i + 1 in la["kda_layers"] else "mla"
        ffn = "dense" if i < c["first_k_dense_replace"] else "moe"
        if i < pre:
            out.append((mixer, ffn, ("prefix", f"l{i}"), None))
        elif i >= n - suf:
            out.append((mixer, ffn, ("suffix", f"l{i - (n - suf)}"), None))
        else:
            g, j = divmod(i - pre, per)
            out.append((mixer, ffn, ("groups", f"b{j}"), g))
    return out


def _layer(params, path, g):
    sub = params
    for key in path:
        sub = sub[key]

    def one(t):
        if isinstance(t, dict):
            return {k: one(v) for k, v in t.items()}
        return (t if g is None else t[g]).to(F32)

    return one(sub)


def forward_logits(c, params, tokens):
    """Float32 logits [B, S, V] of every position."""
    with torch.no_grad():
        x = params["embed"]["tok"][tokens.long()].to(F32)
        eps = c["rms_norm_eps"]
        for mixer, ffn, path, g in layers(c):
            p = _layer(params, path, g)
            mix = kda if mixer == "kda" else mla
            x = x + mix(c, p["mixer"], rmsnorm(x, p["norm1"]["scale"], eps))
            h = rmsnorm(x, p["norm2"]["scale"], eps)
            x = x + (swiglu(p["ffn"], h) if ffn == "dense" else moe(c, p["ffn"], h))
        x = rmsnorm(x, params["final_norm"]["scale"].to(F32), eps)
        return x @ params["embed"]["head"]["w"].to(F32)
