"""The plain reference of Xing4.0-29B-A4B as the configuration file states
it runs (``configs/xing4.0-29b-a4b-ep4.json``: one card's share of the
expert-parallel deployment), in plain PyTorch, computed in float32 (TF32
off).  It imports nothing of the program; it reads the weights by the
parameter names the configuration file lists under ``params``.

Per token the stream ``X`` is ``hc_mult = n`` rows of ``hidden_size =
C``: the embedding row copied into each.  Each of the
``num_hidden_layers`` layers has two sites (the configuration's
``assumed`` says what the published config leaves open), one around its
MLA and one around its FFN::

    x_hat = RMSNorm_{nC}(vec X),  h = alpha (.) (x_hat phi) + b
    H_pre = sigmoid(h[:n]),  H_post = 2 sigmoid(h[n:2n])
    H_res = Sinkhorn(exp(clamp(h[2n:], mhc_h_res_clamp_min, _max)))
    X <- H_res X + H_post^T F(RMSNorm(H_pre X))

``Sinkhorn``: ``hc_sinkhorn_iters`` alternations of the rows' then the
columns' normalisation, each sum plus ``hc_eps``.  Then the rows summed,
a final RMSNorm and the output head.  Every RMSNorm takes
``rms_norm_eps``.

* MLA with a q latent: ``q = RMSNorm(x W_dq) W_uq`` of ``qk_nope_head_dim
  + qk_rope_head_dim`` a head, the kv latent ``c = RMSNorm(x W_dkv)`` of
  ``kv_lora_rank``, one shared key part ``x W_krope``; per-head keys ``c
  W_uk`` and values ``c W_uv``; rotary (rotate-half pairs, inverse
  frequencies ``rope_theta ** (-i / half)``, no YaRN: a departure) on the
  rope parts; causal softmax at scale ``(nope + rope) ** -0.5``,
  :data:`MLA_ROWS` sequences at a time.
* FFN: the first ``first_k_dense_replace`` layers a SwiGLU of
  ``intermediate_size``; every other layer a mixture of experts: scores
  ``s = sigmoid(x W_r)`` in float32 over all ``n_routed_experts``, the top
  ``num_experts_per_tok`` chosen by ``s + bias`` (the selection bias),
  their ``s`` renormalised (``norm_topk_prob``) and scaled by
  ``routed_scaling_factor``; this card's share, experts ``experts_offset
  .. experts_offset + experts_held``, each keeping the first ``capacity =
  max(1, ceil(k T cf / n_routed_experts))`` of the pairs routed to it in
  token order, call by call (a departure); pairs routed to the experts
  the card does not hold add nothing; SwiGLU experts of
  ``moe_intermediate_size``; ``n_shared_experts`` shared experts as one
  SwiGLU of that many times the width, whole.

The sites run :data:`SITE_ROWS` sequences at a time and write the new
stream over the old one, so that the float32 stream is held once.

``precision("fp8")`` is the control: every matrix product's operands,
the sites' projections included, rounded to float8 e4m3 with one scale a
tensor (its largest magnitude to 448), the products then in float32.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

F32 = torch.float32
MLA_ROWS = 16  # sequences a block of the MLA attention
SITE_ROWS = 16  # sequences a block of an mHC site
_PREC = {"mode": "fp32"}


def precision(mode: str) -> None:
    """``"fp32"`` (TF32 off) or ``"fp8"`` (the control)."""
    if mode not in ("fp32", "fp8"):
        raise ValueError(mode)
    _PREC["mode"] = mode
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _q(x: torch.Tensor) -> torch.Tensor:
    if _PREC["mode"] != "fp8":
        return x
    scale = x.abs().amax().clamp(min=1e-30) / 448.0
    return (x / scale).to(torch.float8_e4m3fn).to(F32) * scale


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _q(a) @ _q(b)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def swiglu(p: dict, x: torch.Tensor) -> torch.Tensor:
    return mm(F.silu(mm(x, p["wg"]["w"])) * mm(x, p["wi"]["w"]), p["wo"]["w"])


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x [B, S, H, D] at positions 0 .. S - 1."""
    s, half = x.shape[1], x.shape[-1] // 2
    inv = 1.0 / (theta ** (torch.arange(half, dtype=F32, device=x.device) / half))
    ang = torch.arange(s, dtype=F32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def attend(q, k, v, scale):
    """Causal softmax attention row by row: q, k [B, S, H, D], v [B, S, H,
    Dv]; a query sees the keys at its position and before."""
    outs = []
    s = q.shape[1]
    mask = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    for i in range(q.shape[0]):
        sc = torch.einsum("qhd,khd->hqk", _q(q[i]), _q(k[i])) * scale
        sc = sc.masked_fill(~mask[None], float("-inf"))
        outs.append(torch.einsum("hqk,khd->qhd", _q(torch.softmax(sc, -1)), _q(v[i])))
    return torch.stack(outs)


def mla(c: dict, p: dict, x: torch.Tensor) -> torch.Tensor:
    """q-LoRA latent attention, :data:`MLA_ROWS` sequences at a time."""
    out = []
    h, eps, theta = c["num_attention_heads"], c["rms_norm_eps"], c["rope_theta"]
    nope, rd, vd = c["qk_nope_head_dim"], c["qk_rope_head_dim"], c["v_head_dim"]
    for lo in range(0, x.shape[0], MLA_ROWS):
        xb = x[lo : lo + MLA_ROWS]
        b, s, _ = xb.shape
        ql = rmsnorm(mm(xb, p["w_dq"]["w"]), p["q_norm"]["scale"], eps)
        q = mm(ql, p["w_uq"]["w"]).reshape(b, s, h, nope + rd)
        q = torch.cat([q[..., :nope], rope(q[..., nope:], theta)], -1)
        lat = rmsnorm(mm(xb, p["w_dkv"]["w"]), p["kv_norm"]["scale"], eps)
        kr = rope(mm(xb, p["w_krope"]["w"])[:, :, None], theta).expand(b, s, h, rd)
        k = torch.cat([mm(lat, p["w_uk"]["w"]).reshape(b, s, h, nope), kr], -1)
        v = mm(lat, p["w_uv"]["w"]).reshape(b, s, h, vd)
        y = attend(q, k, v, (nope + rd) ** -0.5)
        out.append(mm(y.reshape(b, s, h * vd), p["wo"]["w"]))
    return torch.cat(out)


# ---------------------------------------------------------------------------
# the experts
# ---------------------------------------------------------------------------
def capacity(c: dict, n_tokens: int) -> int:
    k, e, cf = c["num_experts_per_tok"], c["n_routed_experts"], c["capacity_factor"]
    return max(1, math.ceil(k * n_tokens * cf / e))


def moe(c: dict, p: dict, x: torch.Tensor, calls: list | None = None) -> torch.Tensor:
    """x [B, S, D] -> y: this card's experts' part and the shared
    experts.  ``calls``: the token indices (into ``x`` flattened) of each
    call of the layer, in order; each call routes and fills its experts'
    capacity on its own tokens (a prefill is one call, each decode step
    another).  None: one call of every token."""
    b, s, d = x.shape
    xt = x.reshape(-1, d)
    k, e = c["num_experts_per_tok"], c["n_routed_experts"]
    lo, held = c["experts_offset"], c["experts_held"]
    if calls is None:
        calls = [torch.arange(xt.shape[0], device=x.device)]
    scores = torch.sigmoid(xt @ p["router"])  # the router in float32
    idx = torch.topk(scores + p["bias"]["b"], k, -1).indices
    gates = scores.gather(-1, idx)
    if c["norm_topk_prob"]:
        gates = gates / gates.sum(-1, keepdim=True).clamp(min=1e-9)
    gates = gates * c["routed_scaling_factor"]
    # the pairs (token, j) call by call, in token order; each keeps its
    # slot if fewer than the call's capacity came to its expert before it
    tok = torch.cat([t.repeat_interleave(k) for t in calls])
    jj = torch.cat([torch.arange(k, device=x.device).repeat(t.numel()) for t in calls])
    call = torch.cat(
        [torch.full((t.numel() * k,), i, device=x.device) for i, t in enumerate(calls)]
    )
    cap = torch.tensor([capacity(c, t.numel()) for t in calls], device=x.device)
    ex_of = idx[tok, jj]
    group = call * e + ex_of
    order = torch.argsort(group, stable=True)
    sizes = torch.bincount(group, minlength=len(calls) * e)
    starts = torch.cumsum(sizes, 0) - sizes
    rank = torch.empty_like(order)
    rank[order] = torch.arange(order.numel(), device=x.device) - starts[group[order]]
    keep = rank < cap[call]
    gate = gates[tok, jj]
    y = swiglu(p["shared"], xt)
    for i in range(held):
        sel = torch.nonzero(keep & (ex_of == lo + i))[:, 0]
        if sel.numel() == 0:
            continue
        t = tok[sel]
        hid = F.silu(mm(xt[t], p["w1"][i])) * mm(xt[t], p["w3"][i])
        y.index_add_(0, t, mm(hid, p["w2"][i]) * gate[sel][:, None])
    return y.reshape(b, s, d)


# ---------------------------------------------------------------------------
# the mHC sites
# ---------------------------------------------------------------------------
def sinkhorn(m: torch.Tensor, iters: int, eps: float) -> torch.Tensor:
    for _ in range(iters):
        m = m / (m.sum(-1, keepdim=True) + eps)
        m = m / (m.sum(-2, keepdim=True) + eps)
    return m


def coefficients(c: dict, p: dict, x: torch.Tensor):
    """(H_pre [..., n], H_post [..., n], H_res [..., n, n]) of the stream
    x [..., n, C]."""
    n = c["hc_mult"]
    xh = rmsnorm(x.reshape(*x.shape[:-2], -1), p["norm"]["scale"], c["rms_norm_eps"])
    a = p["alpha"]["scale"]
    scales = torch.cat([a[0].repeat(n), a[1].repeat(n), a[2].repeat(n * n)])
    h = mm(xh, p["phi"]["w"]) * scales + p["b"]
    res = h[..., 2 * n :].clamp(c["mhc_h_res_clamp_min"], c["mhc_h_res_clamp_max"])
    m = torch.exp(res).reshape(*h.shape[:-1], n, n)
    return (
        torch.sigmoid(h[..., :n]),
        2 * torch.sigmoid(h[..., n : 2 * n]),
        sinkhorn(m, c["hc_sinkhorn_iters"], c["hc_eps"]),
    )


def site(c: dict, p: dict, x: torch.Tensor, fn) -> None:
    """One site around the sublayer ``fn`` (its own pre-norm included) on
    the stream ``x`` [B, S, n, C], written over ``x``; the coefficients
    :data:`SITE_ROWS` sequences at a time."""
    rows = range(0, x.shape[0], SITE_ROWS)
    coef = [coefficients(c, p, x[lo : lo + SITE_ROWS]) for lo in rows]
    u = torch.cat([(hp[..., None] * x[lo : lo + SITE_ROWS]).sum(-2)
                   for lo, (hp, _, _) in zip(rows, coef)])  # fmt: skip
    y = fn(u)
    del u
    for lo, (_, hpost, hres) in zip(rows, coef):
        xb = x[lo : lo + SITE_ROWS]
        xb.copy_(hres @ xb + hpost[..., None] * y[lo : lo + SITE_ROWS, :, None, :])


# ---------------------------------------------------------------------------
# the layers and the parameter tree as the configuration file names it
# ---------------------------------------------------------------------------
def layers(c: dict) -> list[tuple[str, tuple, int | None]]:
    """(ffn, path, group) of each layer in order, by ``port_layout``: the
    prefix's ``prefix/l{i}`` (the first ``first_k_dense_replace``, dense),
    then group ``g`` of ``groups/b0``."""
    nd, lay = c["first_k_dense_replace"], c["port_layout"]
    if (lay["prefix"], lay["period"], lay["suffix"]) != (nd, 1, 0):
        raise ValueError(f"port_layout {lay} is not the dense prefix and one period")
    return [
        ("dense", ("prefix", f"l{i}"), None) if i < nd else ("moe", ("groups", "b0"), i - nd)
        for i in range(c["num_hidden_layers"])
    ]


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def layer_params(params: dict, path: tuple, g: int | None) -> dict:
    """A layer's leaves in float32."""
    sub = params
    for key in path:
        sub = sub[key]
    return _map(lambda t: (t if g is None else t[g]).to(F32), sub)


def hidden(c: dict, params: dict, tokens: torch.Tensor, calls=None) -> torch.Tensor:
    """The rows of the stream summed, before the final norm (no autograd)."""
    eps, n = c["rms_norm_eps"], c["hc_mult"]
    with torch.no_grad():
        e = params["embed"]["tok"][tokens.long()].to(F32)
        x = e[:, :, None, :].expand(*e.shape[:2], n, e.shape[-1]).contiguous()
        del e
        for ffn, path, g in layers(c):
            p = layer_params(params, path, g)

            def mixer(u, p=p):
                return mla(c, p["mixer"], rmsnorm(u, p["norm1"]["scale"], eps))

            def feed(u, p=p, ffn=ffn):
                h = rmsnorm(u, p["norm2"]["scale"], eps)
                return swiglu(p["ffn"], h) if ffn == "dense" else moe(c, p["ffn"], h, calls)

            site(c, p["hc1"], x, mixer)
            site(c, p["hc2"], x, feed)
            del p
        return x.sum(-2)


def served_calls(b: int, prompt_len: int, steps: int, device) -> list:
    """The MoE calls of serving ``b`` sequences: one prefill of their
    ``prompt_len`` tokens, then a decode step a position, each over the
    ``b`` tokens at it (indices into ``[b, prompt_len + steps]``
    flattened)."""
    total = prompt_len + steps
    rows = torch.arange(b, device=device)[:, None] * total
    calls = [(rows + torch.arange(prompt_len, device=device)).reshape(-1)]
    calls += [rows[:, 0] + prompt_len + i for i in range(steps)]
    return calls


def served_logits(c: dict, params: dict, tokens: torch.Tensor, prompt_len: int):
    """Float32 logits ``[B, steps + 1, V]`` at the positions whose logits
    chose the served tokens (the prompt's last, then each decode step's):
    ``tokens`` ``[B, prompt_len + steps]`` is each prompt followed by the
    tokens fed back, and the experts fill their capacity call by call as
    serving calls them."""
    b, total = tokens.shape
    calls = served_calls(b, prompt_len, total - prompt_len, tokens.device)
    x = hidden(c, params, tokens, calls)
    at = torch.arange(prompt_len - 1, total, device=tokens.device)
    with torch.no_grad():
        h = rmsnorm(x[:, at], params["final_norm"]["scale"].to(F32), c["rms_norm_eps"])
        del x
        return mm(h, params["embed"]["head"]["w"].to(F32))
