"""The plain reference of Kimi-Linear-48B-A3B as the configuration file
states it runs (``configs/kimi-linear-48b-a3b-ep4.json``: one card's
share of the expert-parallel deployment), in plain PyTorch, computed in
float32 (TF32 off).  It imports nothing of the program; it reads the
weights by the parameter names the configuration file lists under
``params``, and the layers' kinds from the published
``linear_attn_config`` (1-based ``kda_layers`` and ``full_attn_layers``).

Per token: the embedding row; each layer an RMSNorm of ``rms_norm_eps``,
its mixer added to the stream, an RMSNorm, its FFN added; a final RMSNorm
and the output head.

* KDA (``kda_layers``), ``num_heads`` heads of ``head_dim``, token by
  token::

      q, k, v = SiLU(ShortConv(x W_q)), SiLU(ShortConv(x W_k)),
                SiLU(ShortConv(x W_v))
      q <- q / |q| * head_dim ** -0.5,  k <- k / |k|   (|x| = sqrt(sum x^2 + 1e-6))
      g = -exp(A_log) * softplus(x W_f_down W_f_up + dt_bias)
      beta = sigmoid(x W_b)
      S_t = (I - beta_t k_t k_t^T) Diag(exp(g_t)) S_{t-1} + beta_t k_t v_t^T
      o_t = S_t^T q_t
      y = (RMSNorm_{head_dim}(o) * sigmoid(x W_g_down W_g_up + b_g)) W_o

  ``ShortConv``: a causal depthwise convolution of
  ``short_conv_kernel_size`` taps, no bias; the state zero at a
  sequence's start; :data:`KDA_ROWS` sequences at a time.  The low ranks
  of the decay and the gate (``kda_lowrank``) are the configuration's
  ``assumed``.
* MLA (``full_attn_layers``): ``q = x W_q`` of ``qk_nope_head_dim +
  qk_rope_head_dim`` a head, the latent ``c = x W_dkv`` of
  ``kv_lora_rank`` (no RMSNorm on it, a departure), one shared key part
  ``x W_krope``; per-head keys ``c W_uk`` and values ``c W_uv``; no
  positional encoding at all (``mla_use_nope``): the rope part is a plain
  projection; causal softmax at scale ``(nope + rope) ** -0.5``, a block
  of rows at a time.
* FFN: the first ``first_k_dense_replace`` layers a SwiGLU of
  ``intermediate_size``; every other layer a mixture of experts: scores
  ``s = sigmoid(x W_r)`` in float32 over all ``num_experts``, the top
  ``num_experts_per_token`` chosen by ``s + bias`` (the selection bias),
  their ``s`` renormalised (``moe_renormalize``) and scaled by
  ``routed_scaling_factor``; this card's share, experts ``experts_offset
  .. experts_offset + experts_held``, each keeping the first ``capacity =
  max(1, ceil(k T cf / num_experts))`` of the pairs routed to it in token
  order, call by call (a departure); pairs routed to the experts the card
  does not hold add nothing; SwiGLU experts of ``moe_intermediate_size``;
  ``num_shared_experts`` shared experts as one SwiGLU of that many times
  the width, whole.

``precision("fp8")`` is the control: every matrix product's operands,
and the recurrence's q, k and v, rounded to float8 e4m3 with one scale a
tensor (its largest magnitude to 448), the products then in float32.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

F32 = torch.float32
L2_EPS = 1e-6
MLA_ROWS = 16  # sequences a block of the MLA attention
KDA_ROWS = 32  # sequences a block of KDA
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


def _l2(x: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt((x * x).sum(-1, keepdim=True) + L2_EPS)


# ---------------------------------------------------------------------------
# the mixers
# ---------------------------------------------------------------------------
def kda(c: dict, p: dict, x: torch.Tensor) -> torch.Tensor:
    """x [B, S, D] -> [B, S, D], :data:`KDA_ROWS` sequences at a time."""
    rows = range(0, x.shape[0], KDA_ROWS)
    return torch.cat([_kda(c, p, x[lo : lo + KDA_ROWS]) for lo in rows])


def _kda(c: dict, p: dict, x: torch.Tensor) -> torch.Tensor:
    """The recurrence a token at a time."""
    la = c["linear_attn_config"]
    b, s, _ = x.shape
    h, dk = la["num_heads"], la["head_dim"]
    width = la["short_conv_kernel_size"]
    proj = mm(x, p["wqkv"]["w"])  # [B, S, 3 H dk]: q, k, v side by side
    padded = F.pad(proj, (0, 0, width - 1, 0))
    w = p["conv"]["w"]
    conv = sum(padded[:, j : j + s] * w[j] for j in range(width))
    q, k, v = F.silu(conv).reshape(b, s, 3, h, dk).unbind(2)
    q = _q(_l2(q) * dk**-0.5)
    k, v = _q(_l2(k)), _q(v)
    z = mm(mm(x, p["f_a"]["w"]), p["f_b"]["w"]) + p["dt_bias"]
    g = -torch.exp(p["a_log"]).reshape(h, 1) * F.softplus(z).reshape(b, s, h, dk)
    beta = torch.sigmoid(mm(x, p["b"]["w"]))  # [B, S, H]
    state = x.new_zeros((b, h, dk, dk))
    outs = []
    for t in range(s):
        decayed = state * torch.exp(g[:, t])[..., None]
        kt, bt = k[:, t], beta[:, t][..., None, None]
        # (I - beta k k^T) Diag(alpha) S + beta k v^T
        read = torch.einsum("bhk,bhkv->bhv", kt, decayed)  # k^T Diag(alpha) S
        state = (
            decayed
            - bt * kt[..., None] * read[..., None, :]
            + bt * kt[..., None] * v[:, t][..., None, :]
        )
        outs.append(torch.einsum("bhkv,bhk->bhv", state, q[:, t]))
    o = rmsnorm(torch.stack(outs, 1), p["o_norm"]["scale"], c["rms_norm_eps"])
    gate = torch.sigmoid(mm(mm(x, p["g_a"]["w"]), p["g_b"]["w"]) + p["g_b"]["b"])
    return mm(o.reshape(b, s, h * dk) * gate, p["wo"]["w"])


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
    """Latent attention without positions, :data:`MLA_ROWS` sequences at
    a time."""
    out = []
    h = c["num_attention_heads"]
    nope, rd, vd = c["qk_nope_head_dim"], c["qk_rope_head_dim"], c["v_head_dim"]
    for lo in range(0, x.shape[0], MLA_ROWS):
        xb = x[lo : lo + MLA_ROWS]
        b, s, _ = xb.shape
        q = mm(xb, p["wq"]["w"]).reshape(b, s, h, nope + rd)
        lat = mm(xb, p["w_dkv"]["w"])
        kr = mm(xb, p["w_krope"]["w"])[:, :, None].expand(b, s, h, rd)
        k = torch.cat([mm(lat, p["w_uk"]["w"]).reshape(b, s, h, nope), kr], -1)
        v = mm(lat, p["w_uv"]["w"]).reshape(b, s, h, vd)
        y = attend(q, k, v, (nope + rd) ** -0.5)
        out.append(mm(y.reshape(b, s, h * vd), p["wo"]["w"]))
    return torch.cat(out)


# ---------------------------------------------------------------------------
# the experts
# ---------------------------------------------------------------------------
def capacity(c: dict, n_tokens: int) -> int:
    k, e, cf = c["num_experts_per_token"], c["num_experts"], c["capacity_factor"]
    return max(1, math.ceil(k * n_tokens * cf / e))


def moe(c: dict, p: dict, x: torch.Tensor, calls: list | None = None) -> torch.Tensor:
    """x [B, S, D] -> y: this card's experts' part and the shared
    experts.  ``calls``: the token indices (into ``x`` flattened) of each
    call of the layer, in order; each call routes and fills its experts'
    capacity on its own tokens (a prefill is one call, each decode step
    another).  None: one call of every token."""
    b, s, d = x.shape
    xt = x.reshape(-1, d)
    k, e = c["num_experts_per_token"], c["num_experts"]
    lo, held = c["experts_offset"], c["experts_held"]
    if calls is None:
        calls = [torch.arange(xt.shape[0], device=x.device)]
    scores = torch.sigmoid(xt @ p["router"])  # the router in float32
    idx = torch.topk(scores + p["bias"]["b"], k, -1).indices
    gates = scores.gather(-1, idx)
    if c["moe_renormalize"]:
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
# the layers and the parameter tree as the configuration file names it
# ---------------------------------------------------------------------------
def layers(c: dict) -> list[tuple[str, str, tuple, int | None]]:
    """(mixer, ffn, path, group) of each layer in order: the mixer from
    the published 1-based lists, the FFN dense for the first
    ``first_k_dense_replace``; the path by ``port_layout``: the prefix's
    ``prefix/l{i}``, then group ``g`` of ``groups/b{j}`` (``period``
    layers a group), then the suffix's ``suffix/l{i}``."""
    la, lay = c["linear_attn_config"], c["port_layout"]
    n, nd = c["num_hidden_layers"], c["first_k_dense_replace"]
    pre, per, suf = lay["prefix"], lay["period"], lay["suffix"]
    out = []
    for i in range(n):
        one_based = i + 1
        if one_based in la["kda_layers"]:
            mixer = "kda"
        elif one_based in la["full_attn_layers"]:
            mixer = "mla"
        else:
            raise ValueError(f"layer {one_based} is in neither list")
        ffn = "dense" if i < nd else "moe"
        if i < pre:
            out.append((mixer, ffn, ("prefix", f"l{i}"), None))
        elif i >= n - suf:
            out.append((mixer, ffn, ("suffix", f"l{i - (n - suf)}"), None))
        else:
            g, j = divmod(i - pre, per)
            out.append((mixer, ffn, ("groups", f"b{j}"), g))
    return out


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


def block(c: dict, mixer: str, ffn: str, p: dict, x: torch.Tensor, calls=None):
    eps = c["rms_norm_eps"]
    h = rmsnorm(x, p["norm1"]["scale"], eps)
    x = x + (kda if mixer == "kda" else mla)(c, p["mixer"], h)
    h = rmsnorm(x, p["norm2"]["scale"], eps)
    return x + (swiglu(p["ffn"], h) if ffn == "dense" else moe(c, p["ffn"], h, calls))


def hidden(c: dict, params: dict, tokens: torch.Tensor, calls=None) -> torch.Tensor:
    """The stream before the final norm (no autograd)."""
    with torch.no_grad():
        x = params["embed"]["tok"][tokens.long()].to(F32)
        for mixer, ffn, path, g in layers(c):
            x = block(c, mixer, ffn, layer_params(params, path, g), x, calls)
    return x


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
