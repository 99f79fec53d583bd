"""The plain reference of DeepSeek-V2-Lite as the configuration file
states it runs (``configs/deepseek-v2-lite-16b*.json``), in plain
PyTorch, computed in float32 (TF32 off).  It imports nothing of the
program; it reads the weights by the parameter names the configuration
file lists under ``params``.

Per token: the embedding row; ``first_k_dense_replace`` layers of
multi-head attention (``num_attention_heads`` heads of ``head_dim``,
rotary on the whole head) and a dense SwiGLU of ``intermediate_size``;
then layers of latent attention (MLA: ``q = x Wq`` split into
``qk_nope_head_dim`` and ``qk_rope_head_dim`` parts; the latent ``c =
x W_dkv`` of ``kv_lora_rank``; one shared rotary key ``x W_krope``;
per-head keys ``c W_uk`` and values ``c W_uv``; softmax scale
``(nope + rope) ** -0.5``) and a mixture of experts (the router's
softmax in float32 over ``n_routed_experts``, the top
``num_experts_per_tok``, the gates renormalised where
``renormalise_topk``, the port's departure from ``norm_topk_prob``;
each expert keeps the first ``capacity`` of the pairs routed to it in
token order, ``capacity = max(1, ceil(k T cf / E))`` for the ``T``
tokens of the call; SwiGLU experts of ``moe_intermediate_size``;
``n_shared_experts`` shared experts as one SwiGLU of that many times
the width; the router loss ``E sum_e f_e P_e``), each sublayer after
an RMSNorm of ``rms_norm_eps`` and added to the stream; a final RMSNorm and the output head.  Rotary: rotate-half
pairs, inverse frequencies ``rope_theta ** (-i / half)``.  The training
loss is the mean cross entropy plus ``router_aux_weight`` times the sum
of the router losses.  AdamW as ``optimizer`` states it: the clip over
the global norm, the moments in float32, the params stored back in
their own dtype after each step.

``precision("fp8")`` is the control: every matrix product's operands
rounded to float8 e4m3 with one scale a tensor (its largest magnitude
to 448), the products then in float32.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

F32 = torch.float32
_PREC = {"mode": "fp32"}


def precision(mode: str) -> None:
    """``"fp32"`` (TF32 off) or ``"fp8"`` (the control)."""
    if mode not in ("fp32", "fp8"):
        raise ValueError(mode)
    _PREC["mode"] = mode
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class _Fp8Round(torch.autograd.Function):
    """Rounds to float8 e4m3 with a per-tensor scale; the gradient
    passes through (the backward's products round their own operands)."""

    @staticmethod
    def forward(ctx, x):
        amax = x.detach().abs().amax().clamp(min=1e-30)
        scale = amax / 448.0
        return (x / scale).to(torch.float8_e4m3fn).to(F32) * scale

    @staticmethod
    def backward(ctx, g):
        return g


def _q(x: torch.Tensor) -> torch.Tensor:
    return _Fp8Round.apply(x) if _PREC["mode"] == "fp8" else x


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _q(a) @ _q(b)


# ---------------------------------------------------------------------------
# the layers
# ---------------------------------------------------------------------------
def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x [B, S, H, D], pos [B, S]."""
    half = x.shape[-1] // 2
    inv = 1.0 / (theta ** (torch.arange(half, dtype=F32, device=x.device) / half))
    ang = pos.to(F32)[..., None] * inv
    cos, sin = torch.cos(ang)[:, :, None], torch.sin(ang)[:, :, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def attend(q, k, v, qpos, kpos, scale):
    """Causal softmax attention row by row: q [B, Sq, H, D], k [B, Sk,
    H, D], v [B, Sk, H, Dv]; a query sees the keys at its position and
    before."""
    outs = []
    for b in range(q.shape[0]):
        s = torch.einsum("qhd,khd->hqk", _q(q[b]), _q(k[b])) * scale
        mask = kpos[b][None, :] <= qpos[b][:, None]
        s = s.masked_fill(~mask[None], float("-inf"))
        outs.append(torch.einsum("hqk,khd->qhd", _q(torch.softmax(s, -1)), _q(v[b])))
    return torch.stack(outs)


def swiglu(p: dict, x: torch.Tensor) -> torch.Tensor:
    return mm(F.silu(mm(x, p["wg"]["w"])) * mm(x, p["wi"]["w"]), p["wo"]["w"])


def mha(c: dict, p: dict, x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    b, s, _ = x.shape
    h, hd = c["num_attention_heads"], c["head_dim"]
    q = rope(mm(x, p["wq"]["w"]).reshape(b, s, h, hd), pos, c["rope_theta"])
    k = rope(mm(x, p["wk"]["w"]).reshape(b, s, h, hd), pos, c["rope_theta"])
    v = mm(x, p["wv"]["w"]).reshape(b, s, h, hd)
    y = attend(q, k, v, pos, pos, hd**-0.5)
    return mm(y.reshape(b, s, h * hd), p["wo"]["w"])


def mla(c: dict, p: dict, x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    b, s, _ = x.shape
    h = c["num_attention_heads"]
    nope, rd, vd = c["qk_nope_head_dim"], c["qk_rope_head_dim"], c["v_head_dim"]
    q = mm(x, p["wq"]["w"]).reshape(b, s, h, nope + rd)
    q = torch.cat([q[..., :nope], rope(q[..., nope:], pos, c["rope_theta"])], -1)
    lat = mm(x, p["w_dkv"]["w"])
    kr = rope(mm(x, p["w_krope"]["w"])[:, :, None], pos, c["rope_theta"])
    k = torch.cat(
        [mm(lat, p["w_uk"]["w"]).reshape(b, s, h, nope), kr.expand(b, s, h, rd)], -1
    )
    v = mm(lat, p["w_uv"]["w"]).reshape(b, s, h, vd)
    y = attend(q, k, v, pos, pos, (nope + rd) ** -0.5)
    return mm(y.reshape(b, s, h * vd), p["wo"]["w"])


def capacity(c: dict, n_tokens: int) -> int:
    k, e, cf = c["num_experts_per_tok"], c["n_routed_experts"], c["capacity_factor"]
    return max(1, math.ceil(k * n_tokens * cf / e))


def moe(c: dict, p: dict, x: torch.Tensor, calls: list | None = None):
    """x [B, S, D] -> (y, router loss of the first call).  ``calls``: the
    token indices (into ``x`` flattened to ``[B * S, D]``) of each call
    of the layer, in order; each call routes and fills its experts'
    capacity on its own tokens (a prefill is one call, each decode step
    another).  None: one call of every token."""
    b, s, d = x.shape
    xt = x.reshape(-1, d)
    k, e = c["num_experts_per_tok"], c["n_routed_experts"]
    if calls is None:
        calls = [torch.arange(xt.shape[0], device=x.device)]
    probs = torch.softmax(xt @ p["router"], -1)  # the router in float32
    gates, idx = torch.topk(probs, k, -1)
    if c["renormalise_topk"]:
        gates = gates / gates.sum(-1, keepdim=True).clamp(min=1e-9)
    first = calls[0]
    counts = torch.bincount(idx[first].reshape(-1), minlength=e).to(F32)
    aux = e * torch.sum(counts / (first.numel() * k) * probs[first].mean(0))
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
    y = torch.zeros_like(xt)
    for ex in range(e):
        sel = torch.nonzero(keep & (ex_of == ex))[:, 0]
        if sel.numel() == 0:
            continue
        t = tok[sel]
        h = F.silu(mm(xt[t], p["w1"][ex])) * mm(xt[t], p["w3"][ex])
        y = y.index_add(0, t, mm(h, p["w2"][ex]) * gate[sel][:, None])
    y = y + swiglu(p["shared"], xt)
    return y.reshape(b, s, d), aux


def block(c: dict, kind: str, p: dict, x: torch.Tensor, pos: torch.Tensor, calls=None):
    """One layer: ``kind`` "dense" (MHA + dense FFN) or "moe" (MLA + MoE,
    its calls as :func:`moe` takes them).  Returns (x, router loss or
    None)."""
    eps = c["rms_norm_eps"]
    h = rmsnorm(x, p["norm1"]["scale"], eps)
    x = x + (mha if kind == "dense" else mla)(c, p["mixer"], h, pos)
    h = rmsnorm(x, p["norm2"]["scale"], eps)
    if kind == "dense":
        return x + swiglu(p["ffn"], h), None
    y, aux = moe(c, p["ffn"], h, calls)
    return x + y, aux


# ---------------------------------------------------------------------------
# the parameter tree as the configuration file names it
# ---------------------------------------------------------------------------
def layers(c: dict) -> list[tuple[str, tuple, int | None]]:
    """(kind, path, group) of each layer in order: the dense prefix's
    ``prefix/l{i}``, then group ``g`` of ``groups/b0``."""
    nd = c["first_k_dense_replace"]
    out = [("dense", ("prefix", f"l{i}"), None) for i in range(nd)]
    out += [("moe", ("groups", "b0"), g) for g in range(c["num_hidden_layers"] - nd)]
    return out


def _get(tree: dict, path: tuple) -> dict:
    for k in path:
        tree = tree[k]
    return tree


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def layer_params(params: dict, path: tuple, g: int | None, grad: bool = False) -> dict:
    """A layer's leaves in float32 (fresh tensors; with ``grad`` they
    require it)."""
    sub = _get(params, path)

    def one(t):
        t = (t if g is None else t[g]).to(F32)
        return t.clone().requires_grad_(True) if grad else t

    return _map(one, sub)


def leaf_items(tree: dict, prefix: tuple = ()):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from leaf_items(v, prefix + (k,))
        else:
            yield prefix + (k,), v


# ---------------------------------------------------------------------------
# forward, loss, gradients
# ---------------------------------------------------------------------------
def hidden_states(c: dict, params: dict, tokens: torch.Tensor, calls=None, keep=True):
    """The stream before the final norm (no autograd), with every layer's
    input (only the last without ``keep``) and the router losses."""
    pos = torch.arange(tokens.shape[1], device=tokens.device)[None].expand_as(tokens)
    with torch.no_grad():
        x = params["embed"]["tok"][tokens.long()].to(F32)
        xs, auxs = [x], []
        for kind, path, g in layers(c):
            x, aux = block(c, kind, layer_params(params, path, g), x, pos, calls)
            xs = xs + [x] if keep else [x]
            if aux is not None:
                auxs.append(aux)
    return xs, auxs, pos


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
    steps = total - prompt_len
    calls = served_calls(b, prompt_len, steps, tokens.device)
    xs, _, _ = hidden_states(c, params, tokens, calls, keep=False)
    at = torch.arange(prompt_len - 1, total, device=tokens.device)
    with torch.no_grad():
        h = rmsnorm(xs[-1][:, at], params["final_norm"]["scale"].to(F32), c["rms_norm_eps"])
        del xs
        return mm(h, params["embed"]["head"]["w"].to(F32))


def loss_and_grads(c: dict, params: dict, tokens: torch.Tensor, labels: torch.Tensor):
    """(total loss, {leaf key: float32 gradient}) of the mean cross
    entropy plus the router losses, layer by layer: the forward keeps
    each layer's input, the backward recomputes one layer at a time."""
    xs, auxs, pos = hidden_states(c, params, tokens)
    grads = {}
    b, s = labels.shape
    n = b * s
    eps = c["rms_norm_eps"]
    xf = xs[-1].detach().requires_grad_(True)
    scale = params["final_norm"]["scale"].to(F32, copy=True).requires_grad_(True)
    head = params["embed"]["head"]["w"].to(F32, copy=True).requires_grad_(True)
    nll = 0.0
    chunk = 2048
    flat_x, flat_l = xf.reshape(n, -1), labels.reshape(n).long()
    for lo in range(0, n, chunk):
        h = rmsnorm(flat_x[lo : lo + chunk], scale, eps)
        lg = mm(h, head)
        part = F.cross_entropy(lg, flat_l[lo : lo + chunk], reduction="sum") / n
        part.backward()
        nll += float(part.detach())
    grads[(("final_norm", "scale"), None)] = scale.grad
    grads[(("embed", "head", "w"), None)] = head.grad
    del head
    gx = xf.grad
    w = c["router_aux_weight"]
    for i in reversed(range(len(layers(c)))):
        kind, path, g = layers(c)[i]
        p = layer_params(params, path, g, grad=True)
        xin = xs[i].detach().requires_grad_(True)
        y, aux = block(c, kind, p, xin, pos)
        if aux is None:
            y.backward(gx)
        else:
            torch.autograd.backward([y, aux], [gx, torch.tensor(w, device=y.device)])
        for leaf, t in leaf_items(p):
            grads[(path + leaf, g)] = t.grad
        gx = xin.grad
        xs[i + 1] = None
    tok = params["embed"]["tok"]
    gtok = torch.zeros(tok.shape, dtype=F32, device=tok.device)
    gtok.index_add_(0, tokens.reshape(-1).long(), gx.reshape(n, -1))
    grads[(("embed", "tok"), None)] = gtok
    total = nll + w * float(sum(auxs)) if auxs else nll
    return total, grads


def lr_at(opt: dict, count: int) -> float:
    if count < opt["warmup_steps"]:
        return opt["lr"] * count / max(1, opt["warmup_steps"])
    span = max(1.0, opt["total_steps"] - opt["warmup_steps"])
    frac = min(1.0, max(0.0, (count - opt["warmup_steps"]) / span))
    return opt["lr"] * 0.5 * (1.0 + math.cos(math.pi * frac))


def _slice(params: dict, key):
    path, g = key
    t = _get(params, path[:-1])[path[-1]]
    return t if g is None else t[g]


def train(c: dict, opt: dict, params: dict, batches: list, on_first=None):
    """Steps from ``params`` (updated in place, each leaf in its own
    dtype; moments zero) on ``batches`` of ``(tokens, labels)``.
    Returns each step's total loss and each leaf's norm of the first
    step's gradient as AdamW takes it (clipped); ``on_first(key, g)``
    sees that gradient leaf by leaf."""
    m, v = {}, {}
    losses, first = [], {}
    for count, (tokens, labels) in enumerate(batches, start=1):
        total, grads = loss_and_grads(c, params, tokens, labels)
        losses.append(total)
        gnorm = math.sqrt(sum(float(g.double().square().sum()) for g in grads.values()))
        scale = min(1.0, opt["clip_norm"] / max(gnorm, 1e-9))
        lr = lr_at(opt, count)
        bc1, bc2 = 1.0 - opt["b1"] ** count, 1.0 - opt["b2"] ** count
        with torch.no_grad():
            for key in list(grads):
                g = grads.pop(key) * scale
                if count == 1:
                    first[key] = float(g.double().norm())
                    if on_first is not None:
                        on_first(key, g)
                if key not in m:
                    m[key], v[key] = torch.zeros_like(g), torch.zeros_like(g)
                m[key].mul_(opt["b1"]).add_((1 - opt["b1"]) * g)
                v[key].mul_(opt["b2"]).add_((1 - opt["b2"]) * g * g)
                p = _slice(params, key)
                pf = p.to(F32)
                step = (m[key] / bc1) / (torch.sqrt(v[key] / bc2) + opt["eps"])
                p.copy_(pf - lr * (step + opt["weight_decay"] * pf))
                del g
    return losses, first

