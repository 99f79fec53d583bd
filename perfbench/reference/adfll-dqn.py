"""The plain reference of the ADFLL agent (``configs/adfll-dqn.json``):
the 3D-CNN DQN's forward, its TD loss and AdamW, one agent at a time,
in plain PyTorch.  It imports nothing of the program.

The DQN (the paper's Appendix A.1 as the configuration states it):
``len(conv_features)`` 3x3x3 convolutions of stride 2 with XLA's
``SAME`` padding (for a 3-wide, stride-2 window: ``total = max((ceil(n /
2) - 1) * 2 + 3 - n, 0)`` zeros, ``total // 2`` before), each followed
by a ReLU; the feature map flattened channels last; the normalised
location through a 16-wide dense layer and a ReLU, concatenated after
it; then dense layers of ``hidden`` widths with ReLUs and a last one of
``n_actions`` q-values.  Weights are laid out as the configuration's
parameter names say: ``conv{i}`` ``w [O, I, 3, 3, 3]`` and ``b [O]``,
``loc`` and ``fc{i}`` ``w [d_in, d_out]`` and ``b [d_out]``.

The TD loss of a batch of flat replay rows (columns: ``obs`` box voxels,
``loc`` 3, ``action``, ``reward``, ``next_obs``, ``next_loc`` 3,
``done``): ``target = r + gamma (1 - done) max_a q_target(next)``, the
Huber loss (delta 1) of ``q(obs)[action] - target``, its mean over the
batch.  AdamW: the gradient scaled by ``min(1, clip / |g|)`` with the
norm over all of the agent's leaves, ``m = b1 m + (1 - b1) g``, ``v =
b2 v + (1 - b2) g^2``, ``p -= lr_t ((m / (1 - b1^t)) / (sqrt(v / (1 -
b2^t)) + eps) + wd p)`` with the cosine schedule after a linear warm-up;
the target net takes the params every ``target_update`` steps.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def precision(tf32: bool) -> None:
    """float32 products with TF32 off (the configuration's precision),
    or on (the control)."""
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32


def _same_pad(x: torch.Tensor) -> torch.Tensor:
    pads: list[int] = []
    for n in reversed(x.shape[-3:]):
        total = max((-(-n // 2) - 1) * 2 + 3 - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


def forward(dqn: dict, p: dict, obs: torch.Tensor, loc: torch.Tensor) -> torch.Tensor:
    """obs [B, bx, by, bz], loc [B, 3] -> q [B, n_actions]."""
    x = obs[:, None]
    for i in range(len(dqn["conv_features"])):
        x = F.relu(F.conv3d(_same_pad(x), p[f"conv{i}"]["w"], p[f"conv{i}"]["b"], stride=2))
    x = x.permute(0, 2, 3, 4, 1).reshape(x.shape[0], -1)
    h = F.relu(loc @ p["loc"]["w"] + p["loc"]["b"])
    x = torch.cat([x, h], -1)
    n_fc = len(dqn["hidden"]) + 1
    for i in range(n_fc):
        x = x @ p[f"fc{i}"]["w"] + p[f"fc{i}"]["b"]
        if i < n_fc - 1:
            x = F.relu(x)
    return x


def split_rows(dqn: dict, rows: torch.Tensor) -> dict:
    box = tuple(dqn["box_size"])
    nb = math.prod(box)
    cut = [nb, 3, 1, 1, nb, 3, 1]
    obs, loc, act, rew, nobs, nloc, done = torch.split(rows, cut, dim=-1)
    return {
        "obs": obs.reshape(-1, *box),
        "loc": loc,
        "action": act[:, 0],
        "reward": rew[:, 0],
        "next_obs": nobs.reshape(-1, *box),
        "next_loc": nloc,
        "done": done[:, 0],
    }


FIELDS = ("obs", "loc", "action", "reward", "next_obs", "next_loc", "done")


def rows_from_erbs(datas: list[dict], rows) -> np.ndarray:
    """Flat rows ``[B, F]`` float32: row ``b`` is row ``rows[b]`` of the
    replay buffer whose arrays are ``datas[b]`` (field by field, in
    :data:`FIELDS` order)."""
    out = []
    for data, r in zip(datas, rows, strict=True):
        out.append(
            np.concatenate(
                [np.asarray(data[f][int(r)], np.float32).reshape(-1) for f in FIELDS]
            )
        )
    return np.stack(out)


def invalid_rows(dqn: dict, rows: torch.Tensor) -> int:
    """Rows that no step of the environment makes: an action outside
    ``[0, n_actions)``, a move other than ``step_size`` voxels along one
    axis (or none, at the volume's edge), a reward larger than the move,
    ``done`` other than 0 or 1, or a voxel outside [0, 1]."""
    b = split_rows(dqn, rows)
    n = dqn["volume_shape"][0]
    move = ((b["next_loc"] - b["loc"]) * (n - 1)).round().abs()
    step = dqn["step_size"]
    one_axis = ((move == 0).sum(-1) >= 2) & (move.max(-1).values <= step)
    act = b["action"]
    ok = (
        (act >= 0)
        & (act < dqn["n_actions"])
        & (act == act.round())
        & one_axis
        & (b["reward"].abs() <= step + 1e-4)
        & ((b["done"] == 0) | (b["done"] == 1))
        & (b["obs"].amin((1, 2, 3)) >= 0)
        & (b["obs"].amax((1, 2, 3)) <= 1)
    )
    return int((~ok).sum())


def td_loss(dqn: dict, p: dict, target: dict, rows: torch.Tensor) -> torch.Tensor:
    b = split_rows(dqn, rows)
    q = forward(dqn, p, b["obs"], b["loc"])
    with torch.no_grad():
        best = forward(dqn, target, b["next_obs"], b["next_loc"]).max(-1).values
    q_sel = q.gather(1, b["action"].long()[:, None])[:, 0]
    delta = q_sel - (b["reward"] + dqn["gamma"] * (1.0 - b["done"]) * best)
    return F.huber_loss(delta, torch.zeros_like(delta), delta=1.0)


def _names(p: dict) -> list[tuple[str, str]]:
    return [(k, n) for k in sorted(p) for n in sorted(p[k])]


def lr_at(opt: dict, count: int) -> float:
    if count < opt["warmup_steps"]:
        return opt["lr"] * count / max(1, opt["warmup_steps"])
    span = max(1.0, opt["total_steps"] - opt["warmup_steps"])
    frac = min(1.0, max(0.0, (count - opt["warmup_steps"]) / span))
    return opt["lr"] * 0.5 * (1.0 + math.cos(math.pi * frac))


def train(dqn: dict, opt: dict, params: dict, rows_per_step: list[torch.Tensor]):
    """Steps of one agent from ``params`` (its target net the same, its
    moments zero) on each step's rows.  Returns each step's loss, the
    first step's gradient as AdamW takes it (clipped), and the params
    after every step."""
    names = _names(params)
    p = {k: {n: t.detach().clone() for n, t in v.items()} for k, v in params.items()}
    target = {k: {n: t.clone() for n, t in v.items()} for k, v in p.items()}
    m = {kn: torch.zeros_like(p[kn[0]][kn[1]]) for kn in names}
    v = {kn: torch.zeros_like(p[kn[0]][kn[1]]) for kn in names}
    losses, first_grad, after = [], {}, []
    for c, rows in enumerate(rows_per_step, start=1):
        live = {k: {n: t.requires_grad_(True) for n, t in vv.items()} for k, vv in p.items()}
        with torch.enable_grad():
            loss = td_loss(dqn, live, target, rows)
            grads = torch.autograd.grad(loss, [live[k][n] for k, n in names])
        losses.append(float(loss.detach()))
        norm = torch.sqrt(sum(g.double().square().sum() for g in grads))
        scale = min(1.0, opt["clip_norm"] / max(float(norm), 1e-9))
        lr = lr_at(opt, c)
        bc1, bc2 = 1.0 - opt["b1"] ** c, 1.0 - opt["b2"] ** c
        new = {k: {} for k in p}
        with torch.no_grad():
            for (k, n), g in zip(names, grads, strict=True):
                g = g * scale
                if c == 1:
                    first_grad[(k, n)] = g.clone()
                m[(k, n)] = opt["b1"] * m[(k, n)] + (1 - opt["b1"]) * g
                v[(k, n)] = opt["b2"] * v[(k, n)] + (1 - opt["b2"]) * g * g
                step = (m[(k, n)] / bc1) / (torch.sqrt(v[(k, n)] / bc2) + opt["eps"])
                step = step + opt["weight_decay"] * p[k][n]
                new[k][n] = (p[k][n] - lr * step).detach()
        p = new
        if c % dqn["target_update"] == 0:
            target = {k: {n: t.clone() for n, t in vv.items()} for k, vv in p.items()}
        after.append(p)
    return losses, first_grad, after
