"""3D-CNN deep Q-network (DQN, Mnih et al. 2013 adapted to 3D volumes).

Parameters are a dict of dicts of tensors with the reference's names
(``conv{i}``, ``loc``, ``fc{i}``, each holding ``w`` and ``b``).  Conv
weights are stored in PyTorch's OIDHW layout; ``loc``/``fc*`` weights
keep the reference's ``x @ w`` layout ``[d_in, d_out]``
(:mod:`repro_torch.convert` maps the reference's DHWIO convs).

Two forms of the forward:

* :func:`dqn_apply` — one agent, ``obs [B, bx, by, bz]``;
* :func:`dqn_apply_stacked` — N agents at once, every leaf with a
  leading agent axis and ``obs [N, B, bx, by, bz]``.  The reference
  ``vmap``s the agent axis; here it is written out: grouped conv3d
  (``groups=N`` over ``[B, N*C, D, H, W]``) and ``torch.bmm`` for the
  dense layers.  Agents share no parameters, so one backward of a sum
  of per-agent losses yields every agent's own gradient.

Two layout traps of the reference are handled here: ``padding="SAME"``
with stride 2 is asymmetric (:func:`same_pad`), and the flatten before
``fc0`` is channels-last (NDHWC).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.adfll_dqn import DQNConfig

F32 = torch.float32


def truncated_normal(
    shape: tuple[int, ...], scale: float, generator: torch.Generator
) -> torch.Tensor:
    """``scale`` x a standard normal truncated to [-2, 2] (the reference's
    ``models/layers.py::truncated_normal`` distribution; not its bits)."""
    x = torch.empty(shape, dtype=F32)
    torch.nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return x * scale


def dqn_init(
    cfg: DQNConfig,
    generator: torch.Generator,
    device: str | torch.device = "cpu",
) -> dict:
    """Fresh parameters with the reference's shapes and init scales,
    drawn on the CPU from ``generator`` and moved to ``device``."""
    p = {}
    cin = 1
    for i, cout in enumerate(cfg.conv_features):
        p[f"conv{i}"] = {
            "w": truncated_normal((cout, cin, 3, 3, 3), (cin * 27) ** -0.5, generator),
            "b": torch.zeros(cout),
        }
        cin = cout
    dims = list(cfg.box_size)
    for _ in cfg.conv_features:  # stride-2 SAME convs
        dims = [-(-d // 2) for d in dims]
    d = dims[0] * dims[1] * dims[2] * cin + 16
    p["loc"] = {
        "w": truncated_normal((3, 16), 3**-0.5, generator),
        "b": torch.zeros(16),
    }
    for i, h in enumerate([*cfg.hidden, cfg.n_actions]):
        p[f"fc{i}"] = {
            "w": truncated_normal((d, h), d**-0.5, generator),
            "b": torch.zeros(h),
        }
        d = h
    return {k: {n: t.to(device) for n, t in v.items()} for k, v in p.items()}


def same_pad(x: torch.Tensor) -> torch.Tensor:
    """Zero-pad the three trailing spatial dims as XLA's ``SAME`` does
    for a 3-wide, stride-2 window: ``total = max((ceil(n/2)-1)*2+3-n, 0)``
    with ``total // 2`` before and the rest after — (0, 1) for even
    ``n``, (1, 1) for odd ``n``.  ``conv3d(padding=1)`` would pad (1, 1)
    everywhere and shift every even-sized output."""
    pads: list[int] = []
    for n in reversed(x.shape[-3:]):  # F.pad lists the last dim first
        total = max((-(-n // 2) - 1) * 2 + 3 - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


def _n_fc(p: dict) -> int:
    return sum(1 for k in p if k.startswith("fc"))


def dqn_apply(cfg: DQNConfig, p: dict, obs: torch.Tensor, loc: torch.Tensor):
    """obs [B, bx, by, bz], loc [B, 3] normalized -> q [B, n_actions]."""
    x = obs[:, None]  # NCDHW, C = 1
    for i in range(len(cfg.conv_features)):
        c = p[f"conv{i}"]
        x = F.relu(F.conv3d(same_pad(x), c["w"], c["b"], stride=2))
    x = x.permute(0, 2, 3, 4, 1).reshape(x.shape[0], -1)  # NDHWC flatten
    lh = F.relu(loc @ p["loc"]["w"] + p["loc"]["b"])
    x = torch.cat([x, lh], -1)
    n_fc = _n_fc(p)
    for i in range(n_fc):
        x = x @ p[f"fc{i}"]["w"] + p[f"fc{i}"]["b"]
        if i < n_fc - 1:
            x = F.relu(x)
    return x


def dqn_apply_stacked(cfg: DQNConfig, p: dict, obs: torch.Tensor, loc: torch.Tensor):
    """Stacked params (leading agent axis N), obs [N, B, bx, by, bz],
    loc [N, B, 3] -> q [N, B, n_actions]; lane i is agent i's forward
    on its own batch."""
    n, b = obs.shape[:2]
    x = obs.transpose(0, 1)  # [B, N, D, H, W]: N groups of one channel
    for i in range(len(cfg.conv_features)):
        w, bias = p[f"conv{i}"]["w"], p[f"conv{i}"]["b"]  # [N, O, I, 3,3,3], [N, O]
        x = F.conv3d(
            same_pad(x),
            w.reshape(-1, *w.shape[2:]),
            bias.reshape(-1),
            stride=2,
            groups=n,
        )
        x = F.relu(x)
    _, nc, d, h, w_ = x.shape
    x = x.reshape(b, n, nc // n, d, h, w_).permute(1, 0, 3, 4, 5, 2)  # [N,B,D,H,W,C]
    x = x.reshape(n, b, -1)
    lh = F.relu(torch.bmm(loc, p["loc"]["w"]) + p["loc"]["b"][:, None])
    x = torch.cat([x, lh], -1)
    n_fc = _n_fc(p)
    for i in range(n_fc):
        x = torch.bmm(x, p[f"fc{i}"]["w"]) + p[f"fc{i}"]["b"][:, None]
        if i < n_fc - 1:
            x = F.relu(x)
    return x


__all__ = ["dqn_apply", "dqn_apply_stacked", "dqn_init", "same_pad", "truncated_normal"]
