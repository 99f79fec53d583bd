"""The DQN's operations and the fleet kernels' bytes, from the
configuration's widths (``configs/adfll-dqn.json``)."""

from __future__ import annotations

import math


def _conv_dims(dqn: dict) -> list[list[int]]:
    dims = [list(dqn["box_size"])]
    for _ in dqn["conv_features"]:
        dims.append([-(-d // 2) for d in dims[-1]])
    return dims


def forward_flops(dqn: dict) -> int:
    """Multiply-adds x 2 of one row's forward: the stride-2 3x3x3
    convolutions at their output sizes, the location layer, the dense
    layers."""
    dims = _conv_dims(dqn)
    flops, cin = 0, 1
    for i, cout in enumerate(dqn["conv_features"]):
        flops += 2 * math.prod(dims[i + 1]) * cout * cin * 27
        cin = cout
    flops += 2 * 3 * 16
    d = math.prod(dims[-1]) * cin + 16
    for h in [*dqn["hidden"], dqn["n_actions"]]:
        flops += 2 * d * h
        d = h
    return flops


def agent_step_flops(dqn: dict) -> int:
    """One agent step: the online forward, its backward (twice the
    forward) and the target net's forward, each over ``batch_size`` rows."""
    return 4 * dqn["batch_size"] * forward_flops(dqn)


def row_width(dqn: dict) -> int:
    """Floats of one flat replay row: obs, loc 3, action, reward,
    next_obs, next_loc 3, done."""
    return 2 * math.prod(dqn["box_size"]) + 9


def replay_gather_bytes(dqn: dict, rows: int) -> int:
    """Kernel A gathering ``rows`` rows: each row read and written once,
    its index and its weight read."""
    return rows * (2 * 4 * row_width(dqn) + 4 + 4)


def fused_td_bytes(dqn: dict, n: int) -> int:
    """Kernel B for ``n`` agents: q and q_next read, the action, reward
    and done columns of the rows read; the per-row loss and clipped
    delta, the per-agent loss and the q gradient written."""
    b, a = dqn["batch_size"], dqn["n_actions"]
    read = 2 * n * b * a + 3 * n * b
    written = 2 * n * b + n + n * b * a
    return 4 * (read + written)
