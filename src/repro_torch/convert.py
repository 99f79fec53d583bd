"""Carry the reference's parameters and training state into the port.

The inputs are nested dicts of numpy arrays (the reference's pytrees
after ``tree_map(np.asarray, ...)``); nothing here imports JAX.  Conv
weights go DHWIO -> OIDHW (the reference's ``conv_general_dilated``
layout -> ``torch.nn.functional.conv3d``'s); ``loc``/``fc*`` weights
keep the ``x @ w`` layout and biases stay as they are.  Leading axes
(a stacked agent axis) pass through untouched, so the same functions
convert one agent's tree and a stacked fleet's.

The port's own init cannot reproduce JAX's threefry bits, so tests seed
the port from converted reference params.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.rl.fleet import FleetState


def _is_conv(name: str) -> bool:
    return name.startswith("conv")


def dqn_params_from_numpy(tree: dict, device: str | torch.device = "cpu") -> dict:
    """Reference DQN params (numpy) -> port params (tensors on ``device``)."""
    out = {}
    for layer, leaves in tree.items():
        out[layer] = {}
        for name, v in leaves.items():
            v = np.asarray(v, np.float32)
            if _is_conv(layer) and name == "w":
                # [..., kd, kh, kw, I, O] -> [..., O, I, kd, kh, kw]
                v = np.moveaxis(v, (-1, -2), (-5, -4))
            out[layer][name] = torch.tensor(v, device=device)  # a copy
    return out


def dqn_params_to_numpy(params: dict) -> dict:
    """Port DQN params -> the reference's numpy layout (exact inverse)."""
    out = {}
    for layer, leaves in params.items():
        out[layer] = {}
        for name, t in leaves.items():
            v = t.detach().cpu().numpy()
            if _is_conv(layer) and name == "w":
                v = np.moveaxis(v, (-5, -4), (-1, -2))
            out[layer][name] = np.ascontiguousarray(v)
    return out


def adamw_state_from_numpy(opt: dict, device: str | torch.device = "cpu") -> dict:
    """Reference AdamW state ``{m, v, count}`` -> port tensors."""
    return {
        "m": dqn_params_from_numpy(opt["m"], device),
        "v": dqn_params_from_numpy(opt["v"], device),
        "count": torch.tensor(np.asarray(opt["count"], np.int32), device=device),
    }


def adamw_state_to_numpy(opt: dict) -> dict:
    return {
        "m": dqn_params_to_numpy(opt["m"]),
        "v": dqn_params_to_numpy(opt["v"]),
        "count": opt["count"].cpu().numpy(),
    }


def fleet_state_from_numpy(
    state: dict, device: str | torch.device = "cpu"
) -> FleetState:
    """A stacked reference fleet state as a numpy dict (``params``,
    ``target``, ``opt``, ``count``) -> :class:`FleetState` on ``device``.
    The reference's per-slot PRNG keys have no counterpart and are
    dropped."""
    return FleetState(
        params=dqn_params_from_numpy(state["params"], device),
        target=dqn_params_from_numpy(state["target"], device),
        opt=adamw_state_from_numpy(state["opt"], device),
        count=torch.tensor(np.asarray(state["count"], np.int32), device=device),
    )


def fleet_state_to_numpy(state: FleetState) -> dict:
    """Port :class:`FleetState` -> numpy dict (the inverse)."""
    return {
        "params": dqn_params_to_numpy(state.params),
        "target": dqn_params_to_numpy(state.target),
        "opt": adamw_state_to_numpy(state.opt),
        "count": state.count.cpu().numpy(),
    }


__all__ = [
    "adamw_state_from_numpy",
    "adamw_state_to_numpy",
    "dqn_params_from_numpy",
    "dqn_params_to_numpy",
    "fleet_state_from_numpy",
    "fleet_state_to_numpy",
]
