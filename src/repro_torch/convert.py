"""Carry the reference's parameters and training state into the port.

The inputs are nested dicts of numpy arrays (the reference's pytrees
after ``tree_map(np.asarray, ...)``); nothing here imports JAX.  Conv
weights go DHWIO -> OIDHW (the reference's ``conv_general_dilated``
layout -> ``torch.nn.functional.conv3d``'s); ``loc``/``fc*`` weights
keep the ``x @ w`` layout and biases stay as they are.  Leading axes
(a stacked agent axis) pass through untouched, so the same functions
convert one agent's tree and a stacked fleet's.

The model zoo's params (:func:`zoo_params_from_numpy`) keep the
reference's layout leaf for leaf: nested dicts, ``x @ w`` weights, the
per-group leaves stacked on a leading ``[G, ...]`` axis; its train state
(:func:`zoo_train_state_from_numpy`) adds the AdamW moments, in their own
dtype (``opt_dtype``), and the step count.  Both walk the tree whatever
its keys (the dense ``prefix`` subtree, MLA's and MoE's leaves) and keep
each leaf's dtype (float32 routers and norms beside bfloat16 weights).
A bfloat16 leaf crosses as its bits (``ml_dtypes``' bfloat16 and
torch's are the same format).

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


def _leaf_from_numpy(v, device) -> torch.Tensor:
    v = np.asarray(v)
    if v.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: same bits as torch's
        return torch.from_numpy(v.view(np.int16).copy()).view(torch.bfloat16).to(device)
    return torch.tensor(v, device=device)  # a copy


def zoo_params_from_numpy(tree: dict, device: str | torch.device = "cpu") -> dict:
    """Reference model-zoo params (``init_params``'s pytree as numpy) ->
    the port's nested dict of tensors on ``device``, dtypes kept."""
    if isinstance(tree, dict):
        return {k: zoo_params_from_numpy(v, device) for k, v in tree.items()}
    return _leaf_from_numpy(tree, device)


def zoo_params_to_numpy(tree: dict) -> dict:
    """Port model-zoo params -> numpy, dtypes kept; a bfloat16 leaf comes
    back as ``ml_dtypes.bfloat16`` where that is installed (JAX brings
    it), else as its ``uint16`` bits."""
    if isinstance(tree, dict):
        return {k: zoo_params_to_numpy(v) for k, v in tree.items()}
    t = tree.detach().cpu()
    if t.dtype != torch.bfloat16:
        return t.numpy()
    bits = t.view(torch.int16).numpy().view(np.uint16)
    try:
        import ml_dtypes
    except ImportError:
        return bits
    return bits.view(ml_dtypes.bfloat16)


def zoo_train_state_from_numpy(
    state: dict, device: str | torch.device = "cpu"
) -> dict:
    """The reference's LM train state ``{params, opt: {m, v, count}}`` as
    numpy -> the port's (``models/model.py::init_train_state``'s layout)."""
    opt = state["opt"]
    return {
        "params": zoo_params_from_numpy(state["params"], device),
        "opt": {
            "m": zoo_params_from_numpy(opt["m"], device),
            "v": zoo_params_from_numpy(opt["v"], device),
            "count": torch.tensor(np.asarray(opt["count"], np.int32), device=device),
        },
    }


def zoo_train_state_to_numpy(state: dict) -> dict:
    """The inverse of :func:`zoo_train_state_from_numpy`."""
    opt = state["opt"]
    return {
        "params": zoo_params_to_numpy(state["params"]),
        "opt": {
            "m": zoo_params_to_numpy(opt["m"]),
            "v": zoo_params_to_numpy(opt["v"]),
            "count": opt["count"].cpu().numpy(),
        },
    }


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
    "zoo_params_from_numpy",
    "zoo_params_to_numpy",
    "zoo_train_state_from_numpy",
    "zoo_train_state_to_numpy",
]
