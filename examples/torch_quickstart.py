"""Quickstart on the PyTorch port: the three layers of the framework, as
``examples/quickstart.py`` shows them.

1. model zoo   — one reduced config, one train step, one decode step
2. ADFLL core  — two agents share experience through a hub
3. kernels     — the flash-attention kernel (its scalar float32 route)
                 vs its plain version

On the CUDA card unless ``--device cpu`` is given (on the CPU every
kernel wrapper runs its plain version, so section 3's error is 0):

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""

import argparse

import numpy as np
import torch

from repro_torch.configs.adfll_dqn import DQNConfig
from repro_torch.configs.base import get_config
from repro_torch.core.erb import TaskTag
from repro_torch.core.hub import Hub
from repro_torch.core.network import Network
from repro_torch.core.plane import WeightPlane, staleness_alphas
from repro_torch.device import resolve_device
from repro_torch.kernels.flash_attention import attention_plain, flash_attention
from repro_torch.models.model import build_model
from repro_torch.rl.agent import DQNAgent
from repro_torch.rl.env import LandmarkEnv
from repro_torch.rl.synth import make_volume


def zoo(device) -> dict:
    """One train step and one decode step of the reduced MoE config."""
    cfg = get_config("qwen3-moe-235b-a22b-smoke")  # reduced MoE variant
    model = build_model(cfg, device=device)
    state = model.init_train_state(0)
    rng = np.random.default_rng(0)
    batch = {
        "tokens": rng.integers(0, cfg.vocab_size, (2, 64)),
        "labels": rng.integers(0, cfg.vocab_size, (2, 64)),
    }
    batch = {
        k: torch.tensor(v, dtype=torch.int32, device=model.device)
        for k, v in batch.items()
    }
    state, metrics = model.train_step(state, batch)
    loss, aux = float(metrics["loss"]), float(metrics["aux"])
    print(f"[zoo] {cfg.name}: loss={loss:.3f} aux={aux:.3f}")
    caches = model.init_caches(2, 16)
    zeros = torch.zeros((2,), dtype=torch.int32, device=model.device)
    with torch.no_grad():
        logits, caches = model.serve_step(
            state["params"], caches, {"tokens": zeros[:, None], "pos": zeros}
        )
    print(f"[zoo] decode logits {tuple(logits.shape)}")
    return {"loss": loss, "aux": aux, "logits": logits}


def adfll(device) -> dict:
    """Two agents share an ERB through a hub; then the weight plane."""
    dqn = DQNConfig(
        volume_shape=(16, 16, 16),
        box_size=(6, 6, 6),
        conv_features=(4,),
        hidden=(32,),
        max_episode_steps=12,
        batch_size=16,
    )
    task_a = TaskTag("t1", "axial", "HGG")
    task_b = TaskTag("t2", "coronal", "LGG")
    net = Network(hubs=[Hub(0)])
    net.attach_agent(0)
    net.attach_agent(1)
    a0 = DQNAgent(0, dqn, seed=0, device=device)
    a1 = DQNAgent(1, dqn, seed=1, device=device)
    vol, lm = make_volume(task_a, 0, n=16)
    shared, loss0 = a0.train_round(
        LandmarkEnv(vol, lm, dqn),
        task_a,
        (),
        erb_capacity=512,
        share_size=64,
        train_steps=20,
    )
    net.agent_push(0, shared)  # A0 -> hub
    incoming = net.agent_pull(1, a1.seen_erb_ids).records
    vol, lm = make_volume(task_b, 1, n=16)
    _, loss = a1.train_round(
        LandmarkEnv(vol, lm, dqn),
        task_b,
        incoming,
        erb_capacity=512,
        share_size=64,
        train_steps=20,
    )
    print(
        f"[adfll] agent1 trained on its task + {len(incoming)} foreign "
        f"ERB(s) from the hub, loss={loss:.4f}"
    )

    # -- 2b. weight plane: FedAsync-style parameter snapshots through the
    # same hub, mixed with staleness-discounted rates alpha * s(dtau)
    net.register_plane(WeightPlane(max_versions=2))
    net.agent_push(0, a0.snapshot_params(sim_time=1.0), plane="weights")
    snaps = net.agent_pull(1, a1.seen_snap_ids, plane="weights").records
    alphas = staleness_alphas(snaps, a1.rounds_done, alpha=0.5, flag="poly")
    n = a1.mix_params(snaps, alphas)
    print(
        f"[adfll] agent1 mixed {n} peer weight snapshot(s), "
        f"alpha={[round(float(a), 3) for a in alphas]}"
    )
    return {"loss0": loss0, "loss": loss, "n_incoming": len(incoming), "n_mixed": n}


def kernels(device) -> dict:
    """The flash-attention kernel on float32 operands (its scalar route on
    the card) against its plain version."""
    rng = np.random.default_rng(0)

    def operand(heads):
        x = rng.standard_normal((1, 128, heads, 32))
        return torch.tensor(x, dtype=torch.float32, device=device)

    q, k, v = operand(4), operand(2), operand(2)
    before = flash_attention.launches_by_route["scalar"]
    out = flash_attention(q, k, v)
    launches = flash_attention.launches_by_route["scalar"] - before
    err = float((out - attention_plain(q, k, v)).abs().max())
    how = "scalar route" if device.type == "cuda" else "plain version"
    print(f"[kernels] flash attention ({how}) max err vs plain: {err:.2e}")
    return {"err": err, "scalar_launches": launches}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="examples/torch_quickstart.py")
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    out = {"zoo": zoo(device), "adfll": adfll(device), "kernels": kernels(device)}
    print("done.")
    return out


if __name__ == "__main__":
    main()
