"""ADFLL beyond the paper, on the PyTorch port: federated lifelong learning
of TRANSFORMERS, as ``examples/federated_lm.py`` runs it.

The paper's mechanism is experience-level, hence architecture-agnostic.
Here three agents — each running a *different* zoo architecture (dense,
MoE, xLSTM; heterogeneity no weight-averaging scheme could support) —
train on disjoint synthetic text styles and share LM ERBs through a hub.
Replay of foreign ERBs reduces per-style loss on styles an agent never
saw natively, and protects against forgetting its own style.

On the CUDA card unless ``--device cpu`` is given:

    PYTHONPATH=src python examples/torch_federated_lm.py [--steps 25] \
        [--seeds 0 1 2] [--device cpu]
"""

import argparse

import numpy as np
import torch

from repro_torch.configs.base import get_config
from repro_torch.core.hub import Hub
from repro_torch.core.lifelong import LifelongTrainer
from repro_torch.core.network import Network
from repro_torch.data.pipeline import TokenStreamConfig, lm_task_erb
from repro_torch.device import resolve_device
from repro_torch.launch.specs import opt_cfg_for
from repro_torch.models.model import init_train_state, make_loss_fn, make_train_step

ARCHS = ["h2o-danube-3-4b-smoke", "qwen3-moe-235b-a22b-smoke", "xlstm-125m-smoke"]
VOCAB = 512
SEQ = 64
STEPS_PER_ROUND = 25


def to_device(cfg, batch, device) -> dict:
    """An ERB batch of numpy ids on ``device``, ids taken modulo the vocab."""
    return {
        k: torch.tensor(v % cfg.vocab_size, device=device) for k, v in batch.items()
    }


def build_agent(arch, seed, device):
    cfg = get_config(arch)
    opt = opt_cfg_for(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    state = init_train_state(cfg, gen, opt)
    raw_step = make_train_step(cfg, opt)
    loss_fn = make_loss_fn(cfg)

    def np_step(state, batch):
        return raw_step(state, to_device(cfg, batch, device))

    tr = LifelongTrainer(np_step, state, batch_size=8, rng=np.random.default_rng(seed))
    return cfg, tr, loss_fn


@torch.no_grad()
def eval_style(cfg, loss_fn, params, style, device) -> float:
    sc = TokenStreamConfig(VOCAB, SEQ, 16, seed=999, n_styles=4)
    erb = lm_task_erb(sc, style=style, n_batches=1)
    _, m = loss_fn(params, to_device(cfg, erb.data, device))
    return float(m["loss"])


def main(argv=None) -> dict:
    """Runs the federation; returns ``{"losses": the last training loss of
    each agent and round, "table": the per-style eval losses (rows:
    agents, cols: styles), "n_incoming": foreign ERBs learned}``."""
    ap = argparse.ArgumentParser(prog="examples/torch_federated_lm.py")
    ap.add_argument("--steps", type=int, default=STEPS_PER_ROUND, help="a round")
    ap.add_argument("--seeds", type=int, nargs=len(ARCHS), default=[0, 1, 2])
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    net = Network(hubs=[Hub(0), Hub(1)])
    agents = []
    for i, arch in enumerate(ARCHS):
        net.attach_agent(i)
        agents.append(build_agent(arch, args.seeds[i], device))
    sc = TokenStreamConfig(VOCAB, SEQ, 8, seed=0, n_styles=4)
    losses, n_incoming = [], []

    print("round 0: every agent trains its own style, shares its ERB")
    for i, (cfg, tr, _) in enumerate(agents):
        erb = lm_task_erb(sc, style=i, n_batches=8, source_agent=i)
        losses.append(tr.steps(args.steps, erb)["loss"])
        shared = erb  # LM ERBs are already a selective slice
        net.agent_push(i, shared)
    net.sync()

    print("round 1: agents pull foreign ERBs and lifelong-learn them")
    for i, (cfg, tr, _) in enumerate(agents):
        incoming = net.agent_pull(i, tr.seen_erb_ids).records
        erb = lm_task_erb(sc, style=i, n_batches=8, source_agent=i)
        losses.append(tr.steps(args.steps, erb, incoming=incoming)["loss"])
        n_incoming.append(len(incoming))
        print(
            f"  agent{i} ({cfg.name}): learned from {len(incoming)} "
            f"foreign ERBs"
        )

    print("\nper-style eval loss (rows: agents/archs, cols: styles):")
    table = []
    for i, (cfg, tr, loss_fn) in enumerate(agents):
        row = [
            eval_style(cfg, loss_fn, tr.state["params"], s, device)
            for s in range(len(ARCHS))
        ]
        table.append(row)
        own = row[i]
        print(
            f"  {cfg.name:32s} "
            + " ".join(f"{x:6.3f}" for x in row)
            + f"   (own style: {own:.3f})"
        )
    print(
        "\nheterogeneous architectures, one federation — no weight "
        "averaging involved."
    )
    return {"losses": losses, "table": table, "n_incoming": n_incoming}


if __name__ == "__main__":
    main()
