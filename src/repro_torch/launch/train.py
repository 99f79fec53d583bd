"""Training driver of the model zoo (the reference's
``repro/launch/train.py``).

Runs on the CUDA card unless ``--device cpu`` is given:

    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch h2o-danube-3-4b-smoke --steps 3 --batch 2 --seq 64 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch h2o-danube-3-4b --steps 4 --batch 2 --seq 1024

The weights are random, drawn on the device from a generator seeded by
``--seed``; the batches are the reference's synthetic token stream
(``data/pipeline.py::token_batches``, numpy, the same seed), ids taken
modulo the vocabulary.  A config whose input is embeddings (qwen2-vl-2b,
musicgen-medium) takes, as the reference's driver does, standard-normal
``[B, S, d_model]`` float32 embeds from numpy's ``default_rng(seed)``
and the stream's labels.  It prints the reference's lines: the parameter
count, ``step i loss= gnorm=`` at every tenth of the run and the last
step, and the steps' wall and tokens a second.

``--production-mesh`` trains on the reference's production mesh, here
``{data 32, model 8}`` = 256 H100s: eight a node joined by NVLink carry
``model``, 32 nodes carry ``data``.  Start it with ``torchrun
--nproc_per_node 8 --nnodes 32 ... -m repro_torch.launch.train --arch
<id> --production-mesh`` (``torchrun`` sets ``WORLD_SIZE``, ``RANK``,
``LOCAL_RANK`` and the rendezvous); each rank joins NCCL on ``env://``,
takes card ``LOCAL_RANK`` and trains through ``Model(mesh=)``: its blocks
of the params and optimizer state, tensor parallel over ``model`` and
FSDP over ``data``, every rank drawing the same token stream from
``--seed`` and keeping its rows.  Rank 0 prints the lines above and the
bytes of params and optimizer state it holds; ``--ckpt`` saves the
whole params (gathered) from rank 0.  In a world of any other size it
raises.  :func:`train_on_mesh` is the body after the mesh is built.
"""

from __future__ import annotations

import argparse
import math
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint import save_pytree
from repro_torch.configs.base import get_config
from repro_torch.data.pipeline import TokenStreamConfig, token_batches
from repro_torch.launch.mesh import device_mesh, make_production_mesh
from repro_torch.launch.specs import opt_cfg_for
from repro_torch.models.model import Model, meta_params
from repro_torch.models.sharding import ShardingPolicy
from repro_torch.optim.adamw import tree_leaves


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", required=True, help="config id; <id>-smoke on the CPU")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument(
        "--device", default=None, help="torch device (default: the CUDA card)"
    )
    ap.add_argument(
        "--production-mesh",
        action="store_true",
        help="train on the {data 32, model 8} mesh of a 256-rank torchrun world",
    )
    return ap


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def _train(args, model: Model, say) -> dict:
    """The reference's loop: the token stream from ``--seed`` (every rank
    the same global batch), ``say`` the lines; returns the final state."""
    cfg = model.cfg
    dev = model.device
    state = model.init_train_state(args.seed)
    n_params = sum(math.prod(x.shape) for x in tree_leaves(meta_params(cfg)))
    n_m = n_params / 1e6
    say(f"{cfg.name}: {n_m:.2f}M params, {cfg.n_layers}L d={cfg.d_model}")
    if model.mesh is not None:
        p_gb, o_gb = _nbytes(state["params"]) / 1e9, _nbytes(state["opt"]) / 1e9
        say(f"rank 0 holds {p_gb:.4f} GB of params, {o_gb:.4f} GB of optimizer state")

    sc = TokenStreamConfig(
        vocab_size=cfg.vocab_size,
        seq_len=args.seq,
        batch_size=args.batch,
        seed=args.seed,
    )
    stream = token_batches(sc)
    rng = np.random.default_rng(args.seed)

    t0 = time.time()
    for i in range(args.steps):
        raw = next(stream)
        batch = {"labels": torch.tensor(raw["labels"] % cfg.vocab_size, device=dev)}
        if cfg.input_kind == "embeds":
            shape = (args.batch, args.seq, cfg.d_model)
            emb = rng.standard_normal(shape).astype(np.float32)
            batch["embeds"] = torch.tensor(emb, device=dev)
        else:
            batch["tokens"] = torch.tensor(raw["tokens"] % cfg.vocab_size, device=dev)
        state, metrics = model.train_step(state, batch)
        if i % max(1, args.steps // 10) == 0 or i == args.steps - 1:
            loss = float(metrics["loss"])
            gnorm = float(metrics["grad_norm"])
            say(f"step {i:4d} loss={loss:.4f} gnorm={gnorm:.3f}")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.time() - t0
    tok_s = args.steps * args.batch * args.seq / dt
    say(f"{args.steps} steps in {dt:.1f}s ({tok_s:.0f} tok/s)")
    return state


def train_on_mesh(args, mesh, policy: ShardingPolicy = ShardingPolicy()) -> int:
    """The meshed run once the process group and ``mesh`` (a ``(data,
    model)`` ``DeviceMesh``) exist: ``args`` as :func:`main` parses them
    (``args.device`` this rank's device).  Rank 0 prints; ``--ckpt``
    gathers the whole params on every rank and rank 0 saves them."""
    cfg = get_config(args.arch)
    model = Model(cfg, args.device, opt_cfg=opt_cfg_for(cfg), mesh=mesh, policy=policy)
    rank0 = dist.get_rank() == 0

    def say(line):
        if rank0:
            print(line, flush=True)

    state = _train(args, model, say)
    if args.ckpt:
        whole = model.gather(state["params"])
        if rank0:
            save_pytree(args.ckpt, whole)
        say(f"saved params -> {args.ckpt}")
    return 0


def _production(args) -> int:
    shape = make_production_mesh()
    need = math.prod(shape.values())
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world != need:
        raise SystemExit(
            f"--production-mesh trains on {need} ranks ({shape}: torchrun "
            f"--nproc_per_node 8 on each of 32 nodes); this world has {world}"
        )
    local = int(os.environ["LOCAL_RANK"])
    torch.cuda.set_device(local)
    dist.init_process_group("nccl", init_method="env://")
    try:
        args.device = f"cuda:{local}"
        return train_on_mesh(args, device_mesh(shape, "cuda"))
    finally:
        dist.destroy_process_group()


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    if args.production_mesh:
        return _production(args)
    cfg = get_config(args.arch)
    model = Model(cfg, args.device, opt_cfg=opt_cfg_for(cfg))
    state = _train(args, model, print)
    if args.ckpt:
        save_pytree(args.ckpt, state["params"])
        print(f"saved params -> {args.ckpt}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
