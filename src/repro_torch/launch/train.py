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
step, and the steps' wall and tokens a second.  There is no production
mesh: one card holds the model.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch.checkpoint import save_pytree
from repro_torch.configs.base import get_config
from repro_torch.data.pipeline import TokenStreamConfig, token_batches
from repro_torch.launch.specs import opt_cfg_for
from repro_torch.models.model import Model
from repro_torch.optim.adamw import tree_leaves


def main(argv=None) -> int:
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
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    model = Model(cfg, args.device, opt_cfg=opt_cfg_for(cfg))
    dev = model.device
    state = model.init_train_state(args.seed)
    n_params = sum(x.numel() for x in tree_leaves(state["params"]))
    n_m = n_params / 1e6
    print(f"{cfg.name}: {n_m:.2f}M params, {cfg.n_layers}L d={cfg.d_model}")

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
            print(f"step {i:4d} loss={loss:.4f} gnorm={gnorm:.3f}")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.time() - t0
    tok_s = args.steps * args.batch * args.seq / dt
    print(f"{args.steps} steps in {dt:.1f}s ({tok_s:.0f} tok/s)")
    if args.ckpt:
        save_pytree(args.ckpt, state["params"])
        print(f"saved params -> {args.ckpt}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
