"""Where the model zoo's train step spends its time on the card.

    PYTHONPATH=src python -m repro_torch.launch.profile_train [--steps 3]
    PYTHONPATH=src python -m repro_torch.launch.profile_train \
        --arch xlstm-125m --batch 4 --seq 256
    PYTHONPATH=src python -m repro_torch.launch.profile_train --mesh

The step ``chip_smoke.py``'s ``lm_train_main`` drives
(``python -m repro_torch.launch.train``): h2o-danube-3-4b at full width
and depth in bfloat16 with float32 moments (``opt_cfg_for``), random
weights from seed 0, batch 2, seq 1024, the reference's token stream;
or, with ``--arch``/``--batch``/``--seq``, another (``examples/
torch_train_lm_125m.py``'s: xlstm-125m, batch 4, seq 256).
One warm-up step, ``--steps`` plain steps timed one by one (host clock
around a synchronised step), then one step under ``torch.profiler``
(CPU + CUDA activities), then the same for the loss's forward and
backward alone and for the AdamW update alone.  Prints one JSON object:
the unprofiled step walls, and for the step, the forward+backward and
the update the device's busy seconds, the idle share ``1 - busy /
profiled wall``, the device operations and the ten kernels with the most
device time; the peak of device memory; the model's operations a step
(6 x params x tokens, the products' count).  ``--mesh``: the same step
through ``Model(mesh=)`` on a one-rank NCCL ``(data, model)`` mesh
(``chip_smoke.py``'s ``lm_train_mesh``: every collective issued over
groups of one); the step's ten host operations with the most CPU time
are printed either way.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch
from torch.profiler import profile

from repro_torch.configs.base import get_config, param_count
from repro_torch.data.pipeline import TokenStreamConfig, token_batches
from repro_torch.experiments.profile import ACTIVITIES, device_summary
from repro_torch.launch.mesh import one_rank_device_mesh
from repro_torch.launch.specs import opt_cfg_for
from repro_torch.models.model import Model, value_and_grad
from repro_torch.optim.adamw import tree_adamw_update

ARCH, BATCH, SEQ = "h2o-danube-3-4b", 2, 1024


def _timed(fn) -> tuple[object, float]:
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def host_top(prof, n: int = 10) -> list[dict]:
    """The ``n`` operations with the most self CPU time."""
    rows = sorted(prof.key_averages(), key=lambda e: e.self_cpu_time_total)
    return [
        {"name": e.key[:80], "count": e.count, "ms": e.self_cpu_time_total / 1e3}
        for e in rows[::-1][:n]
    ]


def profile_train(
    steps: int,
    arch: str = ARCH,
    batch_size: int = BATCH,
    seq: int = SEQ,
    mesh=None,
) -> dict:
    cfg = get_config(arch)
    model = Model(cfg, None, opt_cfg=opt_cfg_for(cfg), mesh=mesh)
    state = model.init_train_state(0)
    stream = token_batches(TokenStreamConfig(cfg.vocab_size, seq, batch_size, seed=0))

    def batch():
        raw = next(stream)
        return {
            k: torch.tensor(raw[k] % cfg.vocab_size, device=model.device)
            for k in ("tokens", "labels")
        }

    torch.cuda.reset_peak_memory_stats()
    state, _ = model.train_step(state, batch())  # warm-up: cuBLAS, allocator
    torch.cuda.synchronize()
    walls = []
    for _ in range(steps):
        b = batch()
        (state, _), wall = _timed(lambda: model.train_step(state, b))  # noqa: B023
        walls.append(wall)
    b = batch()
    with profile(activities=ACTIVITIES) as prof:
        (state, metrics), wall = _timed(lambda: model.train_step(state, b))
    step = dict(device_summary(prof, wall), host_top=host_top(prof))
    with profile(activities=ACTIVITIES) as prof:
        (_, _, grads), fb_wall = _timed(
            lambda: value_and_grad(model.loss_fn, state["params"], b)
        )
    fwd_bwd = device_summary(prof, fb_wall)
    with profile(activities=ACTIVITIES) as prof:
        _, upd_wall = _timed(
            lambda: tree_adamw_update(
                model.opt_cfg, state["params"], grads, state["opt"]
            )
        )
    update = device_summary(prof, upd_wall)
    total, _ = param_count(cfg)
    return {
        "arch": arch,
        "mesh": None if mesh is None else "one-rank NCCL (data 1, model 1)",
        "batch": batch_size,
        "seq": seq,
        "opt_dtype": model.opt_cfg.opt_dtype,
        "step_walls_s": walls,
        "loss": float(metrics["loss"]),
        "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
        "model_tflop_per_step": 6 * total * batch_size * seq / 1e12,
        "step": step,
        "forward_backward": fwd_bwd,
        "adamw_update": update,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.profile_train")
    ap.add_argument("--steps", type=int, default=3, help="unprofiled steps timed")
    ap.add_argument("--arch", default=ARCH)
    ap.add_argument("--batch", type=int, default=BATCH)
    ap.add_argument("--seq", type=int, default=SEQ)
    ap.add_argument(
        "--mesh", action="store_true", help="through Model(mesh=) on one NCCL rank"
    )
    args = ap.parse_args(argv)
    run = (args.steps, args.arch, args.batch, args.seq)
    if args.mesh:
        torch.cuda.set_device(0)
        with one_rank_device_mesh("cuda") as mesh:
            result = profile_train(*run, mesh=mesh)
    else:
        result = profile_train(*run)
    result["device"] = torch.cuda.get_device_name(0)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
