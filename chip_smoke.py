"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure ends the run with a
non-zero exit code and no result line:

1. device  — the card's name and power limit (``nvidia-smi``); no CUDA,
   no run.
2. build   — compile ``src/repro_torch/csrc/*.cu`` with ``nvcc`` for
   ``sm_90a`` and load the library.
3. kernels — each hand-written kernel against its plain PyTorch version
   on the card, at the fleet's shapes and at a ragged shape, with
   CUDA-event times for the kernel, the plain version and (where one
   exists) a single PyTorch library call, and the least time the card
   could take (bytes over 3.35 TB/s; both kernels are bound by bytes).
4. chunk   — one ``FleetSteps.train_chunk`` at ``DQNConfig()`` widths
   (N=4 agents, K=4 steps) on the card and on the CPU from one state,
   pool and index tensor; params must agree within 1e-4.
5. main    — the paper's deployment experiment (``paper_fig2``, fast
   variant, with ``DQNConfig()`` swapped in) through the port's runner
   on the card, with each kernel's launch count read around that run
   alone: every stacked train step launches each kernel once.

Then one line with the card as ``nvidia-smi`` reports it, one
``{"kernels": [...]}`` line, and last ``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.configs.adfll_dqn import DQNConfig  # noqa: E402
from repro_torch.core.erb import flat_width  # noqa: E402
from repro_torch.experiments.registry import get_scenario  # noqa: E402
from repro_torch.experiments.runner import build, evaluate_into  # noqa: E402
from repro_torch.kernels import lib  # noqa: E402
from repro_torch.kernels.fused_td import fused_td, fused_td_plain, td_loss  # noqa: E402
from repro_torch.kernels.replay_gather import (  # noqa: E402
    replay_gather,
    replay_gather_plain,
)
from repro_torch.optim.adamw import leaves  # noqa: E402
from repro_torch.rl.fleet import FleetSteps  # noqa: E402

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)
N_AGENTS, BATCH = 4, 32  # the fleet's minibatch rows per step: N * B


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def cuda_ms(fn, reps: int = 200, warmup: int = 20) -> float:
    """Mean device time of one ``fn()`` over ``reps`` back-to-back calls
    (CUDA events; a launch-bound call shows its launch cost here)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes: int) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def phase_device() -> tuple[str, str]:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; nothing to run")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        check=True,
        timeout=60,
    ).stdout.strip()
    emit(
        {
            "phase": "device",
            "name": name,
            "count": torch.cuda.device_count(),
            "nvidia_smi": smi,
            "torch": torch.__version__,
            "cuda": torch.version.cuda,
        }
    )
    return name, smi


def phase_build() -> None:
    t0 = time.perf_counter()
    path = lib.build()
    lib.load()
    emit({"phase": "build", "library": str(path), "seconds": time.perf_counter() - t0})


def check_replay_gather(dev) -> dict:
    rng = np.random.default_rng(0)
    feat = flat_width(DQNConfig().box_size)  # 1033
    worst = 0.0
    timed = None
    rows = N_AGENTS * BATCH
    cases = ((16384, feat, rows, True), (16384, feat, rows, False), (128, 33, 5, False))
    for cap, f, b, unit_w in cases:
        pool = torch.tensor(rng.standard_normal((cap, f)), dtype=torch.float32)
        idx = torch.tensor(rng.integers(0, cap, b), dtype=torch.int32)
        w = torch.tensor(np.ones(b) if unit_w else rng.random(b), dtype=torch.float32)
        pool, idx, w = pool.to(dev), idx.to(dev), w.to(dev)
        got = replay_gather(pool, idx, w)
        want = replay_gather_plain(pool, idx, w)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        require(torch.equal(got, want), f"replay_gather {cap}x{f}/{b}: max|d|={err}")
        worst = max(worst, err)
        if timed is None:  # the main path's call: w = 1 over N*B rows
            read = int(torch.unique(idx).numel())  # rows this call must read
            nbytes = read * f * 4 + b * f * 4 + b * 8
            timed = {
                "ms": cuda_ms(lambda: replay_gather(pool, idx, w)),
                "plain_ms": cuda_ms(lambda: replay_gather_plain(pool, idx, w)),
                "library_ms": cuda_ms(lambda: torch.index_select(pool, 0, idx)),
                "bound_ms": bound_ms(nbytes),
                "shape": [cap, f, b],
            }
    emit({"phase": "kernel", "name": "replay_gather", "max_abs_err": worst, **timed})
    return {"max_abs_err": worst, **timed}


def check_fused_td(dev) -> dict:
    rng = np.random.default_rng(1)
    gamma = DQNConfig().gamma
    worst = 0.0
    timed = None
    for b, a in ((N_AGENTS * BATCH, 6), (200, 6)):
        ins = [
            rng.standard_normal((b, 1)),
            rng.standard_normal((b, a)),
            rng.standard_normal((b, 1)),
            rng.random((b, 1)) < 0.3,
        ]
        q_sel, q_next, r, d = (
            torch.tensor(x, dtype=torch.float32, device=dev) for x in ins
        )
        loss, dq = fused_td(q_sel, q_next, r, d, gamma)
        loss_p, dq_p = fused_td_plain(q_sel, q_next, r, d, gamma)
        # backward: the autograd.Function's g * dq against autograd
        # through the plain version, under the per-agent mean over B
        q1 = q_sel.clone().requires_grad_(True)
        td_loss(q1, q_next, r, d, gamma).mean().backward()
        q2 = q_sel.clone().requires_grad_(True)
        fused_td_plain(q2, q_next, r, d, gamma)[0].mean().backward()
        torch.cuda.synchronize()
        pairs = ((loss, loss_p, "loss"), (dq, dq_p, "dq"), (q1.grad, q2.grad, "grad"))
        for x, y, what in pairs:
            err = float((x - y).abs().max())
            worst = max(worst, err)
            require(
                torch.allclose(x, y, rtol=1e-6, atol=1e-6),
                f"fused_td B={b} {what}: max|d|={err}",
            )
        if timed is None:
            nbytes = b * (a + 3) * 4 + 2 * b * 4
            timed = {
                "ms": cuda_ms(lambda: fused_td(q_sel, q_next, r, d, gamma)),
                "plain_ms": cuda_ms(lambda: fused_td_plain(q_sel, q_next, r, d, gamma)),
                "library_ms": None,
                "bound_ms": bound_ms(nbytes),
                "shape": [b, a],
            }
    emit({"phase": "kernel", "name": "fused_td", "max_abs_err": worst, **timed})
    return {"max_abs_err": worst, **timed}


def phase_chunk(dev) -> None:
    """One train chunk at full width, card (kernels) vs CPU (plain
    versions).  1e-4: cuDNN/cuBLAS and the CPU sum in different orders
    (TF32 is off on the card), and the drift compounds over K steps."""
    cfg = DQNConfig()
    rng = np.random.default_rng(2)
    cpu_steps = FleetSteps(cfg, "cpu")
    slots = [cpu_steps.init_slot(seed) for seed in range(N_AGENTS)]
    state = slots[0].map(lambda *xs: torch.cat(xs), *slots[1:])
    rows, obs_f = 4096, int(np.prod(cfg.box_size))
    pool = np.concatenate(
        [
            rng.random((rows, obs_f)),
            rng.random((rows, 3)),
            rng.integers(0, cfg.n_actions, (rows, 1)),
            rng.standard_normal((rows, 1)),
            rng.random((rows, obs_f)),
            rng.random((rows, 3)),
            rng.random((rows, 1)) < 0.1,
        ],
        axis=1,
    ).astype(np.float32)
    idx = rng.integers(0, rows, (4, N_AGENTS, cfg.batch_size)).astype(np.int32)
    pool_t, idx_t = torch.from_numpy(pool), torch.from_numpy(idx)
    new_cpu, loss_cpu = cpu_steps.train_chunk(state, pool_t, idx_t)
    gpu_steps = FleetSteps(cfg, dev)
    new_gpu, loss_gpu = gpu_steps.train_chunk(
        state.map(lambda x: x.to(dev)), pool_t.to(dev), idx_t.to(dev)
    )
    torch.cuda.synchronize()
    diffs = new_gpu.map(lambda g, c: (g.cpu().float() - c.float()).abs().max(), new_cpu)
    p_err = max(float(x) for x in leaves(diffs.params) + leaves(diffs.target))
    l_err = float((loss_gpu.cpu() - loss_cpu).abs().max())
    emit(
        {
            "phase": "chunk",
            "agents": N_AGENTS,
            "steps": 4,
            "params_max_abs_err": p_err,
            "loss_max_abs_err": l_err,
        }
    )
    require(bool(torch.isfinite(loss_gpu).all()), "train chunk: non-finite loss")
    require(p_err <= 1e-4, f"train chunk params differ by {p_err}")
    require(l_err <= 1e-4, f"train chunk losses differ by {l_err}")


def phase_main(dev) -> dict[str, int]:
    spec = replace(get_scenario("paper_fig2"), dqn=DQNConfig())
    system = build(spec, fast=True, device=dev)
    replay_gather.launches = 0
    fused_td.launches = 0
    t0 = time.perf_counter()
    report = system.run()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = {"replay_gather": replay_gather.launches, "fused_td": fused_td.launches}
    t1 = time.perf_counter()
    evaluate_into(report, system, spec.fast())
    eval_s = time.perf_counter() - t1
    engine = system.engine
    emit(
        {
            "phase": "main",
            "scenario": "paper_fig2 --fast, dqn=DQNConfig()",
            "cuts": "none",
            "mean_dist_err": report.mean_dist_err,
            "n_rounds": report.n_rounds,
            "run_s": run_s,
            "eval_s": eval_s,
            "agent_steps": engine.n_steps_trained,
            "stacked_steps": engine.n_chunk_steps,
            "flushes": engine.n_flushes,
            "agent_steps_per_s": engine.n_steps_trained / run_s,
            "launches": launches,
        }
    )
    want_rounds = spec.sys.n_agents * spec.sys.rounds
    require(
        report.n_rounds == want_rounds, f"{report.n_rounds} rounds, not {want_rounds}"
    )
    require(bool(np.isfinite(report.mean_dist_err)), "mean_dist_err is not finite")
    require(engine.n_chunk_steps > 0, "the main path trained nothing")
    for name, n in launches.items():
        require(
            n == engine.n_chunk_steps,
            f"{name} launched {n} times for {engine.n_chunk_steps} stacked steps",
        )
    return launches


def main() -> int:
    kind, smi = phase_device()
    dev = torch.device("cuda")
    phase_build()
    results = {
        "replay_gather": check_replay_gather(dev),
        "fused_td": check_fused_td(dev),
    }
    phase_chunk(dev)
    launches = phase_main(dev)
    meta = {
        "replay_gather": (
            "src/repro_torch/csrc/replay_gather.cu",
            "src/repro/kernels/replay_gather/kernel.py:31",
        ),
        "fused_td": (
            "src/repro_torch/csrc/fused_td.cu",
            "src/repro/kernels/fused_td/kernel.py:38",
        ),
    }
    kernels = [
        {
            "name": name,
            "route": "cuda",
            "source": meta[name][0],
            "replaces": meta[name][1],
            "launches": launches[name],
            "max_abs_err": r["max_abs_err"],
            "ms": r["ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": "bytes",
            "library_ms": r["library_ms"],
            "shape": r["shape"],
            "check": "pass",
        }
        for name, r in results.items()
    ]
    print(smi)
    emit({"kernels": kernels})
    device = {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}
    emit({"ok": True, "device": device})
    return 0


if __name__ == "__main__":
    sys.exit(main())
