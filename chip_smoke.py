"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure ends the run with a
non-zero exit code and no result line:

1. device  — the card's name and power limit (``nvidia-smi``); no CUDA,
   no run.
2. build   — compile ``src/repro_torch/csrc/*.cu`` with ``nvcc`` for
   ``sm_90a`` and load the library.
3. kernels — each hand-written kernel against its plain PyTorch version
   on the card, at the fleet's shapes and at a ragged shape (and
   ``replay_gather`` in every 16-byte phase of its rows; ``fused_td``, the
   whole TD tail, also with one action, with out-of-range actions and
   through its gradient, and timed as forward and backward of the tail
   through autograd, ``tail_ms``), with times for
   the kernel, the plain version and (where one exists) a single PyTorch
   library call, and the least time the card could take (bytes over 3.35
   TB/s; both kernels are bound by bytes).  Three times per kernel (see
   ``repro_torch/kernels/launch_cost.py``): ``ms``, CUDA events around
   back-to-back calls from Python (host and device together);
   ``device_ms``, 100 calls captured in one CUDA graph and replayed
   (the device alone; capture also proves the call capturable), with
   ``library_device_ms`` the same for the library call; ``floor_ms``, one
   ATen elementwise launch (``torch.mul`` that keeps its operand's dtype)
   on a tensor of about the call's output size, timed like ``ms``: the
   least one launch from Python costs on this host.
4. chunk   — one ``FleetSteps.train_chunk`` at ``DQNConfig()`` widths
   (N=4 agents, K=4 steps) on the card and on the CPU from one state,
   pool and index tensor; params must agree within 1e-4.
5. main    — the paper's deployment experiment (``paper_fig2``, fast
   variant, with ``DQNConfig()`` swapped in) through the port's runner
   on the card, with each kernel's launch count read around that run
   alone: every stacked train step launches each kernel once.
6. baselines — the paper's Table 1 comparison rows and FedAvg through
   the port's runner on the card, each at ``DQNConfig()``, ``--fast``,
   with launches read around each run alone: Agent X
   (``baseline_all_knowing``: one job of 20 x 8 steps), Agent Y
   (``baseline_partial``: 20 steps), Agent M (``baseline_sequential``:
   8 rounds of 20, one flush each) and ``fedavg_sync`` (3 agents, 2
   rounds of 8 on one shared engine); every stacked step launches each
   of ``replay_gather`` and ``fused_td`` once, and after FedAvg every
   agent holds agent 0's params bit for bit.  Agent M runs on the CPU
   too, from the same init (drawn on the host): round 0's loss must
   agree within 1e-4 (its collection is all exploration, so both sides
   replay the same rows); later rounds are printed beside each other.
7. sweep — ``paper_table1_sweep`` (ADFLL against Agents X, Y and M) at
   the registry's widths, seeds 0 and 1, ``--fast``, inline
   (``workers=1``): every cell ``ok`` with a finite error; each
   variant's mean and its paired p-values against ADFLL are printed.
8. kernels — the model zoo's ``rmsnorm`` and ``flash_attention`` against
   their plain versions on the card at the serving path's shapes and at
   ragged / windowed / softcapped / odd-head-dim ones, each attention case
   on the route it must take (tensor cores for bf16 with D % 8 == 0, the
   scalar kernel otherwise), timed like phase 3 beside one PyTorch library
   call (attention: SDPA with the boolean mask, and with ``is_causal``
   where the window does not bind); rmsnorm is bound by bytes, attention
   by operations (4 B Hq D flops per unmasked pair at the dtype's peak).
   rmsnorm's cases cover both of its routes (``cta``, ``masked``), and
   each must move its route's launch count.
9. zoo_chunk — a reduced float32 h2o-danube-3-4b (2 kv heads, window 64)
   on the card and on the CPU from the same params and tokens: prefill
   of 96 tokens (past the window), then 8 decode steps; logits must
   agree within 1e-4.
10. zoo_main — ``python -m repro_torch.launch.serve`` at full width:
   h2o-danube-3-4b in bfloat16, random weights drawn on the card from
   seed 0, batch 4, prompt 1000, 32 greedy steps; launches read around
   the prefill and decode alone (24 ``flash_attention``, all on the
   tensor-core route, 49 x 33 ``rmsnorm``, all on the ``cta`` route:
   49 at prefill, 49 x 32 at decode), then decode logits
   at 4 positions against the teacher-forced ``forward`` on the card.

Then the script's wall time, one line with the card as ``nvidia-smi``
reports it, one ``{"kernels": [...]}`` line, and last ``{"ok": true,
"device": ...}``.  ``replay_gather`` and ``fused_td`` run on the fleet
paths (main, baselines, sweep): their entries carry ``launches_by_path``
and ``launches`` is its sum.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from contextlib import contextmanager
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.configs.adfll_dqn import DQNConfig  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.core.erb import flat_columns, flat_width  # noqa: E402
from repro_torch.experiments.registry import get_scenario  # noqa: E402
from repro_torch.experiments.runner import build, evaluate_into  # noqa: E402
from repro_torch.rl.agent import DQNAgent  # noqa: E402
from repro_torch.sweeps import failed_cells, get_sweep, run_sweep  # noqa: E402
from repro_torch.kernels import lib  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    attention_plain,
    flash_attention,
    route,
)
from repro_torch.kernels.fused_td import fused_td, fused_td_plain, td_loss  # noqa: E402
from repro_torch.kernels.launch_cost import cuda_ms, graph_ms  # noqa: E402
from repro_torch.kernels.replay_gather import (  # noqa: E402
    replay_gather,
    replay_gather_plain,
)
from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_plain  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models.model import Model, forward, logits_fn  # noqa: E402
from repro_torch.models.rope import positions_for  # noqa: E402
from repro_torch.optim.adamw import leaves  # noqa: E402
from repro_torch.rl.fleet import FleetSteps  # noqa: E402

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)
# dense peaks of one H100 SXM at 700 W (NVIDIA data sheet): bf16 on the
# tensor cores, float32 outside them
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
N_AGENTS, BATCH = 4, 32  # the fleet's minibatch rows per step: N * B
ZOO_ARCH = "h2o-danube-3-4b"
ZOO_BATCH, ZOO_PROMPT, ZOO_GEN = 4, 1000, 32
RMS_EPS = get_config(ZOO_ARCH).norm_eps
KERNELS = (replay_gather, fused_td, rmsnorm, flash_attention)
FLEET_KERNELS = ("replay_gather", "fused_td")
# Table 1 / FedAvg scenarios: (n_rounds, stacked train steps) at --fast
BASELINES = {
    "baseline_all_knowing": (1, 160),
    "baseline_partial": (1, 20),
    "baseline_sequential": (8, 160),
    "fedavg_sync": (6, 16),
}
# sub-entries and extra times a kernel's entry of the kernels line carries
EXTRA_FIELDS = (
    "tail_ms",
    "plain_tail_ms",
    "tail_floor_ms",
    "decode",
    "window",
    "library_causal_ms",
    "library_causal_device_ms",
)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def bound_ms(nbytes: int) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def sector_bytes(base: int, offsets) -> int:
    """Bytes of the distinct 32-byte sectors that 4-byte loads at byte
    ``offsets`` from address ``base`` touch: what a gather must move."""
    return 32 * len({(base + int(o)) // 32 for o in offsets})


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


def timings(fn, library, floor, **kw) -> dict:
    """``ms`` and ``device_ms`` of the kernel's call, the same two of the
    library call (None where there is none), and ``floor_ms``."""
    return {
        "ms": cuda_ms(fn, **kw),
        "device_ms": graph_ms(fn),
        "library_ms": None if library is None else cuda_ms(library, **kw),
        "library_device_ms": None if library is None else graph_ms(library),
        "floor_ms": cuda_ms(floor, **kw),
    }


def check_replay_gather(dev) -> dict:
    """The main path's call (w = 1 over N * B rows), a weighted one, a
    narrow one, and every (destination, source) phase of a 16-byte vector
    at the fleet's width: output rows i of each i % 4 read pool rows of
    each idx % 4 (1033 = 1 mod 4), from a pool based on and 4 bytes off a
    16-byte boundary.  Exact: a copy and one multiply."""
    rng = np.random.default_rng(0)
    feat = flat_width(DQNConfig().box_size)  # 1033
    worst = 0.0
    timed = None
    rows = N_AGENTS * BATCH
    i = np.arange(64)
    phased = 4 * (i // 4 + 3 * (i % 7)) + (i // 16 + i) % 4  # all 16 pairs
    cases = (
        (16384, feat, rng.integers(0, 16384, rows), True, 0),
        (16384, feat, rng.integers(0, 16384, rows), False, 0),
        (128, 33, rng.integers(0, 128, 5), False, 0),
        (256, feat, phased, False, 0),
        (256, feat, phased, False, 1),
    )
    for cap, f, idx_np, unit_w, offset in cases:
        b = len(idx_np)
        flat = torch.tensor(rng.standard_normal(cap * f + offset), dtype=torch.float32)
        pool = flat.to(dev)[offset:].view(cap, f)  # contiguous, maybe 4 B off
        idx = torch.tensor(idx_np, dtype=torch.int32, device=dev)
        w = torch.tensor(np.ones(b) if unit_w else rng.random(b), dtype=torch.float32)
        w = w.to(dev)
        got = replay_gather(pool, idx, w)
        want = replay_gather_plain(pool, idx, w)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        what = f"replay_gather {cap}x{f}/{b}, pool {4 * offset} B off"
        require(torch.equal(got, want), f"{what}: max|d|={err}")
        worst = max(worst, err)
        if timed is None:  # the main path's call: w = 1 over N*B rows
            read = int(torch.unique(idx).numel())  # rows this call must read
            w_col = w[:, None]
            nbytes = read * f * 4 + b * f * 4 + b * 8
            timed = {
                **timings(
                    lambda: replay_gather(pool, idx, w),
                    lambda: torch.index_select(pool, 0, idx),
                    lambda: torch.mul(got, w_col),
                ),
                "plain_ms": cuda_ms(lambda: replay_gather_plain(pool, idx, w)),
                "bound_ms": bound_ms(nbytes),
                "shape": [cap, f, b],
            }
    emit({"phase": "kernel", "name": "replay_gather", "max_abs_err": worst, **timed})
    return {"max_abs_err": worst, **timed}


def check_fused_td(dev) -> dict:
    """The fleet's TD tail (N=4 agents, B=32 rows, A=6 actions, rows of
    F=1033 with action, reward and done at columns 515, 516 and 1032), a
    ragged one (N=3, B=50), one agent with one action, and out-of-range
    actions (A and beyond select NaN, -1 .. -A wrap, a NaN action reads
    as 0): all four outputs, and the gradient through ``td_loss`` against
    autograd through the plain version, within 1e-6.  Timed: the main
    path's call (``ms``, ``device_ms``), and ``tail_ms``, forward and
    backward of the whole tail through autograd, beside the plain tail's
    and one multiply's (``tail_floor_ms``)."""
    rng = np.random.default_rng(1)
    cfg = DQNConfig()
    columns = flat_columns(cfg.box_size)
    cols = tuple(columns[k].start for k in ("action", "reward", "done"))
    feat, gamma = columns["done"].stop, cfg.gamma
    edge = [2.7, -0.5, np.nan, -1, -6, 6, 7, -7, -100, 1e10, 5.9, 0]
    cases = (
        ("fleet", N_AGENTS, BATCH, cfg.n_actions),
        ("ragged", 3, 50, 6),
        ("one_action", 1, 7, 1),
        ("out_of_range", 2, len(edge), 6),
    )
    worst, timed = 0.0, None
    for name, n, b, a in cases:
        q, q_next = (
            torch.tensor(
                rng.standard_normal((n, b, a)), dtype=torch.float32, device=dev
            )
            for _ in range(2)
        )
        rows_np = rng.standard_normal((n, b, feat))
        rows_np[..., cols[0]] = rng.integers(0, a, (n, b))
        rows_np[..., cols[2]] = rng.random((n, b)) < 0.3
        if name == "out_of_range":
            rows_np[0, :, cols[0]] = edge
        rows = torch.tensor(rows_np, dtype=torch.float32, device=dev)
        got = fused_td(q, q_next, rows, cols, gamma)
        want = fused_td_plain(q, q_next, rows, cols, gamma)
        grads = []
        for tail in (td_loss, lambda *xs: fused_td_plain(*xs).loss):
            leaf = q.clone().requires_grad_(True)
            loss = tail(leaf, q_next, rows, cols, gamma).sum()
            grads.append(torch.autograd.grad(loss, leaf)[0])
        torch.cuda.synchronize()
        for what, x, y in (*zip(got._fields, got, want), ("grad", *grads)):
            err = float((x - y).abs().nan_to_num(0.0).max())
            worst = max(worst, err)
            require(
                torch.allclose(x, y, rtol=1e-6, atol=1e-6, equal_nan=True),
                f"fused_td {name} {[n, b, a]} {what}: max|d|={err}",
            )
        if name == "out_of_range":
            require(
                bool(torch.isnan(got.loss[0]) and torch.isfinite(got.loss[1])),
                f"fused_td: out-of-range actions gave loss {got.loss.tolist()}",
            )
        if timed is None:  # the main path's call
            leaf = q.clone().requires_grad_(True)
            # read: q_next whole, the sectors of q that hold the selected
            # actions and the sectors of rows that hold the three columns
            # (at F = 1033 action and reward share one in 7 of 8 rows); written:
            # loss_rows, dq, loss and grad_q
            row = np.arange(n * b)
            sel = row * a + rows_np[..., cols[0]].ravel().astype(np.int64)
            row_cols = row[:, None] * feat + np.array(cols)
            nbytes = (
                4 * n * b * a
                + sector_bytes(q.data_ptr(), 4 * sel)
                + sector_bytes(rows.data_ptr(), 4 * row_cols.ravel())
                + 4 * (2 * n * b + n + n * b * a)
            )
            timed = {
                **timings(
                    lambda: fused_td(q, q_next, rows, cols, gamma),
                    None,
                    lambda: torch.mul(q_next, gamma),
                ),
                "plain_ms": cuda_ms(
                    lambda: fused_td_plain(q, q_next, rows, cols, gamma)
                ),
                "tail_ms": cuda_ms(
                    lambda: torch.autograd.grad(
                        td_loss(leaf, q_next, rows, cols, gamma).sum(), leaf
                    )
                ),
                "plain_tail_ms": cuda_ms(
                    lambda: torch.autograd.grad(
                        fused_td_plain(leaf, q_next, rows, cols, gamma).loss.sum(),
                        leaf,
                    )
                ),
                # the least a forward and backward through autograd costs
                "tail_floor_ms": cuda_ms(
                    lambda: torch.autograd.grad(torch.mul(leaf, gamma).sum(), leaf)
                ),
                "bound_ms": bound_ms(nbytes),
                "shape": [n, b, a, feat],
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


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0
    for k in (rmsnorm, flash_attention):
        k.launches_by_route = dict.fromkeys(k.launches_by_route, 0)


def read_launches() -> dict[str, int]:
    return {k.__name__: k.launches for k in KERNELS}


def phase_main(dev) -> dict[str, int]:
    spec = replace(get_scenario("paper_fig2"), dqn=DQNConfig())
    system = build(spec, fast=True, device=dev)
    reset_launches()
    t0 = time.perf_counter()
    report = system.run()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = read_launches()
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
    for name in ("replay_gather", "fused_td"):
        require(
            launches[name] == engine.n_chunk_steps,
            f"{name} launched {launches[name]} times for "
            f"{engine.n_chunk_steps} stacked steps",
        )
    return launches


@contextmanager
def round_losses():
    """Collect the loss every ``DQNAgent.train_round`` returns (Agent M's
    per-round losses, which its trainer does not return)."""
    losses: list[float] = []
    train_round = DQNAgent.train_round

    def recording(self, *args, **kw):
        shared, loss = train_round(self, *args, **kw)
        losses.append(loss)
        return shared, loss

    DQNAgent.train_round = recording
    try:
        yield losses
    finally:
        DQNAgent.train_round = train_round


def run_baseline(name: str, dev) -> tuple:
    """One Table 1 / FedAvg scenario at ``DQNConfig()``, ``--fast``, on
    ``dev``; launches read around the run alone."""
    spec = replace(get_scenario(name), dqn=DQNConfig()).fast()
    system = build(spec, device=dev)
    reset_launches()
    t0 = time.perf_counter()
    report = system.run()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = read_launches()
    t1 = time.perf_counter()
    evaluate_into(report, system, spec)
    return system, report, launches, run_s, time.perf_counter() - t1


def phase_baselines(dev) -> dict[str, dict[str, int]]:
    by_path = {}
    for name, (want_rounds, want_steps) in BASELINES.items():
        with round_losses() as losses:
            system, report, launches, run_s, eval_s = run_baseline(name, dev)
        engine = system.engine if name == "fedavg_sync" else system.agent.engine
        emit(
            {
                "phase": "baselines",
                "scenario": f"{name} --fast, dqn=DQNConfig()",
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
        require(bool(np.isfinite(report.mean_dist_err)), f"{name}: error not finite")
        require(
            report.n_rounds == want_rounds,
            f"{name}: {report.n_rounds} rounds, not {want_rounds}",
        )
        require(
            engine.n_chunk_steps == want_steps,
            f"{name}: {engine.n_chunk_steps} stacked steps, not {want_steps}",
        )
        for k in FLEET_KERNELS:
            require(
                launches[k] == want_steps,
                f"{name}: {k} launched {launches[k]} times for {want_steps} steps",
            )
        if name == "fedavg_sync":
            first = leaves(system.agents[0].params)
            for agent in system.agents[1:]:
                require(
                    all(map(torch.equal, leaves(agent.params), first)),
                    f"fedavg: agent {agent.agent_id}'s params are not agent 0's",
                )
        if name == "baseline_sequential":
            card_losses, card_err = list(losses), report.mean_dist_err
        by_path[name] = {k: launches[k] for k in FLEET_KERNELS}

    # Agent M on the CPU from the same init: the port's init is drawn on
    # the host, so both sides start from the same weights
    with round_losses() as cpu_losses:
        _, cpu_report, *_ = run_baseline("baseline_sequential", torch.device("cpu"))
    diffs = [abs(a - b) for a, b in zip(card_losses, cpu_losses, strict=True)]
    first_off = next((i for i, d in enumerate(diffs) if d > 1e-4), None)
    emit(
        {
            "phase": "baselines_card_vs_cpu",
            "scenario": "baseline_sequential --fast, dqn=DQNConfig()",
            "round_losses": [[a, b] for a, b in zip(card_losses, cpu_losses)],
            "first_round_over_1e-4": first_off,
            "mean_dist_err": [card_err, cpu_report.mean_dist_err],
        }
    )
    require(diffs[0] <= 1e-4, f"agent M round 0 loss: card vs CPU differ by {diffs[0]}")
    return by_path


def phase_sweep(dev) -> dict[str, int]:
    sweep = get_sweep("paper_table1_sweep").with_seeds((0, 1))
    reset_launches()
    t0 = time.perf_counter()
    summary = run_sweep(sweep, fast=True, workers=1, device=str(dev))
    wall_s = time.perf_counter() - t0
    launches = read_launches()
    p_values = {
        c["variant"]: {"p_ttest": c["p_ttest"], "p_permutation": c["p_permutation"]}
        for c in summary["comparisons"]
        if c["metric"] == "mean_dist_err"
    }
    emit(
        {
            "phase": "sweep",
            "sweep": "paper_table1_sweep --fast, seeds (0, 1), workers=1",
            "cuts": "seeds 0 and 1 of 5",
            "wall_s": wall_s,
            "mean_dist_err": {
                label: v["metrics"]["mean_dist_err"]["mean"]
                for label, v in summary["variants"].items()
            },
            "paired_vs_adfll": p_values,
            "cells": [
                [c["label"], c["seed"], c["status"], c["elapsed_s"]]
                for c in summary["cells"]
            ],
            "launches": launches,
        }
    )
    bad = failed_cells(summary)
    require(not bad, f"sweep cells failed: {bad}")
    require(len(summary["cells"]) == 8, f"{len(summary['cells'])} sweep cells, not 8")
    devices = {summary["device"], *(c["device"] for c in summary["cells"])}
    require(devices == {"cuda"}, f"sweep cells recorded devices {devices}")
    for label, v in summary["variants"].items():
        values = v["metrics"]["mean_dist_err"]["values"]
        require(
            len(values) == 2 and all(np.isfinite(x) for x in values.values()),
            f"sweep {label}: errors {values}",
        )
    require(
        launches["replay_gather"] == launches["fused_td"] > 0,
        f"sweep launches {launches}",
    )
    return {k: launches[k] for k in FLEET_KERNELS}


def check_rmsnorm(dev) -> dict:
    """The prefill [B*S, d] and decode [B, d] calls of the zoo main path
    (the ``cta`` route), float32 rows, many and few 16 KB rows (the
    reference's largest, d = 8192 bf16), and the ``masked`` route:
    rows of 1001 elements, whose width is no multiple of 16 bytes, rows
    over 16 KB, and an x 2 bytes off a 16-byte boundary.  Each case must
    move its route's launch count.  Tolerances: bf16 2e-2 (one bf16
    rounding, as tests/test_kernels_rmsnorm.py), f32 1e-5 (sum order and
    rsqrt)."""
    rng = np.random.default_rng(3)
    d = get_config(ZOO_ARCH).d_model
    bf, f32 = torch.bfloat16, torch.float32
    cases = (
        ("prefill", ZOO_BATCH * ZOO_PROMPT, d, bf, "cta", 0, 2e-2),
        ("decode", ZOO_BATCH, d, bf, "cta", 0, 2e-2),
        ("many_f32", 1500, 1000, f32, "cta", 0, 1e-5),
        ("many_16k", 1024, 8192, bf, "cta", 0, 2e-2),
        ("one_f32", 1, d, f32, "cta", 0, 1e-5),
        ("ragged", 37, 1000, f32, "cta", 0, 1e-5),
        ("few_16k", 4, 8192, bf, "cta", 0, 2e-2),
        ("tail", 37, 1001, f32, "masked", 0, 1e-5),
        ("tail", 5, 1001, bf, "masked", 0, 2e-2),
        ("wide", 6, 8200, bf, "masked", 0, 2e-2),
        ("unaligned", ZOO_BATCH, d, bf, "masked", 1, 2e-2),
    )
    worst, timed = 0.0, {}
    for name, n, width, dtype, way, offset, tol in cases:
        flat = torch.tensor(
            rng.standard_normal(n * width + offset), dtype=dtype, device=dev
        )
        x = flat[offset:].view(n, width)
        scale = torch.tensor(
            rng.standard_normal(width), dtype=torch.float32, device=dev
        )
        before = dict(rmsnorm.launches_by_route)
        got = rmsnorm(x, scale, RMS_EPS)
        want = rmsnorm_plain(x, scale, RMS_EPS)
        torch.cuda.synchronize()
        moved = {r: k - before[r] for r, k in rmsnorm.launches_by_route.items()}
        require(
            moved == {r: int(r == way) for r in moved},
            f"rmsnorm {name}: expected one {way} launch, got {moved}",
        )
        err = float((got.float() - want.float()).abs().max())
        require(
            torch.allclose(got.float(), want.float(), atol=tol, rtol=tol),
            f"rmsnorm {name} [{n}, {width}] {dtype}: max|d|={err}",
        )
        worst = max(worst, err)
        if name not in ("prefill", "decode"):
            continue
        nbytes = 2 * n * width * x.element_size() + width * 4
        timed[name] = {
            "route": way,
            **timings(
                lambda: rmsnorm(x, scale, RMS_EPS),
                lambda: torch.nn.functional.rms_norm(
                    x.float(), (width,), scale, RMS_EPS
                ).to(x.dtype),
                lambda: torch.mul(x, 2.0),
            ),
            "plain_ms": cuda_ms(lambda: rmsnorm_plain(x, scale, RMS_EPS)),
            "bound_ms": bound_ms(nbytes),
            "bound_by": "bytes",
            "shape": [n, width, str(dtype).removeprefix("torch.")],
        }
    main = {"max_abs_err": worst, **timed["prefill"], "decode": timed["decode"]}
    emit({"phase": "kernel", "name": "rmsnorm", **main})
    return main


def unmasked_pairs(s: int, window: int | None) -> int:
    """(query, key) pairs a causal attention over ``s`` tokens computes."""
    w = s if window is None else window
    return sum(min(i + 1, w) for i in range(s))


def attention_bound(b, s, hq, hkv, d, dtype, window) -> tuple[float, str]:
    flops = 4 * b * hq * d * unmasked_pairs(s, window)
    elem = torch.finfo(dtype).bits // 8
    nbytes = (2 * b * s * hq * d + 2 * b * s * hkv * d) * elem  # q, o, k, v
    f_ms, b_ms = flops / PEAK_FLOPS[dtype] * 1e3, bound_ms(nbytes)
    return (f_ms, "operations") if f_ms >= b_ms else (b_ms, "bytes")


def check_flash_attention(dev) -> dict:
    """The zoo main path's prefill shape, a 4608-token one with the 4096
    window live, a float32 one with a softcap, and the edges of the
    tensor-core route: a single tile, tails at S = 1000 and 130, GQA
    groups 1, 4 and 8, a window that cuts inside a tile, a bf16 softcap,
    D = 40 (one zero-padded half) and D = 36 (the scalar route).  v has a
    different spread for every key, so a key taken in the wrong order
    shows.  Each case must move its route's launch count.  Tolerances: bf16
    3e-2 (as tests/test_kernels.py), f32 2e-5."""
    rng = np.random.default_rng(4)
    cfg = get_config(ZOO_ARCH)
    hq, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    w = cfg.sliding_window
    bf, f32 = torch.bfloat16, torch.float32
    cases = (
        ("main", ZOO_BATCH, ZOO_PROMPT, hq, hkv, d, bf, w, 0.0, 3e-2),
        ("window", 1, 4608, hq, hkv, d, bf, w, 0.0, 3e-2),
        ("softcap", 2, 333, 8, 2, d, f32, None, 30.0, 2e-5),
        ("tile", 1, 64, 1, 1, 64, bf, None, 0.0, 3e-2),
        ("group1", 2, 1000, 8, 8, d, bf, None, 0.0, 3e-2),
        ("group4", 1, 130, 8, 2, d, bf, None, 0.0, 3e-2),
        ("group8", 1, 130, 8, 1, d, bf, None, 0.0, 3e-2),
        ("window48", 2, 200, 4, 1, 64, bf, 48, 0.0, 3e-2),
        ("softcap_bf16", 1, 300, 4, 2, 128, bf, None, 30.0, 3e-2),
        ("d40", 2, 150, 4, 2, 40, bf, None, 0.0, 3e-2),
        ("d36", 1, 150, 4, 2, 36, bf, None, 0.0, 3e-2),
    )
    sdpa = torch.nn.functional.scaled_dot_product_attention
    worst, out = 0.0, {}
    for name, b, s, nq, nkv, hd, dtype, window, cap, tol in cases:
        q, k = (
            torch.tensor(rng.standard_normal((b, s, n, hd)), dtype=dtype, device=dev)
            for n in (nq, nkv)
        )
        spread = rng.uniform(0.25, 2.0, (1, s, 1, 1))
        v = torch.tensor(
            rng.standard_normal((b, s, nkv, hd)) * spread, dtype=dtype, device=dev
        )
        kw = {"window": window, "softcap": cap}
        way = route(dtype, hd)
        before = dict(flash_attention.launches_by_route)
        got = flash_attention(q, k, v, **kw)
        want = attention_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        moved = {r: n - before[r] for r, n in flash_attention.launches_by_route.items()}
        require(
            moved == {r: int(r == way) for r in moved},
            f"flash_attention {name}: expected one {way} launch, got {moved}",
        )
        err = float((got.float() - want.float()).abs().max())
        require(
            torch.allclose(got.float(), want.float(), atol=tol, rtol=tol),
            f"flash_attention {name} {[b, s, nq, nkv, hd]} {dtype}: max|d|={err}",
        )
        worst = max(worst, err)
        if name not in ("main", "window"):
            continue
        bound, by = attention_bound(b, s, nq, nkv, hd, dtype, window)
        # SDPA's boolean mask: True = attend (causal, inside the window)
        i = torch.arange(s, device=dev)
        mask = (i[None, :] <= i[:, None]) & (i[:, None] - i[None, :] < window)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        reps = 50 if name == "main" else 20
        out[name] = {
            "route": way,
            **timings(
                lambda: flash_attention(q, k, v, **kw),
                lambda: sdpa(qt, kt, vt, attn_mask=mask, enable_gqa=True),
                lambda: torch.mul(q, 0.5),
                reps=reps,
                warmup=5,
            ),
            "bound_ms": bound,
            "bound_by": by,
            "shape": [b, s, nq, nkv, hd, str(dtype).removeprefix("torch.")],
        }
        if name == "main":
            # the window (4096) does not bind at S = 1000: is_causal computes
            # the same function and may take SDPA's flash backend
            require(s <= window, "the main case's window must not bind")
            def causal():
                return sdpa(qt, kt, vt, is_causal=True, enable_gqa=True)

            out[name]["library_causal_ms"] = cuda_ms(causal, reps=reps, warmup=5)
            out[name]["library_causal_device_ms"] = graph_ms(causal)
            out[name]["plain_ms"] = cuda_ms(
                lambda: attention_plain(q, k, v, **kw), reps=20, warmup=2
            )
        del q, k, v, got, want, mask
    main = {"max_abs_err": worst, **out["main"], "window": out["window"]}
    emit({"phase": "kernel", "name": "flash_attention", **main})
    return main


def tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: tree_to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def phase_zoo_chunk(dev) -> None:
    """A narrow float32 h2o-danube-3-4b, card (kernels) vs CPU (plain
    versions), from the same params and tokens: prefill past the window,
    then decode steps fed the same tokens.  1e-4: two devices' sum orders
    through 2 layers (TF32 off on the card)."""
    cfg = replace(get_config(ZOO_ARCH).reduced(), n_kv_heads=2, sliding_window=64)
    b, s, steps = 2, 96, 8
    rng = np.random.default_rng(5)
    toks = torch.tensor(
        rng.integers(0, cfg.vocab_size, (b, s + steps)), dtype=torch.int32
    )
    cpu, gpu = Model(cfg, "cpu"), Model(cfg, dev)
    params_cpu = cpu.init_params(0)
    params_gpu = tree_to(params_cpu, dev)
    reset_launches()
    logits = {}
    for name, model, params in (("cpu", cpu, params_cpu), ("gpu", gpu, params_gpu)):
        t = toks.to(model.device)
        last, pre = model.prefill_step(params, {"tokens": t[:, :s]})
        caches = serve.load_prefill(model.init_caches(b, s + steps), pre)
        out = [last]
        for i in range(steps):
            pos = torch.full((b,), s + i, dtype=torch.int32, device=model.device)
            lg, caches = model.serve_step(
                params, caches, {"tokens": t[:, s + i : s + i + 1], "pos": pos}
            )
            out.append(lg)
        logits[name] = torch.stack(out).float().cpu()
    torch.cuda.synchronize()
    launches = read_launches()
    err = float((logits["gpu"] - logits["cpu"]).abs().max())
    emit(
        {
            "phase": "zoo_chunk",
            "config": f"{cfg.name}, n_kv_heads=2, sliding_window=64, float32",
            "prefill": s,
            "steps": steps,
            "logits_max_abs_err": err,
            "launches": launches,
        }
    )
    require(bool(torch.isfinite(logits["gpu"]).all()), "zoo chunk: non-finite logits")
    require(err <= 1e-4, f"zoo chunk: card and CPU logits differ by {err}")
    n_layers = cfg.n_layers
    require(
        launches["flash_attention"] == n_layers
        and launches["rmsnorm"] == (2 * n_layers + 1) * (steps + 1)
        and flash_attention.launches_by_route["scalar"] == n_layers,
        f"zoo chunk: launches {launches}, {flash_attention.launches_by_route}",
    )


def phase_zoo_main(dev) -> tuple[dict[str, int], dict[str, dict[str, int]]]:
    """The serving CLI's path at full width, then decode logits at 4
    positions against the teacher-forced forward on the card.

    Tolerance: the bf16 3e-2 of tests/test_kernels.py, relative to the
    largest logit.  The two paths round differently at every bf16 product
    (a [B, 1, D] decode GEMM against a [B, S, D] one) through 24 layers of
    a bf16 residual stream, so an element-wise allclose(3e-2, 3e-2) is too
    tight at full depth (max |d| 0.057 on an H100); the float32 zoo_chunk
    holds the arithmetic itself to 1e-4."""
    t0 = time.perf_counter()
    model, params, prompt = serve.setup(ZOO_ARCH, ZOO_BATCH, ZOO_PROMPT, 0, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    cfg = model.cfg
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    out = serve.generate(model, params, prompt, ZOO_GEN)
    launches = read_launches()
    by_route = {
        "flash_attention": dict(flash_attention.launches_by_route),
        "rmsnorm": dict(rmsnorm.launches_by_route),
    }
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    # teacher-forced: the prompt and the fed tokens in one forward
    toks = torch.cat([prompt, out.tokens[:, :ZOO_GEN]], 1)
    at = [0, 10, 21, ZOO_GEN - 1]
    pos = positions_for(cfg, ZOO_BATCH, toks.shape[1], device=dev)
    hidden = forward(cfg, params, toks, pos, mode="train")[0]
    want = logits_fn(cfg, params, hidden[:, [ZOO_PROMPT + i for i in at]]).float()
    got = out.logits[at].transpose(0, 1)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    n_layers = cfg.n_layers
    emit(
        {
            "phase": "zoo_main",
            "arch": ZOO_ARCH,
            "cuts": "none (random weights from seed 0)",
            "batch": ZOO_BATCH,
            "prompt": ZOO_PROMPT,
            "gen": ZOO_GEN,
            "init_s": init_s,
            "prefill_s": out.prefill_s,
            "decode_s": out.decode_s,
            "decode_tok_per_s": ZOO_GEN * ZOO_BATCH / out.decode_s,
            "peak_gb": peak_gb,
            "launches": launches,
            "launches_by_route": by_route,
            "teacher_forced_positions": at,
            "teacher_forced_max_abs_err": err,
            "teacher_forced_max_abs_logit": scale,
            "teacher_forced_argmax_agree": agree,
            "sample_ids": out.tokens[0, :8].tolist(),
        }
    )
    require(bool(torch.isfinite(out.logits).all()), "zoo main: non-finite logits")
    require(
        launches["flash_attention"] == n_layers,
        f"flash_attention launched {launches['flash_attention']} times, not {n_layers}",
    )
    require(
        by_route["flash_attention"] == {"wgmma": n_layers, "scalar": 0},
        f"flash_attention routes {by_route}: every prefill layer must take wgmma",
    )
    want_rms = (2 * n_layers + 1) * (ZOO_GEN + 1)
    require(
        launches["rmsnorm"] == want_rms,
        f"rmsnorm launched {launches['rmsnorm']} times, not {want_rms}",
    )
    want_routes = {"cta": want_rms, "masked": 0}
    require(
        by_route["rmsnorm"] == want_routes,
        f"rmsnorm routes {by_route['rmsnorm']}, not {want_routes}",
    )
    require(
        err <= 3e-2 * scale,
        f"zoo main: decode vs teacher-forced logits max|d|={err}, max|logit|={scale}",
    )
    return launches, by_route


def main() -> int:
    t_start = time.perf_counter()
    kind, smi = phase_device()
    dev = torch.device("cuda")
    phase_build()
    results = {
        "replay_gather": check_replay_gather(dev),
        "fused_td": check_fused_td(dev),
    }
    phase_chunk(dev)
    main_launches = phase_main(dev)
    by_path = {"main": {k: main_launches[k] for k in FLEET_KERNELS}}
    by_path.update(phase_baselines(dev))
    by_path["sweep"] = phase_sweep(dev)
    launches = {k: sum(p[k] for p in by_path.values()) for k in FLEET_KERNELS}
    results["rmsnorm"] = check_rmsnorm(dev)
    results["flash_attention"] = check_flash_attention(dev)
    phase_zoo_chunk(dev)
    zoo_launches, by_route = phase_zoo_main(dev)
    for name in ("rmsnorm", "flash_attention"):
        launches[name] = zoo_launches[name]
    meta = {
        "replay_gather": (
            "src/repro_torch/csrc/replay_gather.cu",
            "src/repro/kernels/replay_gather/kernel.py:31",
        ),
        "fused_td": (
            "src/repro_torch/csrc/fused_td.cu",
            "src/repro/kernels/fused_td/kernel.py:38",
        ),
        "rmsnorm": (
            "src/repro_torch/csrc/rmsnorm.cu",
            "src/repro/kernels/rmsnorm/kernel.py:27",
        ),
        "flash_attention": (
            "src/repro_torch/csrc/flash_attention.cu",
            "src/repro/kernels/flash_attention/kernel.py:106",
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
            "bound_by": r.get("bound_by", "bytes"),
            "library_ms": r["library_ms"],
            "device_ms": r["device_ms"],
            "library_device_ms": r["library_device_ms"],
            "floor_ms": r["floor_ms"],
            "shape": r["shape"],
            "check": "pass",
            **({"kernel_route": r["route"]} if "route" in r else {}),
            **{k: r[k] for k in EXTRA_FIELDS if k in r},
        }
        for name, r in results.items()
    ]
    for entry in kernels:
        if entry["name"] in by_route:
            entry["launches_by_route"] = by_route[entry["name"]]
        if entry["name"] in FLEET_KERNELS:
            name = entry["name"]
            entry["launches_by_path"] = {p: n[name] for p, n in by_path.items()}
    emit({"phase": "wall", "seconds": time.perf_counter() - t_start})
    print(smi)
    emit({"kernels": kernels})
    device = {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}
    emit({"ok": True, "device": device})
    return 0


if __name__ == "__main__":
    sys.exit(main())
