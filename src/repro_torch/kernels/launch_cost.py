"""What a kernel call costs on the card, host and device apart.

    PYTHONPATH=src python -m repro_torch.kernels.launch_cost

Three timers, used here and by ``chip_smoke.py``:

* :func:`cuda_ms`: CUDA events around back-to-back calls from Python.  A
  call whose device work is shorter than its host work shows its host
  cost here (the launch path); a long kernel shows its device time.
* :func:`graph_ms`: the calls captured in one CUDA graph and replayed,
  CUDA events around the replays: the device time alone, with no host
  work between the launches.  Capturing also proves that the call is
  capturable (no host sync, no allocation outside the caching allocator).
* :func:`host_us`: the host clock around back-to-back calls, with the
  device drained before and after: what one call costs the host thread.

Run as a script, it times on its own, in host microseconds, each piece
of ``replay_gather``'s launch path at the fleet's shape (pool [16384,
1033] float32, 128 rows): the wrapper's checks and device index, the
output's allocation, the pointers, the raw stream handle, the packing of
the argument struct, the ``ctypes`` call with and without its launch,
and the whole wrapper; ``index_select``, also through ``torch.ops`` (the
path from Python that an op registered with ``TORCH_LIBRARY`` would
take); and one ATen elementwise launch.  The same for ``fused_td`` at the
fleet's shape (q, q_next [4, 32, 6], rows [4, 32, 1033] float32: the
main path's call, which allocates its four outputs, ``td_loss``'s
forward, and the whole tail forward and backward through autograd beside
one multiply's) and for ``rmsnorm`` at the zoo's decode shape ([4, 3840]
bfloat16).  Then the
device time of ``rmsnorm``'s kernels at the decode and prefill ([4000,
3840] bfloat16) shapes under each plan that can take them (128 or 256
threads on the ``cta`` route, the ``masked`` route), forced through the C
entry point, beside two ATen kernels that move the prefill's bytes (a
bf16 multiply by a constant and a copy): what a streaming pass reaches on
this card.  Prints the card as ``nvidia-smi`` names it, then one JSON
object.  Needs a CUDA card.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from repro_torch.configs.adfll_dqn import DQNConfig
from repro_torch.core.erb import flat_columns, flat_width
from repro_torch.kernels import fused_td as td
from repro_torch.kernels import graphs
from repro_torch.kernels import lib
from repro_torch.kernels import replay_gather as rg
from repro_torch.kernels import rmsnorm as rn

GRAPH_LAUNCHES = 100  # launches captured in one graph by graph_ms


def cuda_ms(fn, reps: int = 200, warmup: int = 20) -> float:
    """Mean time of one ``fn()`` over ``reps`` back-to-back calls, CUDA
    events around them (host and device together)."""
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


def graph_ms(fn, launches: int = GRAPH_LAUNCHES, replays: int = 10) -> float:
    """Device time of one ``fn()``: ``launches`` calls captured in one
    CUDA graph (:mod:`repro_torch.kernels.graphs`, after three warm-up
    calls on its capture stream), the graph replayed ``replays`` times
    between CUDA events."""
    dev = torch.device("cuda", torch.cuda.current_device())
    graphs.warm_up(lambda: [fn() for _ in range(3)], dev)
    pool = torch.cuda.graph_pool_handle()
    graph = graphs.capture(lambda: [fn() for _ in range(launches)], dev, pool)
    graphs.replay(graph)  # the first replay uploads the graph
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graphs.replay(graph)
    end.record()
    end.synchronize()
    del graph
    torch.cuda.empty_cache()  # the graph's private pool
    return start.elapsed_time(end) / (replays * launches)


def host_us(fn, reps: int = 2000, warmup: int = 200) -> float:
    """Host microseconds of one ``fn()`` over ``reps`` back-to-back calls
    (the device drained before; the clock read before the final drain)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / reps * 1e6


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        check=True,
        timeout=60,
    ).stdout.strip()


def gather_pieces(dev: torch.device) -> dict:
    """Each piece of replay_gather's launch path, host microseconds."""
    rng = np.random.default_rng(0)
    cap, feat, rows = 16384, 1033, 128
    pool = torch.tensor(rng.standard_normal((cap, feat)), dtype=torch.float32)
    idx = torch.tensor(rng.integers(0, cap, rows), dtype=torch.int32)
    pool, idx = pool.to(dev), idx.to(dev)
    w = torch.ones(rows, dtype=torch.float32, device=dev)
    w_col = w[:, None]
    out = torch.empty((rows, feat), dtype=torch.float32, device=dev)
    lib.load()
    index = dev.index
    stream = lib.raw_stream(index)
    ptrs = (pool.data_ptr(), idx.data_ptr(), w.data_ptr(), out.data_ptr(), stream)
    args = rg.launch_args(*ptrs, index, rows, feat)
    no_launch = rg.launch_args(*ptrs, index, 0, feat)  # back after the guard
    select_op = torch.ops.aten.index_select.default
    pieces = {
        "check": lambda: rg._check(pool, idx, w),
        "device_index": lambda: lib.device_index("replay_gather", pool, idx, w),
        "torch_empty": lambda: torch.empty(
            (rows, feat), dtype=torch.float32, device=dev
        ),
        "new_empty": lambda: pool.new_empty(rows, feat),
        "data_ptr_x4": lambda: (
            pool.data_ptr(),
            idx.data_ptr(),
            w.data_ptr(),
            out.data_ptr(),
        ),
        "raw_stream": lambda: lib.raw_stream(index),
        "pack": lambda: rg.launch_args(*ptrs, index, rows, feat),
        "ctypes_launch": lambda: lib.replay_gather_f32(args),
        "ctypes_no_launch": lambda: lib.replay_gather_f32(no_launch),
        "wrapper": lambda: rg.replay_gather(pool, idx, w),
        "index_select": lambda: torch.index_select(pool, 0, idx),
        # the same ATen op through torch.ops, the path from Python that an
        # op registered with TORCH_LIBRARY takes
        "index_select_op": lambda: select_op(pool, 0, idx),
        "floor_mul": lambda: torch.mul(out, w_col),
    }
    timed = ("wrapper", "index_select", "index_select_op", "floor_mul")
    return {
        "shape": [cap, feat, rows],
        "host_us": {name: host_us(fn) for name, fn in pieces.items()},
        "ms": {name: cuda_ms(pieces[name]) for name in timed},
        "device_ms": {
            "wrapper": graph_ms(pieces["wrapper"]),
            "index_select": graph_ms(pieces["index_select"]),
        },
    }


def fused_td_operands(dev) -> tuple:
    """fused_td's operands at the fleet's shape: q, q_next [4, 32, A],
    rows [4, 32, F] with in-range actions, the (action, reward, done)
    columns and gamma, all from ``DQNConfig()`` and the flat-row layout."""
    cfg = DQNConfig()
    rng = np.random.default_rng(3)
    n, b, a = 4, cfg.batch_size, cfg.n_actions
    columns = flat_columns(cfg.box_size)
    cols = tuple(columns[k].start for k in ("action", "reward", "done"))
    q, q_next = rng.standard_normal((2, n, b, a))
    rows = rng.random((n, b, flat_width(cfg.box_size)))
    rows[..., cols[0]] = rng.integers(0, a, (n, b))
    q, q_next, rows = (
        torch.tensor(x, dtype=torch.float32, device=dev) for x in (q, q_next, rows)
    )
    return q, q_next, rows, cols, cfg.gamma


def fused_td_pieces(dev: torch.device) -> dict:
    """fused_td's wrapper at the fleet's shape, piece by piece, beside one
    ATen launch; and the whole TD tail forward and backward."""
    q, q_next, rows, cols, gamma = fused_td_operands(dev)
    (n, b, a), f = q.shape, rows.shape[2]
    lib.load()
    index = dev.index
    out = td.fused_td(q, q_next, rows, cols, gamma)
    ptrs = (q.data_ptr(), q_next.data_ptr(), rows.data_ptr())
    ptrs += tuple(x.data_ptr() for x in (out.loss_rows, out.dq, out.loss))
    ptrs += (out.grad_q.data_ptr(), 0, 0, lib.raw_stream(index))
    args = td.launch_args(*ptrs, index, n, b, a, f, *cols, gamma)
    leaf = q.clone().requires_grad_(True)
    pieces = {
        "check": lambda: td._check(q, q_next, rows, cols),
        "device_index": lambda: lib.device_index("fused_td", q, q_next, rows),
        "new_empty_x4": lambda: (
            q.new_empty(n),
            q.new_empty(n, b),
            q.new_empty(n, b),
            q.new_empty(n, b, a),
        ),
        "pack": lambda: td.launch_args(*ptrs, index, n, b, a, f, *cols, gamma),
        "ctypes_launch": lambda: lib.fused_td_f32(args),
        "wrapper": lambda: td.fused_td(q, q_next, rows, cols, gamma),
        "apply": lambda: td.td_loss(leaf, q_next, rows, cols, gamma),
        "tail": lambda: torch.autograd.grad(
            td.td_loss(leaf, q_next, rows, cols, gamma).sum(), leaf
        ),
        # one multiply forward and backward: autograd's own round trip
        "autograd_floor": lambda: torch.autograd.grad(
            torch.mul(leaf, gamma).sum(), leaf
        ),
        "floor_mul": lambda: torch.mul(q_next, gamma),
    }
    timed = ("wrapper", "tail", "autograd_floor", "floor_mul")
    return {
        "shape": [n, b, a, f],
        "host_us": {name: host_us(fn) for name, fn in pieces.items()},
        "ms": {name: cuda_ms(pieces[name]) for name in timed},
        "device_ms": {"wrapper": graph_ms(pieces["wrapper"])},
    }


def _bf16(rng, shape, dev) -> torch.Tensor:
    return torch.tensor(rng.standard_normal(shape), dtype=torch.bfloat16, device=dev)


def rmsnorm_pieces(dev: torch.device) -> dict:
    """rmsnorm's wrapper at the zoo's decode shape beside one ATen launch."""
    rng = np.random.default_rng(1)
    n, d, eps = 4, 3840, 1e-5
    x = _bf16(rng, (n, d), dev)
    scale = torch.tensor(rng.standard_normal(d), dtype=torch.float32, device=dev)
    out = torch.empty_like(x)
    lib.load()
    index = dev.index
    ptrs = (x.data_ptr(), scale.data_ptr(), out.data_ptr(), lib.raw_stream(index))
    plan = rn.launch_plan(n, d, 2)
    args = rn.launch_args(*ptrs, index, n, d, plan, eps)
    pieces = {
        "check": lambda: rn._check(x, scale),
        "device_index": lambda: lib.device_index("rmsnorm", x, scale),
        "empty_like": lambda: torch.empty_like(x),
        "launch_plan": lambda: rn.launch_plan(n, d, 2, True),
        "pack": lambda: rn.launch_args(*ptrs, index, n, d, plan, eps),
        "ctypes_launch": lambda: lib.rmsnorm_bf16(args),
        "wrapper": lambda: rn.rmsnorm(x, scale, eps),
        "floor_mul": lambda: torch.mul(x, 2.0),
        "library": lambda: torch.nn.functional.rms_norm(
            x.float(), (d,), scale, eps
        ).to(x.dtype),
    }
    timed = ("wrapper", "floor_mul", "library")
    return {
        "shape": [n, d, "bfloat16"],
        "plan": plan,
        "host_us": {name: host_us(fn) for name, fn in pieces.items()},
        "ms": {name: cuda_ms(pieces[name]) for name in timed},
        "device_ms": {name: graph_ms(pieces[name]) for name in timed},
    }


# plans forced through the C entry point by rmsnorm_plans
FORCED_PLANS = {
    "cta_128": ("cta", 128, 1, True),
    "cta_256": ("cta", 256, 1, True),
    "masked_rows8": ("masked", 32, 8, True),
}


def rmsnorm_plans(dev: torch.device) -> dict:
    """Device ms of rmsnorm at the decode and prefill shapes under each
    plan of :data:`FORCED_PLANS`, each checked against the plain version,
    beside two ATen kernels that move the prefill's bytes."""
    rng = np.random.default_rng(2)
    d, eps = 3840, 1e-5
    scale = torch.tensor(rng.standard_normal(d), dtype=torch.float32, device=dev)
    lib.load()
    index = dev.index
    result = {}
    for shape, n in (("decode", 4), ("prefill", 4000)):
        x = _bf16(rng, (n, d), dev)
        out = torch.empty_like(x)
        want = rn.rmsnorm_plain(x, scale, eps)
        ptrs = (x.data_ptr(), scale.data_ptr(), out.data_ptr())
        device_ms = {}
        for name, plan in FORCED_PLANS.items():

            def call(plan=plan, ptrs=ptrs, n=n):
                stream = lib.raw_stream(index)
                args = rn.launch_args(*ptrs, stream, index, n, d, plan, eps)
                lib.check(lib.rmsnorm_bf16(args), "rmsnorm")

            call()
            torch.testing.assert_close(out, want, atol=2e-2, rtol=2e-2)
            device_ms[name] = graph_ms(call)
        if shape == "prefill":
            device_ms["aten_mul_bf16"] = graph_ms(lambda: torch.mul(x, 2.0))
            device_ms["aten_copy"] = graph_ms(lambda: x.clone())
        result[shape] = {
            "shape": [n, d, "bfloat16"],
            "chosen": rn.launch_plan(n, d, 2),
            "device_ms": device_ms,
        }
    return result


def main() -> int:
    if not torch.cuda.is_available():
        print("launch_cost: needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", torch.cuda.current_device())
    smi = nvidia_smi()
    result = {
        "device": torch.cuda.get_device_name(dev),
        "nvidia_smi": smi,
        "torch": torch.__version__,
        "replay_gather": gather_pieces(dev),
        "fused_td": fused_td_pieces(dev),
        "rmsnorm_decode": rmsnorm_pieces(dev),
        "rmsnorm_plans": rmsnorm_plans(dev),
    }
    print(smi)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
