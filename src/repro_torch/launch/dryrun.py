"""The H100 planner: does each (arch, input shape) fit a mesh of H100s, and
what bounds its step?

The port of the reference's ``repro/launch/dryrun.py``, which lowers and
compiles each pair for a 256-chip TPU v5e pod.  Here nothing is compiled
and no card is needed: the port's own step (``models/model.py``) runs on
``meta`` tensors at the global shapes, on the CPU, under the FLOP
counter and the saved-tensor hooks of ``launch/analysis.py``.  The
figures are estimates from the H100 SXM5's spec-sheet constants
(``launch/mesh.py``), not measurements.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch xlstm-125m \
        --shape train_4k [--multi-pod] [--optimized] [--set microbatches=2]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--out DIR] [--force]

Each result keeps the reference's keys where it computes the same
quantity (``model_flops``, ``useful_flops_ratio``, ``hbm_bytes_per_dev``,
``collective_bytes_per_dev``, ``roofline`` with its bottleneck,
``params_total``, ``params_active``); ``flops_global`` is the reference's
``flops_global_jaxpr`` (no jaxpr is walked).  What only XLA's compiler
knew (``cost_analysis``, ``lower_s``, ``compile_s``) has no key.  In
place of ``memory_analysis``, ``memory_estimate`` sizes one card: params,
optimizer, gradients, caches and io from the specs, plus the activations
autograd saves in the meta run, divided as the reference divides its
``act_dev``, and under ``remat`` what the backward's recompute holds at
its peak (:func:`recompute_bytes`); ``fits`` compares the sum with the
card's memory.  ``--set remat=false`` plans the step without per-layer
rematerialisation.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
import traceback
from dataclasses import replace

from repro_torch.configs.base import (
    ASSIGNED,
    FFN_NONE,
    INPUT_SHAPES,
    InputShape,
    ModelConfig,
    get_config,
    param_count,
    refuse_unplanned,
)
from repro_torch.launch import analysis
from repro_torch.launch.mesh import (
    HBM_BW,
    NETWORK_BW,
    NVLINK_BW,
    PEAK_FLOPS_BF16,
    device_memory_bytes,
    make_production_mesh,
)
from repro_torch.launch.specs import (
    batch_pspec,
    bytes_per_device,
    cache_specs,
    input_specs,
    opt_cfg_for,
    params_specs,
    state_specs,
    tensors,
)
from repro_torch.models import model as model_lib
from repro_torch.models.sharding import ShardingPolicy, axis_size
from repro_torch.optim.adamw import tree_leaves

# Per-(arch, mode) gradient-accumulation settings of the reference's
# baseline memory pass. Everything else runs k=1.
MICROBATCHES = {
    ("jamba-1.5-large-398b", "train"): 8,
    ("qwen3-moe-235b-a22b", "train"): 4,
    ("qwen2.5-14b", "train"): 2,
    ("starcoder2-15b", "train"): 2,
    ("moonshot-v1-16b-a3b", "train"): 2,
    ("deepseek-v2-lite-16b", "train"): 2,
}

# The reference's beyond-paper launch settings: dense/audio/VLM <=4B ->
# pure DP + ZeRO-3; mid dense -> TP+SP with grad accumulation; MoE -> EP
# (baseline); 398B hybrid -> multi-pod + k=4 + no-SP.
OPTIMIZED = {
    ("h2o-danube-3-4b", "train"): {"dp_over_model": True},
    ("musicgen-medium", "train"): {"dp_over_model": True},
    ("qwen2-vl-2b", "train"): {"dp_over_model": True},
    ("xlstm-125m", "train"): {"dp_over_model": True},
    ("jamba-1.5-large-398b", "train"): {"microbatches": 4, "seq_shard": False},
}

SKIPS = {
    # long_500k needs a sub-quadratic path
    ("musicgen-medium", "long_500k"): "full attention, no subquadratic path",
    ("qwen2.5-14b", "long_500k"): "full attention, no subquadratic path",
    ("moonshot-v1-16b-a3b", "long_500k"): "full attention, no subquadratic path",
    ("deepseek-v2-lite-16b", "long_500k"): "full attention, no subquadratic path",
    ("qwen3-moe-235b-a22b", "long_500k"): "full attention, no subquadratic path",
    ("starcoder2-15b", "long_500k"): "full attention, no subquadratic path",
    ("qwen2-vl-2b", "long_500k"): "full attention, no subquadratic path",
}

BASIS = "plan from H100 SXM5 spec-sheet constants, not a measurement"


# ---------------------------------------------------------------------------
# the meta walk of the port's step
# ---------------------------------------------------------------------------
def _walk(cfg: ModelConfig, shape: InputShape, policy: ShardingPolicy, opt_cfg):
    """One run of the port's step for ``shape`` on ``meta`` tensors:
    (FLOPs by kind, bytes of the activations autograd saves).  The state,
    caches and batch are built first, outside the counters, and their
    storages are never counted as activations."""
    batch = tensors(input_specs(cfg, shape, None, policy))
    if shape.mode == "train":
        state = tensors(state_specs(cfg, None, policy, opt_cfg))
        step = model_lib.make_train_step(
            cfg,
            opt_cfg,
            loss_chunk=policy.loss_chunk,
            microbatches=policy.microbatches,
            policy=policy,  # no mesh: the step reads its remat
        )
        args = (state, batch)
    elif shape.mode == "prefill":
        args = (tensors(params_specs(cfg, None, policy)), batch)
        step = model_lib.make_prefill_step(cfg)
    else:
        params = tensors(params_specs(cfg, None, policy))
        b, s = shape.global_batch, shape.seq_len
        caches = tensors(cache_specs(cfg, b, s, None, policy))
        args = (params, caches, batch)
        step = model_lib.make_serve_step(cfg)
    saved = analysis.SavedBytes()
    saved.exclude(t for a in args for t in tree_leaves(a))
    with analysis.FlopCounter() as fc, saved:
        step(*args)
    return dict(fc.by_kind), saved.bytes


def plan_step(
    cfg: ModelConfig,
    shape: InputShape,
    policy: ShardingPolicy,
    opt_cfg,
    *,
    group_shortcut: bool = True,
):
    """(FLOPs by kind, saved activation bytes) of the port's step, global;
    raises for a config the planner does not support (the KDA mixer, a
    held share of the experts).

    With ``group_shortcut`` and more than one group of layers, the step is
    walked at no group and at one (the dense prefix, embeddings, loss and
    update are in both) and the difference multiplied by the groups, as
    the reference's scan multiplies its body by its length: walking every
    token of a recurrence in every layer (xlstm at 32k tokens) is slow.
    Every group runs the same operations at the same shapes, so this
    equals the full walk but for a few scalar operations a parameter leaf
    (the gradient norm's partial sums), counted once a group instead of
    once (``tests/test_torch_planner.py`` holds the two together).

    The step is walked at ``policy.remat``.  Rematerialised, a group
    saves its input for the backward (the checkpoint saves its inputs
    through the ambient hooks, so :class:`~analysis.SavedBytes` counts
    them; a block's checkpoint nested in it, and whatever the blocks
    save, go to the group's own hooks and are recomputed), and the
    shortcut stays exact: no group saves the embeddings' output once (the
    final norm's input), one group once more."""
    refuse_unplanned(cfg, "the planner")
    g = cfg.n_groups
    if not group_shortcut or g <= 1:
        return _walk(cfg, shape, policy, opt_cfg)
    k0, s0 = _walk(replace(cfg, n_layers=cfg.first_k_dense), shape, policy, opt_cfg)
    one = replace(cfg, n_layers=cfg.first_k_dense + len(cfg.pattern))
    k1, s1 = _walk(one, shape, policy, opt_cfg)
    kinds = {
        k: k0.get(k, 0.0) + g * (k1.get(k, 0.0) - k0.get(k, 0.0))
        for k in sorted(set(k0) | set(k1))
    }
    return kinds, s0 + g * (s1 - s0)


def recompute_bytes(
    cfg: ModelConfig, shape: InputShape, policy: ShardingPolicy, opt_cfg
) -> float:
    """Global bytes the backward's recompute holds beyond the saved
    activations at its peak, under ``policy.remat`` in training (0
    otherwise): while a group's backward runs, its recompute has saved
    the inputs of its blocks after the first (``len(pattern) - 1``
    residual-stream tensors ``[B, S, D]``), and the block whose backward
    runs holds its own saved activations.  Those are the largest of the
    pattern's block kinds', each walked alone without remat (a config of
    that one block, less the same walk without it)."""
    if shape.mode != "train" or not policy.remat or not cfg.n_groups:
        return 0.0
    plain = replace(policy, remat=False)
    bare = replace(cfg, n_layers=cfg.first_k_dense)
    _, s0 = _walk(bare, shape, plain, opt_cfg)
    blocks = []
    for kind in dict.fromkeys(cfg.pattern):
        one = replace(bare, pattern=(kind,), n_layers=cfg.first_k_dense + 1)
        blocks.append(_walk(one, shape, plain, opt_cfg)[1] - s0)
    itemsize = 2 if cfg.dtype == "bfloat16" else 4
    stream = shape.global_batch * shape.seq_len * cfg.d_model * itemsize
    return (len(cfg.pattern) - 1) * stream + max(blocks)


# ---------------------------------------------------------------------------
# one pair
# ---------------------------------------------------------------------------
def _policy(
    arch: str, mode: str, multi_pod: bool, overrides: dict | None
) -> ShardingPolicy:
    batch_axes = ("pod", "data") if multi_pod else ("data",)
    kw = dict(
        batch_axes=batch_axes,
        fsdp_axes=("data",),
        microbatches=MICROBATCHES.get((arch, mode), 1),
    )
    overrides = dict(overrides or {})
    if overrides.pop("dp_over_model", False):
        # pure data parallelism: the model axis carries batch, weights are
        # FSDP-sharded over data and replicated over model
        kw.update(
            batch_axes=batch_axes + ("model",),
            tensor_parallel=False,
            seq_shard=False,
        )
    if overrides.pop("no_fsdp", False):
        kw.update(fsdp_axes=())
    kw.update(overrides)
    return ShardingPolicy(**kw)


def _param_leaves(tree) -> list:
    """``(global bytes, spec)`` of every leaf of a Sharded params tree."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _param_leaves(tree[k])]
    t = tree.tensor
    return [(t.numel() * t.element_size(), tree.spec)]


def run_pair(
    arch: str | ModelConfig,
    shape: str | InputShape,
    *,
    multi_pod: bool = False,
    policy_overrides: dict | None = None,
    print_analyses: bool = True,
    optimized: bool = False,
    mesh: dict[str, int] | None = None,
) -> dict:
    """Plan one (arch, input shape) pair on ``mesh`` (default: the
    production mesh; ``launch/mesh.py::make_local_mesh`` plans one card).
    ``arch`` is a registered name or a config (a depth cut); ``shape`` a
    name of ``INPUT_SHAPES`` or an :class:`InputShape`."""
    cfg = get_config(arch) if isinstance(arch, str) else arch
    refuse_unplanned(cfg, "the planner")
    shape = INPUT_SHAPES[shape] if isinstance(shape, str) else shape
    name = cfg.name
    if optimized:
        base = OPTIMIZED.get((name, shape.mode), {})
        policy_overrides = dict(base, **(policy_overrides or {}))
    if (name, shape.name) in SKIPS:
        return {
            "arch": name,
            "shape": shape.name,
            "multi_pod": multi_pod,
            "status": "skipped",
            "reason": SKIPS[(name, shape.name)],
        }
    if mesh is None:
        mesh = make_production_mesh(multi_pod=multi_pod)
    policy = _policy(name, shape.mode, multi_pod, policy_overrides)
    opt_cfg = opt_cfg_for(cfg)
    t0 = time.time()

    if shape.mode == "train":
        state = state_specs(cfg, mesh, policy, opt_cfg)
        params, opt = state["params"], state["opt"]
        cache_dev = 0.0
    else:
        params, opt = params_specs(cfg, mesh, policy), None
        caches = cache_specs(cfg, shape.global_batch, shape.seq_len, mesh, policy)
        cache_dev = bytes_per_device(caches, mesh)
    io_dev = bytes_per_device(input_specs(cfg, shape, mesh, policy), mesh)
    param_dev = bytes_per_device(params, mesh)
    opt_dev = bytes_per_device(opt, mesh) if opt is not None else 0.0

    kinds, saved = plan_step(cfg, shape, policy, opt_cfg)
    recompute = recompute_bytes(cfg, shape, policy, opt_cfg)
    flops_global = float(sum(kinds.values()))
    plan_s = time.time() - t0

    chips = math.prod(mesh.values())
    total_p, active_p = param_count(cfg)
    if shape.mode == "train":
        model_flops = 6.0 * active_p * shape.global_batch * shape.seq_len
    elif shape.mode == "prefill":
        model_flops = 2.0 * active_p * shape.global_batch * shape.seq_len
    else:
        model_flops = 2.0 * active_p * shape.global_batch  # one token

    # the reference's analytic HBM traffic (per device)
    dtype_b = 2 if cfg.dtype == "bfloat16" else 4
    mp = mesh[policy.model_axis]
    dp = chips // mp
    seq_div = mp if (policy.seq_shard and shape.seq_len % mp == 0) else 1
    act_div = max(dp, 1) * seq_div * policy.microbatches
    if shape.mode != "decode":
        act_dev = (
            cfg.n_layers * shape.global_batch * shape.seq_len * cfg.d_model * dtype_b
        ) / act_div
    else:
        act_dev = 0.0
    hbm = analysis.analytic_hbm_bytes(
        mode=shape.mode,
        param_bytes_dev=param_dev,
        opt_bytes_dev=opt_dev,
        act_bytes_dev=act_dev,
        cache_bytes_dev=cache_dev if shape.mode == "decode" else 0.0,
        io_bytes_dev=io_dev,
    )

    # per-device collectives from the specs
    bspec = batch_pspec(mesh, policy, shape.global_batch)
    b_dev = shape.global_batch / axis_size(mesh, bspec)
    s_eff = shape.seq_len if shape.mode != "decode" else 1
    boundaries = sum(1 + (ffn != FFN_NONE) for _, ffn in cfg.layer_pattern)
    coll = analysis.collective_bytes(
        mode=shape.mode,
        leaves=_param_leaves(params),
        mesh_shape=mesh,
        policy=policy,
        act_bytes_per_boundary=b_dev * s_eff * cfg.d_model * dtype_b,
        n_boundaries=boundaries,
    )

    compute_t = flops_global / (chips * PEAK_FLOPS_BF16)
    memory_t = hbm["total"] / HBM_BW  # per-device traffic
    links = coll["by_link"]
    collective_t = links.get("nvlink", 0.0) / NVLINK_BW + links.get(
        "network", 0.0
    ) / NETWORK_BW
    terms = {
        "compute_s": compute_t,
        "memory_s": memory_t,
        "collective_s": collective_t,
    }
    bottleneck = max(terms, key=terms.get)

    grads_dev = param_dev * (2 if policy.microbatches > 1 else 1)
    memory = {
        "params_bytes": param_dev,
        "opt_bytes": opt_dev,
        "grad_bytes": grads_dev if shape.mode == "train" else 0.0,
        "cache_bytes": cache_dev,
        "io_bytes": io_dev,
        "act_bytes": saved / act_div,
        "act_bytes_global": float(saved),
        "recompute_bytes": recompute / act_div,
    }
    memory["resident_bytes"] = param_dev + opt_dev + cache_dev
    parts = ("params", "opt", "grad", "cache", "io", "act", "recompute")
    memory["total_bytes"] = sum(memory[f"{k}_bytes"] for k in parts)
    memory["device_bytes"] = device_memory_bytes()
    memory["fits"] = memory["total_bytes"] <= memory["device_bytes"]
    if print_analyses:
        gb = {k: round(v / 1e9, 3) for k, v in memory.items() if k.endswith("bytes")}
        print(f"memory_estimate (GB a card, {BASIS}): {gb} fits={memory['fits']}")
        print(f"flops_global={flops_global:.4e} by kind {kinds}")

    return {
        "arch": name,
        "shape": shape.name,
        "multi_pod": multi_pod,
        "status": "ok",
        "basis": BASIS,
        "mesh": dict(mesh),
        "microbatches": policy.microbatches,
        "plan_s": round(plan_s, 2),
        "memory_estimate": memory,
        "flops_global": flops_global,
        "flops_by_kind": kinds,
        "collective_bytes_per_dev": coll,
        "hbm_bytes_per_dev": hbm["total"],
        "model_flops": model_flops,
        "useful_flops_ratio": model_flops / flops_global if flops_global else None,
        "roofline": dict(terms, bottleneck=bottleneck),
        "params_total": total_p,
        "params_active": active_p,
    }


def _result_path(out: str, arch: str, shape: str, multi_pod: bool) -> str:
    tag = "multi" if multi_pod else "single"
    return os.path.join(out, f"{arch}__{shape}__{tag}.json")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(INPUT_SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true", help="plan every (arch x shape)")
    ap.add_argument("--out", default="experiments/dryrun_h100")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--set", default=None, help="policy overrides k=v,k=v (ints/bools)")
    ap.add_argument(
        "--optimized",
        action="store_true",
        help="apply the reference's OPTIMIZED launch settings",
    )
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)

    overrides = {}
    if args.set:
        for kv in args.set.split(","):
            k, v = kv.split("=")
            flag = v.lower() in ("true", "false")
            overrides[k] = (v.lower() == "true") if flag else int(v)

    if args.all:
        jobs = [(a, s) for a in ASSIGNED for s in INPUT_SHAPES]
    elif args.arch and args.shape:
        jobs = [(args.arch, args.shape)]
    else:
        ap.error("give --arch and --shape, or --all")
    failed = 0
    for a, s in jobs:
        path = _result_path(args.out, a, s, args.multi_pod)
        if args.all and os.path.exists(path) and not args.force:
            print(f"[skip cached] {a} {s}")
            continue
        print(f"[plan] {a} {s}", flush=True)
        try:
            res = run_pair(
                a,
                s,
                multi_pod=args.multi_pod,
                policy_overrides=overrides or None,
                optimized=args.optimized,
                print_analyses=not args.all,
            )
        except Exception:  # one pair's failure is recorded, the rest still run
            failed += 1
            err = traceback.format_exc()
            print(f"[FAIL] {a} {s}: {err.splitlines()[-1]}")
            res = {
                "arch": a,
                "shape": s,
                "multi_pod": args.multi_pod,
                "status": "error",
                "error": err[-2000:],
            }
        with open(path, "w") as f:
            json.dump(res, f, indent=1)
        if res["status"] == "ok":
            r = res["roofline"]
            mem = res["memory_estimate"]
            print(
                f"  {res['flops_global']:.3e} FLOP, {r['bottleneck']} "
                f"(compute {r['compute_s']:.4g} s, memory {r['memory_s']:.4g} s, "
                f"collective {r['collective_s']:.4g} s), "
                f"{mem['total_bytes'] / 1e9:.2f} GB a card, fits={mem['fits']}, "
                f"planned in {res['plan_s']} s"
            )
        else:
            print(f"  {res['status']}: {res.get('reason', '')}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
