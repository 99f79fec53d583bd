"""Serving CLI of the port (the reference's ``repro/launch/serve.py``):
the localization inference plane, or prefill + decode of a model-zoo
config.  Both run on the CUDA card unless ``--device cpu`` is given.

Fleet mode — continuous-batching localization serving with
train-while-serve hot swaps (:mod:`repro_torch.serve`):

    PYTHONPATH=src python -m repro_torch.launch.serve --fleet \
        [--agents 2] [--requests 64] [--max-batch 8] [--waves 2] \
        [--rate REQ_PER_S] [--seed 0] [--json OUT] [--device cpu]

Transformer mode — one prefill, then batched greedy decode:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch h2o-danube-3-4b \
        --batch 4 --prompt-len 1000 --gen 32 [--seed 0] [--device cpu]

The weights are random, drawn on the device from ``--seed``; the prompt
is drawn with numpy from the same seed, as the reference draws it: token
ids, or for a config whose input is embeddings (qwen2-vl-2b,
musicgen-medium: the frontend is the reference's stub) standard-normal
``[B, S, d_model]`` float32 embeds, with zero embeds fed at every decode
step.  ``--arch NAME-smoke`` serves the config's reduced CPU variant.
"""

from __future__ import annotations

import argparse
import json
import time
from dataclasses import dataclass, replace

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, get_config
from repro_torch.models.model import Model, graphs_apply, load_prefill


@dataclass
class Generation:
    tokens: torch.Tensor  # [B, gen + 1] greedy ids: the prefill's, then each step's
    logits: torch.Tensor  # [gen, B, V] float32 logits of each decode step
    prefill_s: float  # wall seconds of the prefill, synchronised
    decode_s: float  # wall seconds of the decode loop, synchronised


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def prompt_tokens(
    vocab_size: int, batch: int, prompt_len: int, seed: int
) -> np.ndarray:
    """The reference driver's prompt: numpy ``default_rng(seed)`` ids."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, vocab_size, (batch, prompt_len))


def prompt_embeds(d_model: int, batch: int, prompt_len: int, seed: int) -> np.ndarray:
    """The reference driver's prompt for an embeds config: numpy
    ``default_rng(seed)`` standard normals [B, S, d_model], float32."""
    rng = np.random.default_rng(seed)
    return rng.standard_normal((batch, prompt_len, d_model)).astype(np.float32)


def generate(model: Model, params: dict, prompt: torch.Tensor, gen: int) -> Generation:
    """Prefill ``prompt`` (token ids [B, S], or embeds [B, S, D] for an
    embeds config) once, then ``gen`` greedy decode steps, each feeding
    the previous step's argmax (an embeds config: zero embeds, as the
    reference's driver feeds).  Each step is one ``model.serve_step``
    call.  Where ``models/model.py::graphs_apply`` holds (a card, no
    mesh, no named ranges) the caches are the model's arena's, of a length
    rounded up to a multiple of 64 slots, and each step replays the
    arena's CUDA graph of the shape (its first step captures it);
    elsewhere they are fresh caches of ``S + gen`` slots, run eagerly."""
    dev = model.device
    b, s = prompt.shape[:2]
    embeds = model.cfg.input_kind == "embeds"
    key = "embeds" if embeds else "tokens"
    zeros = torch.zeros((b, 1, model.cfg.d_model), device=dev) if embeds else None
    t0 = time.perf_counter()
    last_logits, pre_caches = model.prefill_step(params, {key: prompt})
    # decode caches sized for the whole conversation; the prefill's k/v in
    if graphs_apply(model):  # the arena's, whose steps replay a graph
        caches = model.arena.load(pre_caches, b, s + gen)
    else:
        caches = load_prefill(model.init_caches(b, s + gen), pre_caches)
    del pre_caches  # copied into the arena's: not held through the decode
    tok = last_logits.argmax(-1).to(torch.int32)[:, None]
    _sync(dev)
    prefill_s = time.perf_counter() - t0

    tokens, logits = [tok], []
    t0 = time.perf_counter()
    for i in range(gen):
        pos = torch.full((b,), s + i, dtype=torch.int32, device=dev)
        step = {key: zeros if embeds else tok, "pos": pos}
        lg, caches = model.serve_step(params, caches, step)
        tok = lg.argmax(-1).to(torch.int32)[:, None]
        tokens.append(tok)
        logits.append(lg.float())
    _sync(dev)
    decode_s = time.perf_counter() - t0
    if logits:
        stacked = torch.stack(logits)
    else:
        stacked = torch.empty(0, b, model.cfg.vocab_size, device=dev)
    return Generation(torch.cat(tokens, 1), stacked, prefill_s, decode_s)


def cut_depth(cfg: ModelConfig, n_layers: int) -> ModelConfig:
    """``cfg`` at ``n_layers`` layers, widths untouched.  Where fewer
    layers are left past the dense prefix than the pattern's period
    (jamba's 8), the pattern is cut to its first entries, so the layers
    kept are the first ones of the full model."""
    body = n_layers - cfg.first_k_dense
    if body < len(cfg.pattern):
        return replace(cfg, n_layers=n_layers, pattern=cfg.pattern[:body])
    return replace(cfg, n_layers=n_layers)


def setup(
    arch: str,
    batch: int,
    prompt_len: int,
    seed: int,
    device=None,
    n_layers: int | None = None,
):
    """(model, params, prompt) as the CLI builds them: random params drawn on
    the device from ``seed``, the prompt from numpy's ``default_rng(seed)``
    (:func:`prompt_tokens`, or :func:`prompt_embeds` for an embeds
    config).  ``n_layers`` cuts the config's depth (a model too deep for
    one card) with :func:`cut_depth`: jamba at 4 layers keeps its
    pattern's first 4 entries, (mamba, moe), (mamba, dense), (mamba,
    moe), (attn, dense)."""
    cfg = get_config(arch)
    if n_layers is not None:
        cfg = cut_depth(cfg, n_layers)
    model = Model(cfg, device)
    params = model.init_params(seed)
    if cfg.input_kind == "embeds":
        emb = prompt_embeds(cfg.d_model, batch, prompt_len, seed)
        prompt = torch.tensor(emb, device=model.device)
    else:
        tok = prompt_tokens(cfg.vocab_size, batch, prompt_len, seed)
        prompt = torch.tensor(tok, dtype=torch.int32, device=model.device)
    return model, params, prompt


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    mode = ap.add_argument_group("mode (exactly one)")
    mode.add_argument(
        "--fleet",
        action="store_true",
        help="serve the localization fleet under synthetic traffic",
    )
    mode.add_argument("--arch", default=None, help="transformer config to decode")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument(
        "--device", default=None, help="torch device (default: the CUDA card)"
    )
    # -- transformer-mode flags --------------------------------------------
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    # -- fleet-mode flags --------------------------------------------------
    ap.add_argument("--agents", type=int, default=2, help="fleet slots served")
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument(
        "--waves",
        type=int,
        default=2,
        help="traffic waves; each later wave follows a train+publish "
        "round, exercising a param hot-swap",
    )
    ap.add_argument(
        "--rate",
        type=float,
        default=None,
        help="open-loop arrival rate (req/s); default: all at once",
    )
    ap.add_argument("--train-steps", type=int, default=20)
    ap.add_argument("--version-slots", type=int, default=2)
    ap.add_argument("--max-staleness", type=int, default=1)
    ap.add_argument("--json", default=None, metavar="OUT")
    args = ap.parse_args(argv)

    if args.fleet == (args.arch is not None):
        ap.error("exactly one of --fleet or --arch is required")
    if args.fleet:
        return fleet_main(args)
    model, params, prompt = setup(
        args.arch, args.batch, args.prompt_len, args.seed, args.device
    )
    b, s = prompt.shape[:2]
    out = generate(model, params, prompt, args.gen)
    print(f"prefill [{b}x{s}] in {out.prefill_s:.2f}s")
    tok_s = args.gen * b / out.decode_s if out.decode_s > 0 else float("inf")
    print(
        f"decoded {args.gen} tokens x {b} reqs in {out.decode_s:.2f}s "
        f"({tok_s:.1f} tok/s)"
    )
    print("sample token ids:", out.tokens[0, :16].cpu().numpy())
    return 0


def fleet_main(args) -> int:
    """Thin driver over :mod:`repro_torch.serve`: build, serve, report.
    Exits 1 if the act program met a new shape after warmup."""
    from repro_torch.configs.adfll_dqn import DQNConfig
    from repro_torch.serve import TrafficSpec, build_session, run_session

    cfg = DQNConfig(
        volume_shape=(16, 16, 16),
        box_size=(6, 6, 6),
        conv_features=(4,),
        hidden=(32,),
        max_episode_steps=16,
        batch_size=16,
        eps_decay_steps=100,
    )
    traffic = TrafficSpec(
        n_requests=args.requests,
        max_batch=args.max_batch,
        n_version_slots=args.version_slots,
        max_staleness=args.max_staleness,
        rate=args.rate,
        seed=args.seed,
    )
    session = build_session(
        cfg, n_agents=args.agents, traffic=traffic, seed=args.seed, device=args.device
    )
    report = run_session(
        session, traffic, n_waves=args.waves, train_steps=args.train_steps
    )
    s = report.summary()
    print(
        f"served {s['n_requests']} requests in {s['wall_time_s']:.2f}s "
        f"({s['requests_per_sec']:.1f} req/s)"
    )
    print(
        f"latency p50={s['p50_latency_ms']:.1f}ms p99={s['p99_latency_ms']:.1f}ms "
        f"ticks/req={s['ticks_per_request']:.1f} "
        f"queue depth mean={s['mean_queue_depth']:.1f}"
    )
    print(
        f"hot swaps={s['n_swaps']} versions_served={s['versions_served']} "
        f"stall_ticks={s['n_stall_ticks']}"
    )
    print(
        f"compiled buckets={session.service.buckets} "
        f"recompiles_after_warmup={s['recompiles']}"
    )
    if s["mean_dist_err"] is not None:
        print(f"mean_dist_err={s['mean_dist_err']:.2f} voxels (synthetic landmarks)")
    if args.json:
        payload = {"benchmark": "serve", "fast": False, "configs": {"fleet": s}}
        with open(args.json, "w") as f:
            json.dump(payload, f, indent=2, sort_keys=True)
        print(f"wrote {args.json}")
    return 0 if s["recompiles"] == 0 else 1


if __name__ == "__main__":
    import sys

    sys.exit(main())
