"""Where the model zoo's serving path spends its time on the card.

    PYTHONPATH=src python -m repro_torch.launch.profile_serve [--arch NAME] [--batch B]

Profiles the run ``chip_smoke.py``'s ``zoo_main`` drives: ``--arch``
(h2o-danube-3-4b by default; any registered config) at full width in
bfloat16, random weights from seed 0, batch 4 (``--batch``), prompt 1000,
32 greedy steps (``repro_torch.launch.serve.generate``), with zoo_main's cuts:
deepseek-v2-lite-16b at prompt 480, qwen3-moe-235b-a22b at 8 of its 94
layers, jamba-1.5-large-398b at 4 of its 72.  One
warm-up generation, one plain generation for the wall times, then the
prefill and the decode loop each under ``torch.profiler`` (CPU + CUDA
activities).  Prints one JSON object with, for the prefill and the
decode separately: the unprofiled wall seconds, the device's busy
seconds (CUDA kernel and memcpy time the profiler saw), the idle share
``1 - busy / profiled wall``, the device operations launched and the ten
kernels with the most device time.  The zoo's named ranges
(``models/layers.py::named_ranges``: ``kda.prefill``, ``kda.chunk`` (kernel
F inside it), ``kda.step``, ``moe.held``, ``mhc.pre`` and ``mhc.post``
(kernel G's two launches a site)) are on for the run, so Kimi-Linear's
trace names its mixer's and its held experts' time, and Xing4.0's its
mHC sites' apart from its held experts', under ``ranges`` (each range's
span on the device, gaps included; not counted as operations).
Kimi-Linear and Xing4.0 serve at prompt 1024 (their MLA prefill, like
deepseek's, goes through ``chunked_attention``).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch
from torch.profiler import profile

from repro_torch.experiments.profile import ACTIVITIES, device_summary
from repro_torch.launch import serve
from repro_torch.models.layers import named_ranges

ARCH, BATCH, PROMPT, GEN = "h2o-danube-3-4b", 4, 1000, 32
# zoo_main's cuts.  deepseek's MLA prefill attends through
# chunked_attention, whose S must be <= 512 or a multiple of 1024 (480 +
# 32 = 512 tokens in all); qwen3-moe's 94 layers hold about 470 GB of
# bf16 weights, 8 of them about 42 GB; jamba-1.5-large's 72 about 797 GB,
# its first 4 (the first half of one 8-layer Jamba block: every block
# kind) about 46 GB (widths untouched)
PROMPTS = {
    "deepseek-v2-lite-16b": 480,
    "kimi-linear-48b-a3b-ep4": 1024,
    "xing4.0-29b-a4b-ep4": 1024,
}
LAYERS = {"qwen3-moe-235b-a22b": 8, "jamba-1.5-large-398b": 4}


def profile_serve(arch: str = ARCH, batch: int = BATCH) -> dict:
    with named_ranges():  # the zoo's named ranges on the timeline
        return _profile_serve(arch, batch)


def _profile_serve(arch: str, batch: int) -> dict:
    prompt_len = PROMPTS.get(arch, PROMPT)
    model, params, prompt = serve.setup(
        arch, batch, prompt_len, 0, n_layers=LAYERS.get(arch)
    )
    serve.generate(model, params, prompt, GEN)  # warm-up: cuBLAS, lazy loading
    plain = serve.generate(model, params, prompt, GEN)
    key = "embeds" if model.cfg.input_kind == "embeds" else "tokens"
    zeros = torch.zeros((batch, 1, model.cfg.d_model), device="cuda")

    with profile(activities=ACTIVITIES) as prof_prefill:
        t0 = time.perf_counter()
        _, pre = model.prefill_step(params, {key: prompt})
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
    caches = serve.load_prefill(model.init_caches(batch, prompt_len + GEN), pre)
    tok = plain.tokens[:, :1]
    with profile(activities=ACTIVITIES) as prof_decode:
        t0 = time.perf_counter()
        for i in range(GEN):
            pos = torch.full((batch,), prompt_len + i, dtype=torch.int32, device="cuda")
            step = {key: zeros if key == "embeds" else tok, "pos": pos}
            lg, caches = model.serve_step(params, caches, step)
            tok = lg.argmax(-1).to(torch.int32)[:, None]
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
    decode = device_summary(prof_decode, decode_s)
    return {
        "arch": arch,
        "n_layers": model.cfg.n_layers,
        "batch": batch,
        "prompt": prompt_len,
        "gen": GEN,
        "prefill": {
            "wall_s": plain.prefill_s,
            **device_summary(prof_prefill, prefill_s),
        },
        "decode": {
            "wall_s": plain.decode_s,
            "tok_per_s": GEN * batch / plain.decode_s,
            "device_ops_per_step": decode["device_ops"] / GEN,
            **decode,
        },
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.profile_serve")
    ap.add_argument("--arch", default=ARCH, help="zoo config to serve")
    ap.add_argument("--batch", type=int, default=BATCH, help="sequences served at once")
    args = ap.parse_args(argv)
    result = profile_serve(args.arch, args.batch)
    result["device"] = torch.cuda.get_device_name(0)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
