"""Where the model zoo's serving path spends its time on the card.

    PYTHONPATH=src python -m repro_torch.launch.profile_serve [--arch NAME]

Profiles the run ``chip_smoke.py``'s ``zoo_main`` drives: ``--arch``
(h2o-danube-3-4b by default; qwen2.5-14b, starcoder2-15b) at full width
in bfloat16, random weights from seed 0, batch 4, prompt
1000, 32 greedy steps (``repro_torch.launch.serve.generate``).  One
warm-up generation, one plain generation for the wall times, then the
prefill and the decode loop each under ``torch.profiler`` (CPU + CUDA
activities).  Prints one JSON object with, for the prefill and the
decode separately: the unprofiled wall seconds, the device's busy
seconds (CUDA kernel and memcpy time the profiler saw), the idle share
``1 - busy / profiled wall``, the device operations launched and the ten
kernels with the most device time.
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

ARCH, BATCH, PROMPT, GEN = "h2o-danube-3-4b", 4, 1000, 32


def profile_serve(arch: str = ARCH) -> dict:
    model, params, prompt = serve.setup(arch, BATCH, PROMPT, 0)
    serve.generate(model, params, prompt, GEN)  # warm-up: cuBLAS, lazy loading
    plain = serve.generate(model, params, prompt, GEN)

    with profile(activities=ACTIVITIES) as prof_prefill:
        t0 = time.perf_counter()
        _, pre = model.prefill_step(params, {"tokens": prompt})
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
    caches = serve.load_prefill(model.init_caches(BATCH, PROMPT + GEN), pre)
    tok = plain.tokens[:, :1]
    with profile(activities=ACTIVITIES) as prof_decode:
        t0 = time.perf_counter()
        for i in range(GEN):
            pos = torch.full((BATCH,), PROMPT + i, dtype=torch.int32, device="cuda")
            lg, caches = model.serve_step(params, caches, {"tokens": tok, "pos": pos})
            tok = lg.argmax(-1).to(torch.int32)[:, None]
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
    decode = device_summary(prof_decode, decode_s)
    return {
        "arch": arch,
        "batch": BATCH,
        "prompt": PROMPT,
        "gen": GEN,
        "prefill": {
            "wall_s": plain.prefill_s,
            **device_summary(prof_prefill, prefill_s),
        },
        "decode": {
            "wall_s": plain.decode_s,
            "tok_per_s": GEN * BATCH / plain.decode_s,
            "device_ops_per_step": decode["device_ops"] / GEN,
            **decode,
        },
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.profile_serve")
    ap.add_argument("--arch", default=ARCH, help="zoo config to serve")
    result = profile_serve(ap.parse_args(argv).arch)
    result["device"] = torch.cuda.get_device_name(0)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
