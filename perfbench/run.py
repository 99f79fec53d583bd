"""Run one cell of ``BENCHMARK.json`` once on the CUDA card.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints the result as the last line of standard output, one JSON object
(``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` also ``breakdown``, and last ``checks``: each number the
check compared, beside its limit), and the same checks as the last lines
of standard error.  With ``--trace 0`` the metrics are the cell's
end-to-end ones, with ``--trace 1`` its per-layer ones.

Calibration (not part of a benchmark run): ``--readings SEEDS`` (comma
separated) prints, seed by seed, the numbers the check compares, for the
program, with ``--fault NAME`` for the program with that fault planted,
and with ``--control`` also for the control (the reference in the
precision below the configuration's).  Exits non-zero, printing no
result, without as many CUDA cards as the cell asks for.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()  # set-up is timed from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "perfbench" / ".cache"
# every build and kernel cache of the program at a fixed path inside the
# checkout, so that only a checkout's first run builds
os.environ["REPRO_TORCH_BUILD_DIR"] = str(CACHE / "kernels")
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="perfbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--readings", default=None, help="calibration: comma-separated seeds")
    ap.add_argument("--fault", default=None, help="calibration: plant this fault")
    ap.add_argument("--control", action="store_true", help="calibration: the control too")
    return ap


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    import torch

    from perfbench.harness import bench, runner

    chips = bench.load_cell(args.workload).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"perfbench: {args.workload} needs {chips} CUDA card(s); {have} visible",
              file=sys.stderr)  # fmt: skip
        return 3
    if args.readings is not None:
        seeds = [int(s) for s in args.readings.split(",") if s]
        runner.calibrate(
            args.workload, seeds, args.seconds, fault=args.fault, control=args.control
        )
        return 0
    result = runner.run_cell(
        args.workload, args.seed, args.seconds, bool(args.trace), t_start=T_START
    )
    bad = runner.forbidden_modules()
    if bad:
        print(f"perfbench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
