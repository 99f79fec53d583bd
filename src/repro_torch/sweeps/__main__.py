"""CLI for multi-seed sweep grids.

    PYTHONPATH=src python -m repro_torch.sweeps --list
    PYTHONPATH=src python -m repro_torch.sweeps --sweep paper_table1_sweep \
        --fast --json out.json [--device cpu]
    PYTHONPATH=src python -m repro_torch.sweeps --compare old.json new.json

``--sweep`` expands the grid, resumes from the on-disk report store
(``--store``, default ``.sweeps/torch_<name>[.fast].jsonl``), runs the
missing cells on the CUDA card (``--device cpu`` runs them here) under
per-cell wall-time budgets, and prints per-variant mean ± 95% CI plus
paired p-values against the sweep's baseline variant.  A stored row is
reused only on the device type it was run on.  Exit is nonzero when
any cell failed (error or budget).

``--compare`` diffs two summary JSONs seed-paired per variant/metric and
exits nonzero on a significant regression of a gated metric.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from repro_torch.experiments.suggest import unknown_name_message
from repro_torch.sweeps.aggregate import GATE_METRICS, compare
from repro_torch.sweeps.executor import failed_cells, run_sweep
from repro_torch.sweeps.registry import get_sweep, list_sweeps
from repro_torch.sweeps.store import ReportStore


def _fmt(x, width=10, prec=3):
    if x is None:
        return " " * (width - 1) + "-"
    if isinstance(x, float):
        return f"{x:{width}.{prec}f}"
    return f"{x:>{width}}"


def _fmt_ci(ci) -> str:
    """``[lo, hi]`` bootstrap interval -> ``[lo, hi]`` cell (or ``-``)."""
    if not ci or ci[0] is None or ci[1] is None:
        return "-"
    return f"[{ci[0]:.3f}, {ci[1]:.3f}]"


def _print_summary(summary: dict) -> None:
    print(
        f"\nsweep {summary['sweep']} (seeds={summary['seeds']}, "
        f"device={summary['device']})"
    )
    metrics = None
    for label, v in summary["variants"].items():
        if metrics is None:
            metrics = list(v["metrics"])
            print(f"{'variant':<22} {'n':>3} " + " ".join(f"{m:>24}" for m in metrics))
        cols = []
        for m in metrics:
            st = v["metrics"][m]
            mean, ci = st["mean"], st["ci95"]
            if mean is None:
                cell = "-"
            elif ci is None:
                cell = f"{mean:.3f}"
            else:
                cell = f"{mean:.3f} ± {ci:.3f}"
            cols.append(f"{cell:>24}")
        print(f"{label:<22} {v['n_ok']:>3} " + " ".join(cols))
    if summary["comparisons"]:
        print(f"\npaired vs {summary['baseline']!r}:")
        print(
            f"{'variant':<22} {'metric':<14} {'delta':>10} {'d95%':>21} "
            f"{'d':>7} {'t':>8} {'p(t)':>8} {'p(adj)':>8} {'p(perm)':>8}"
        )
        for c in summary["comparisons"]:
            print(
                f"{c['variant']:<22} {c['metric']:<14} {_fmt(c['delta'])} "
                f"{_fmt_ci(c.get('delta_ci95')):>21} "
                f"{_fmt(c.get('cohens_d'), 7, 2)} {_fmt(c['t'], 8)} "
                f"{_fmt(c['p_ttest'], 8, 4)} {_fmt(c.get('p_ttest_adj'), 8, 4)} "
                f"{_fmt(c['p_permutation'], 8, 4)}"
            )


def _cmd_compare(args) -> int:
    with open(args.compare[0]) as f:
        a = json.load(f)
    with open(args.compare[1]) as f:
        b = json.load(f)
    rows, regressions = compare(a, b, alpha=args.alpha, gate_metrics=args.gate)
    if not rows:
        print(
            "no overlapping (variant, metric, seed) cells to compare", file=sys.stderr
        )
        return 2
    print(
        f"{'variant':<22} {'metric':<14} {'A':>10} {'B':>10} {'delta':>10} "
        f"{'d95%':>21} {'d':>7} {'p(t)':>8} {'p(adj)':>8} {'p(perm)':>8}  flag"
    )
    for r in rows:
        flag = "REGRESSION" if r["regression"] else ("*" if r["significant"] else "")
        print(
            f"{r['variant']:<22} {r['metric']:<14} {_fmt(r['mean_a'])} "
            f"{_fmt(r['mean_b'])} {_fmt(r['delta'])} "
            f"{_fmt_ci(r.get('delta_ci95')):>21} "
            f"{_fmt(r.get('cohens_d'), 7, 2)} {_fmt(r['p_ttest'], 8, 4)} "
            f"{_fmt(r.get('p_ttest_adj'), 8, 4)} "
            f"{_fmt(r['p_permutation'], 8, 4)}  {flag}"
        )
    for r in regressions:
        print(
            f"REGRESSION {r['variant']}.{r['metric']}: "
            f"{r['mean_a']:.3f} -> {r['mean_b']:.3f} "
            f"(Holm-adjusted p={r['p_ttest_adj']:.4f})",
            file=sys.stderr,
        )
    return 1 if regressions else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.sweeps")
    ap.add_argument("--list", action="store_true", help="list registered sweeps")
    ap.add_argument("--sweep", metavar="NAME", help="sweep to run")
    ap.add_argument(
        "--fast", action="store_true", help="reduced per-cell step counts (CI)"
    )
    ap.add_argument(
        "--seeds", type=int, default=None, metavar="N", help="truncate the seed list"
    )
    ap.add_argument(
        "--workers",
        type=int,
        default=None,
        help="parallel worker processes (default: min(4, cpus, cells); "
        "1 runs inline)",
    )
    ap.add_argument(
        "--store",
        default=None,
        metavar="PATH",
        help="report-store JSONL for resume (default "
        ".sweeps/torch_<name>[.fast].jsonl; 'none' disables)",
    )
    ap.add_argument(
        "--budget",
        type=float,
        default=None,
        metavar="SECONDS",
        help="override the sweep's per-cell wall-time budget",
    )
    ap.add_argument("--json", default=None, metavar="OUT", help="write the summary")
    ap.add_argument(
        "--device",
        default=None,
        help="torch device of every cell (default: cuda; 'cpu' runs on the CPU)",
    )
    ap.add_argument(
        "--compare",
        nargs=2,
        metavar=("A.json", "B.json"),
        help="diff two sweep summaries; exit 1 on significant regression",
    )
    ap.add_argument("--alpha", type=float, default=0.05, help="significance level")
    ap.add_argument(
        "--gate",
        nargs="+",
        default=list(GATE_METRICS),
        help="metrics whose significant increase counts as a regression",
    )
    args = ap.parse_args(argv)

    if args.compare:
        return _cmd_compare(args)

    if args.list or not args.sweep:
        print(f"{'sweep':<26} {'cells':>6}  description")
        for sw in list_sweeps():
            n = len(sw.variants) * len(sw.seeds)
            print(f"{sw.name:<26} {n:>6}  {sw.description}")
        return 0

    try:
        sweep = get_sweep(args.sweep)
    except KeyError:
        known = [s.name for s in list_sweeps()]
        print(unknown_name_message("sweep", args.sweep, known), file=sys.stderr)
        return 2
    if args.seeds is not None:
        if args.seeds < 1:
            print("--seeds must be >= 1", file=sys.stderr)
            return 2
        sweep = sweep.with_seeds(sweep.seeds[: args.seeds])
    if args.budget is not None and args.budget <= 0:
        print("--budget must be > 0 seconds", file=sys.stderr)
        return 2

    store = None
    if args.store != "none":
        path = args.store or os.path.join(
            ".sweeps", f"torch_{sweep.name}{'.fast' if args.fast else ''}.jsonl"
        )
        store = ReportStore(path)

    summary = run_sweep(
        sweep,
        fast=args.fast,
        workers=args.workers,
        store=store,
        budget_s=args.budget,
        echo=print,
        device=args.device,
    )
    _print_summary(summary)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(summary, f, indent=2, sort_keys=True)
        print(f"\nwrote {args.json}")
    bad = failed_cells(summary)
    for c in bad:
        print(
            f"FAILED cell {c['label']} seed={c['seed']}: {c['status']}",
            file=sys.stderr,
        )
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
