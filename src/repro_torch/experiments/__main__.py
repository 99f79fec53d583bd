"""CLI of the port's scenario runner.

    PYTHONPATH=src python -m repro_torch.experiments --list
    PYTHONPATH=src python -m repro_torch.experiments --scenario paper_fig2 \
        [--fast] [--seed N] [--engine {fleet,fleet-eager,stepwise}] [--device cpu] \
        [--trace out.jsonl] [--dashboard out.html]

Runs on the CUDA card unless ``--device cpu`` is given, and prints the
same ``name,mean_dist_err=...`` line as ``python -m repro.experiments``.
``--trace`` and ``--dashboard`` turn telemetry on (observe-only) and
write the run's trace and observatory dashboard.  One ``--scenario`` a
run; the reference's several ``--scenario`` flags and ``--json`` are
not ported yet.
"""

from __future__ import annotations

import argparse
import sys
from dataclasses import replace

from repro_torch.experiments.registry import get_scenario, list_scenarios
from repro_torch.experiments.runner import resolve, run
from repro_torch.experiments.suggest import unknown_name_message


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.experiments")
    ap.add_argument(
        "--list", action="store_true", help="list registered scenarios and exit"
    )
    ap.add_argument("--scenario", metavar="NAME", help="scenario to run")
    ap.add_argument(
        "--fast", action="store_true", help="reduced step counts (CI sanity)"
    )
    ap.add_argument("--seed", type=int, default=None, help="override the scenario seed")
    ap.add_argument(
        "--engine",
        choices=("fleet", "fleet-eager", "stepwise"),
        default=None,
        help="override the ADFLL execution engine (default: the scenario's)",
    )
    ap.add_argument(
        "--device",
        default=None,
        help="torch device to run on (default: cuda; 'cpu' runs on the CPU)",
    )
    ap.add_argument(
        "--trace",
        default=None,
        metavar="PATH",
        help="capture a telemetry trace (Perfetto JSON; .jsonl for the flat format)",
    )
    ap.add_argument(
        "--dashboard",
        default=None,
        metavar="PATH",
        help="render the run's observatory dashboard (self-contained HTML)",
    )
    args = ap.parse_args(argv)
    if args.list or not args.scenario:
        print(f"{'scenario':<24} {'system':<12} description")
        for spec in list_scenarios():
            print(f"{spec.name:<24} {spec.system:<12} {spec.description}")
        return 0
    try:
        get_scenario(args.scenario)
    except KeyError:
        known = [s.name for s in list_scenarios()]
        print(unknown_name_message("scenario", args.scenario, known), file=sys.stderr)
        return 2
    spec = resolve(args.scenario, fast=args.fast, seed=args.seed)
    if args.engine is not None:
        spec = replace(spec, sys=replace(spec.sys, engine=args.engine))
    report = run(
        spec,
        device=args.device,
        trace_path=args.trace,
        dashboard_path=args.dashboard,
    )
    if args.trace is not None:
        print(f"wrote trace {args.trace}")
    if args.dashboard is not None:
        print(f"wrote dashboard {args.dashboard}")
    curve = " -> ".join(
        f"{p.mean_err:.2f}@{p.t:.1f}(n={p.n_agents})" for p in report.eval_curve
    )
    print(
        f"{report.scenario},mean_dist_err={report.mean_dist_err:.3f},"
        f"best_agent_err={report.best_agent_err:.3f},"
        f"sim_makespan={report.makespan:.2f},n_rounds={report.n_rounds},"
        f"total_bytes={report.total_bytes}"
    )
    print(f"derived,{report.scenario},eval_curve={curve}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
