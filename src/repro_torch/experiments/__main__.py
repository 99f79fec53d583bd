"""CLI of the port's scenario runner.

    PYTHONPATH=src python -m repro_torch.experiments --list
    PYTHONPATH=src python -m repro_torch.experiments --scenario paper_fig2 \
        [--fast] [--seed N] [--engine {fleet,fleet-eager,stepwise}] [--device cpu] \
        [--devices N | --mesh] \
        [--trace out.jsonl] [--dashboard out.html]
    PYTHONPATH=src python -m repro_torch.experiments \
        --scenario churn_addition_fig4 --scenario gossip_hetero \
        --fast --json BENCH_experiments.json

Runs on the CUDA card unless ``--device cpu`` is given, and prints the
same ``name,mean_dist_err=...`` line per scenario as ``python -m
repro.experiments``.  ``--scenario`` repeats; ``--json`` writes the
``benchmarks/check_regression.py`` shape (one ``configs`` entry per
scenario).  ``--trace`` and ``--dashboard`` turn telemetry on
(observe-only) and write each run's trace and observatory dashboard;
with several scenarios the scenario's name goes before the extension.
``--devices N``/``--mesh`` set the scenario's ``fleet_devices`` as the
reference's flags do: the fleet engine shards its agents across up to N
visible cards (``models/sharding.py::make_fleet_mesh``), and with at most
one card, or with ``--device cpu``, the run is the single-device one.
Either way the records are those of a run without the flag (losses
within float32 rounding: each shard's stacked step sums over fewer
agents).
"""

from __future__ import annotations

import argparse
import sys
from dataclasses import replace

from repro_torch.experiments.registry import get_scenario, list_scenarios
from repro_torch.experiments.runner import resolve, run, write_json
from repro_torch.experiments.suggest import unknown_name_message


def _per_scenario(path: str | None, name: str, n_scenarios: int) -> str | None:
    """Insert the scenario name before the extension for multi-scenario runs."""
    if path is None or n_scenarios <= 1:
        return path
    stem, dot, ext = path.rpartition(".")
    return f"{stem}.{name}.{ext}" if dot else f"{path}.{name}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.experiments")
    ap.add_argument(
        "--list", action="store_true", help="list registered scenarios and exit"
    )
    ap.add_argument(
        "--scenario",
        action="append",
        default=[],
        metavar="NAME",
        help="scenario to run (repeatable)",
    )
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
        "--devices",
        type=int,
        default=None,
        metavar="N",
        help=(
            "shard the fleet's agent axis across up to N visible CUDA cards "
            "(-1 = all; rounded down to a power of two); with at most one "
            "card, or on the CPU, this is the single-device run"
        ),
    )
    ap.add_argument(
        "--mesh",
        action="store_true",
        help="shorthand for --devices -1 (every local device)",
    )
    ap.add_argument(
        "--json",
        default=None,
        metavar="OUT",
        help="write results as JSON (BENCH_*.json for CI gating)",
    )
    ap.add_argument(
        "--trace",
        default=None,
        metavar="PATH",
        help=(
            "capture a telemetry trace per scenario (Perfetto JSON; .jsonl "
            "for the flat format). With several --scenario flags the "
            "scenario name is inserted before the extension."
        ),
    )
    ap.add_argument(
        "--dashboard",
        default=None,
        metavar="PATH",
        help=(
            "render the run's observatory dashboard (self-contained HTML) "
            "per scenario; multi-scenario name insertion as for --trace"
        ),
    )
    args = ap.parse_args(argv)
    if args.list or not args.scenario:
        print(f"{'scenario':<24} {'system':<12} description")
        for spec in list_scenarios():
            print(f"{spec.name:<24} {spec.system:<12} {spec.description}")
        return 0
    known = [s.name for s in list_scenarios()]
    for name in args.scenario:
        try:
            get_scenario(name)
        except KeyError:
            print(unknown_name_message("scenario", name, known), file=sys.stderr)
            return 2

    reports = []
    for name in args.scenario:
        spec = resolve(name, fast=args.fast, seed=args.seed)
        if args.engine is not None:
            spec = replace(spec, sys=replace(spec.sys, engine=args.engine))
        devices = -1 if args.mesh and args.devices is None else args.devices
        if devices is not None:
            spec = replace(spec, sys=replace(spec.sys, fleet_devices=devices))
        trace_path = _per_scenario(args.trace, name, len(args.scenario))
        dashboard_path = _per_scenario(args.dashboard, name, len(args.scenario))
        report = run(
            spec,
            device=args.device,
            trace_path=trace_path,
            dashboard_path=dashboard_path,
        )
        reports.append(report)
        if trace_path is not None:
            print(f"wrote trace {trace_path}")
        if dashboard_path is not None:
            print(f"wrote dashboard {dashboard_path}")
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
    if args.json:
        write_json(args.json, reports, fast=args.fast)
        print(f"wrote {args.json}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
