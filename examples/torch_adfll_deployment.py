"""End-to-end driver on the PyTorch port: the paper's deployment
experiment (Fig. 2), as ``examples/adfll_deployment.py`` runs it.

Everything runs through the port's declarative scenario API:
``paper_fig2`` is four DQN agents (two fast "V100", two slow "T4") on
three hubs running asynchronous rounds over the 8 BraTS-like
task-environments, and the ``baseline_*`` scenarios are Agent X / Y / M —
the full Table 1 pipeline.  On the CUDA card unless ``--device cpu``.

    PYTHONPATH=src python examples/torch_adfll_deployment.py [--fast] [--device cpu]
    PYTHONPATH=src python examples/torch_adfll_deployment.py --scenario gossip_hetero
    PYTHONPATH=src python -m repro_torch.experiments --list
"""

import argparse

from repro_torch import experiments

BASELINES = ("baseline_all_knowing", "baseline_partial", "baseline_sequential")


def main(argv=None) -> dict:
    """Runs the scenario (and, for ``paper_fig2``, the Table 1 rows) and
    prints the summary; returns ``{"makespan", "means", "best"}``."""
    ap = argparse.ArgumentParser(prog="examples/torch_adfll_deployment.py")
    ap.add_argument("--fast", action="store_true")
    ap.add_argument(
        "--scenario",
        default="paper_fig2",
        help="any scenario from `python -m repro_torch.experiments --list`",
    )
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    report = experiments.run(args.scenario, fast=args.fast, device=args.device)
    scenario_means = report.agent_means()
    means = dict(scenario_means)
    if args.scenario == "paper_fig2":  # add the Table-1 comparison rows
        for name in BASELINES:
            run = experiments.run(name, fast=args.fast, device=args.device)
            means.update(run.agent_means())

    print(f"\nscenario {args.scenario}: sim makespan {report.makespan:.2f}")
    print("summary:")
    best = None
    if report.system == "adfll":
        best = min(scenario_means, key=scenario_means.get)
    for name, m in sorted(means.items(), key=lambda kv: kv[1]):
        marker = " <- best ADFLL agent" if name == best else ""
        print(f"  {name:8s} mean distance error {m:6.2f}{marker}")
    return {"makespan": report.makespan, "means": means, "best": best}


if __name__ == "__main__":
    main()
