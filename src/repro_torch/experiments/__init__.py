"""Declarative scenario API of the port:

    from repro_torch import experiments
    report = experiments.run("paper_fig2", fast=True)   # on the CUDA card

or from the shell: ``python -m repro_torch.experiments --scenario
paper_fig2 --fast``.
"""

from repro_torch.experiments.registry import get_scenario, register
from repro_torch.experiments.runner import build, resolve, run
from repro_torch.experiments.spec import ScenarioSpec

__all__ = ["ScenarioSpec", "build", "get_scenario", "register", "resolve", "run"]
