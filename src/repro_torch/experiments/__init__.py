"""Declarative scenario API of the port:

    from repro_torch import experiments
    report = experiments.run("paper_fig2", fast=True)   # on the CUDA card

or from the shell:

    python -m repro_torch.experiments --list
    python -m repro_torch.experiments --scenario baseline_sequential --fast
"""

from repro_torch.experiments.protocol import SupportsChurn, System
from repro_torch.experiments.registry import get_scenario, list_scenarios, register
from repro_torch.experiments.runner import build, resolve, run
from repro_torch.experiments.spec import ScenarioSpec
from repro_torch.experiments.systems import BaselineSystem

__all__ = [
    "BaselineSystem",
    "ScenarioSpec",
    "SupportsChurn",
    "System",
    "build",
    "get_scenario",
    "list_scenarios",
    "register",
    "resolve",
    "run",
]
