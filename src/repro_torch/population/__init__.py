"""Trace-driven population simulation for ADFLL experiments.

One declarative :class:`PopulationSpec` describes the whole fleet —
cohorts with arrival windows, per-agent compute heterogeneity, diurnal /
session / trace availability, timed departures, and hub outages — and
is compiled onto the system's discrete-event scheduler by the runner.
A framework-free copy of the reference's population package: the same
specs, the same per-member rng streams, the same event order.
"""

from repro_torch.population.compile import PopulationState, compile_onto, member_rng
from repro_torch.population.processes import AvailabilityProcess, availability_segments
from repro_torch.population.spec import (
    Availability,
    Cohort,
    Departure,
    Diurnal,
    HubOutage,
    PopulationSpec,
    Sessions,
    Trace,
)
from repro_torch.population.trace import load_windows, save_windows

__all__ = [
    "Availability",
    "AvailabilityProcess",
    "Cohort",
    "Departure",
    "Diurnal",
    "HubOutage",
    "PopulationSpec",
    "PopulationState",
    "Sessions",
    "Trace",
    "availability_segments",
    "compile_onto",
    "load_windows",
    "member_rng",
    "save_windows",
]
