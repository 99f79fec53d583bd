"""The ``System`` protocol: one interface for every learning system.

``ADFLLSystem``, ``CentralAggregationSystem``, and the Table 1 baseline
trainers (wrapped as single-agent systems in
:mod:`repro_torch.experiments.systems`) all conform structurally — no
inheritance required:

* ``run() -> Report`` executes the system to completion and returns the
  run-side accounting (:class:`~repro_torch.core.experiment.Report`).
* ``evaluate(tasks, patients, ...)`` maps agent labels to per-task mean
  terminal distance errors.

Systems with dynamic membership additionally satisfy
:class:`SupportsChurn` (``add_agent`` / ``remove_agent`` /
``schedule_churn``).
"""

from __future__ import annotations

from collections.abc import Sequence
from typing import Protocol, runtime_checkable

from repro_torch.core.experiment import Report


@runtime_checkable
class System(Protocol):
    """What every experiment system exposes to the runner."""

    def run(self) -> Report: ...

    def evaluate(
        self,
        tasks: Sequence,
        patients: Sequence[int],
        *,
        max_patients: int | None = 4,
        n_episodes: int = 4,
    ) -> dict[str, dict[str, float]]: ...


@runtime_checkable
class SupportsChurn(Protocol):
    """Systems whose membership can change while they run."""

    def add_agent(
        self,
        *,
        speed: float = 1.0,
        hub_id: int | None = None,
    ) -> int: ...

    def remove_agent(self, agent_id: int) -> None: ...

    def schedule_churn(self, events: Sequence) -> None: ...


__all__ = ["SupportsChurn", "System"]
