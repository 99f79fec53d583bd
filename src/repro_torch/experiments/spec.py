"""Frozen, declarative scenario descriptions.

A :class:`ScenarioSpec` captures what an experiment needs: the system
kind, the task set, the patient pool, the DQN and system configs, and
the evaluation protocol.  ``spec.seed`` is the single source of truth
for randomness: the runner mirrors it into ``sys.seed`` before
construction.

The reference's spec also carries churn schedules, populations,
per-site links and serving traffic; those come with later slices of the
port.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

from repro_torch.configs.adfll_dqn import ADFLLConfig, DQNConfig

SYSTEMS = ("adfll", "fedavg", "all_knowing", "partial", "sequential", "serve")
TASK_SETS = ("paper8", "all")


@dataclass(frozen=True)
class ScenarioSpec:
    """One named, fully declarative experiment."""

    name: str
    system: str = "adfll"  # one of SYSTEMS
    description: str = ""
    # -- problem -----------------------------------------------------------
    task_set: str = "paper8"  # "paper8" (deployment suite) | "all" (24 envs)
    n_tasks: int | None = None  # truncate the training task list
    n_patients: int = 40  # patient pool size (80:20 split)
    dqn: DQNConfig = field(default_factory=DQNConfig)
    sys: ADFLLConfig = field(default_factory=ADFLLConfig)
    seed: int = 0
    # -- evaluation --------------------------------------------------------
    eval_tasks: int | None = None  # eval on first N tasks (None = all)
    eval_patients: int | None = 4  # held-out patients per task
    eval_episodes: int = 4  # greedy rollouts per patient
    # -- fast (CI) variant -------------------------------------------------
    fast_train_steps: int = 10

    def __post_init__(self):
        if self.system not in SYSTEMS:
            raise ValueError(f"unknown system: {self.system!r}")
        if self.task_set not in TASK_SETS:
            raise ValueError(f"unknown task_set: {self.task_set!r}")

    def with_seed(self, seed: int) -> ScenarioSpec:
        """Re-seed the whole scenario (spec and system config stay in
        lockstep — there is exactly one seed)."""
        return replace(self, seed=seed, sys=replace(self.sys, seed=seed))

    def fast(self) -> ScenarioSpec:
        """The CI-sized variant: fewer train steps; everything else
        identical."""
        steps = min(self.sys.train_steps_per_round, self.fast_train_steps)
        return replace(self, sys=replace(self.sys, train_steps_per_round=steps))


__all__ = ["SYSTEMS", "TASK_SETS", "ScenarioSpec"]
