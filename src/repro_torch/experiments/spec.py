"""Frozen, declarative scenario descriptions.

A :class:`ScenarioSpec` captures what an ADFLL experiment needs: the
patient pool, the DQN and system configs, and the evaluation protocol;
the tasks are the paper's eight deployment task-environments.
``spec.seed`` is the single source of truth for randomness: the runner
mirrors it into ``sys.seed`` before construction.

The reference's spec also selects other systems and task sets and
carries churn schedules, populations, per-site links and serving
traffic; those come with later slices of the port.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

from repro_torch.configs.adfll_dqn import ADFLLConfig, DQNConfig


@dataclass(frozen=True)
class ScenarioSpec:
    """One named, fully declarative ADFLL experiment."""

    name: str
    description: str = ""
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

    def with_seed(self, seed: int) -> ScenarioSpec:
        """Re-seed the whole scenario (spec and system config stay in
        lockstep — there is exactly one seed)."""
        return replace(self, seed=seed, sys=replace(self.sys, seed=seed))

    def fast(self) -> ScenarioSpec:
        """The CI-sized variant: fewer train steps; everything else
        identical."""
        steps = min(self.sys.train_steps_per_round, self.fast_train_steps)
        return replace(self, sys=replace(self.sys, train_steps_per_round=steps))


__all__ = ["ScenarioSpec"]
