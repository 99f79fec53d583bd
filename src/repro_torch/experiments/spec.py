"""Frozen, declarative scenario descriptions.

A :class:`ScenarioSpec` captures what an experiment needs: the system
kind, the task set, the patient pool, the DQN and system configs
(topology, share planes, compression, speeds, hub layout), a churn
schedule, hub failures or a whole population, per-link heterogeneous
rates (site assignments + intra/inter links), and the evaluation
protocol, and for ``system="serve"`` the synthetic serving traffic.
``spec.seed`` is the single source of truth for randomness: the runner
mirrors it into ``sys.seed`` before construction.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

from repro_torch.configs.adfll_dqn import ADFLLConfig, DQNConfig
from repro_torch.core.experiment import ChurnEvent, HubFailure
from repro_torch.core.gossip import LinkModel
from repro_torch.population.spec import PopulationSpec
from repro_torch.serve.traffic import TrafficSpec

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
    # -- scenario dynamics -------------------------------------------------
    churn: tuple[ChurnEvent, ...] = ()  # timed add/remove events
    hub_failures: tuple[HubFailure, ...] = ()  # timed hub deaths (Table 2)
    population: PopulationSpec | None = None  # declarative fleet dynamics
    # -- per-link heterogeneous rates ----------------------------------------
    agent_sites: tuple[int, ...] = ()  # per-agent site ids
    hub_sites: tuple[int, ...] = ()  # per-hub site ids
    intra_link: LinkModel | None = None  # fast same-site link
    inter_link: LinkModel | None = None  # slow cross-site link
    serve_traffic: TrafficSpec | None = None  # system="serve" workload
    # -- evaluation --------------------------------------------------------
    eval_tasks: int | None = None  # eval on first N tasks (None = all)
    eval_patients: int | None = 4  # held-out patients per task
    eval_episodes: int = 4  # greedy rollouts per patient
    eval_at_churn: bool = True  # probe the error at each churn event
    # -- fast (CI) variant -------------------------------------------------
    fast_train_steps: int = 10
    fast_eval_tasks: int | None = None
    fast_population_scale: float = 1.0  # shrink cohorts for CI (1.0 = full)

    def __post_init__(self):
        if self.system not in SYSTEMS:
            raise ValueError(f"unknown system: {self.system!r}")
        if self.task_set not in TASK_SETS:
            raise ValueError(f"unknown task_set: {self.task_set!r}")
        if self.agent_sites and (self.intra_link is None and self.inter_link is None):
            raise ValueError("agent_sites given without intra/inter links")
        if self.hub_failures and self.sys.topology == "gossip":
            raise ValueError("hub_failures given but topology='gossip' has no hubs")
        if self.serve_traffic is not None and self.system != "serve":
            raise ValueError(
                f"serve_traffic given but system={self.system!r} is not 'serve'"
            )
        if self.population is not None:
            if self.system != "adfll":
                raise ValueError(
                    f"population given but system={self.system!r} is not 'adfll'"
                )
            if self.churn or self.hub_failures:
                raise ValueError(
                    "population and churn/hub_failures are exclusive: express "
                    "everything in the PopulationSpec (see PopulationSpec.from_churn)"
                )
            if not self.population.cohorts:
                raise ValueError("scenario population has no cohorts (no agents)")
            if self.population.hub_outages and self.sys.topology == "gossip":
                raise ValueError("hub_outages given but topology='gossip' has no hubs")
        if not 0.0 < self.fast_population_scale <= 1.0:
            raise ValueError(
                f"fast_population_scale not in (0, 1]: {self.fast_population_scale}"
            )

    def with_seed(self, seed: int) -> ScenarioSpec:
        """Re-seed the whole scenario (spec and system config stay in
        lockstep — there is exactly one seed)."""
        return replace(self, seed=seed, sys=replace(self.sys, seed=seed))

    def fast(self) -> ScenarioSpec:
        """The CI-sized variant: fewer train steps, optionally fewer
        evaluation tasks and a shrunken population; everything else
        identical."""
        steps = min(self.sys.train_steps_per_round, self.fast_train_steps)
        eval_tasks = (
            self.fast_eval_tasks
            if self.fast_eval_tasks is not None
            else self.eval_tasks
        )
        pop = self.population
        if pop is not None:
            pop = pop.scaled(self.fast_population_scale)
        return replace(
            self,
            sys=replace(self.sys, train_steps_per_round=steps),
            eval_tasks=eval_tasks,
            population=pop,
        )


__all__ = ["SYSTEMS", "TASK_SETS", "ScenarioSpec"]
