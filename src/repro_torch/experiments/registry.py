"""Named scenario registry.

This slice of the port registers the paper's deployment experiment
(``paper_fig2``), its Table 1 comparison rows (Agents X, Y and M) and
synchronous FedAvg, with the reference's settings
(``src/repro/experiments/registry.py``); the other scenarios come with
later slices.
"""

from __future__ import annotations

from repro_torch.configs.adfll_dqn import ADFLLConfig, DQNConfig
from repro_torch.experiments.spec import ScenarioSpec

_REGISTRY: dict[str, ScenarioSpec] = {}


def register(spec: ScenarioSpec) -> ScenarioSpec:
    """Add a scenario (rejects silent overwrites)."""
    if spec.name in _REGISTRY:
        raise ValueError(f"scenario already registered: {spec.name!r}")
    _REGISTRY[spec.name] = spec
    return spec


def get_scenario(name: str) -> ScenarioSpec:
    try:
        return _REGISTRY[name]
    except KeyError:
        known = ", ".join(sorted(_REGISTRY))
        raise KeyError(f"unknown scenario {name!r}; registered: {known}") from None


def list_scenarios() -> list[ScenarioSpec]:
    return [_REGISTRY[k] for k in sorted(_REGISTRY)]


# Table 1 / Fig 3 deployment scale (the reference's CPU-tractable widths).
_DEPLOY_DQN = DQNConfig(
    volume_shape=(20, 20, 20),
    box_size=(8, 8, 8),
    conv_features=(4, 8),
    hidden=(64,),
    max_episode_steps=24,
    batch_size=32,
    eps_decay_steps=300,
    target_update=40,
)
_DEPLOY_SYS = ADFLLConfig(
    rounds=3,
    train_steps_per_round=80,
    erb_capacity=2048,
    erb_share_size=256,
    hub_sync_period=0.2,
)

# Plane/topology-ablation scale (CI-sized).
_TINY_DQN = DQNConfig(
    volume_shape=(16, 16, 16),
    box_size=(6, 6, 6),
    conv_features=(4,),
    hidden=(32,),
    max_episode_steps=12,
    batch_size=16,
    eps_decay_steps=100,
)


def _ablation_sys(**overrides) -> ADFLLConfig:
    base = dict(
        rounds=2,
        train_steps_per_round=30,
        erb_capacity=512,
        erb_share_size=64,
        hub_sync_period=0.25,
        gossip_period=0.25,
        mix_alpha=0.6,
        staleness_flag="poly",
        staleness_poly_a=0.5,
    )
    base.update(overrides)
    return ADFLLConfig(**base)


register(
    ScenarioSpec(
        name="paper_fig2",
        system="adfll",
        description="Table 1 / Fig 3 deployment: 4 async agents, 3 hubs, "
        "heterogeneous V100/T4 speeds, 8 task-environments",
        dqn=_DEPLOY_DQN,
        sys=_DEPLOY_SYS,
        n_patients=40,
        fast_train_steps=20,
    )
)

register(
    ScenarioSpec(
        name="baseline_all_knowing",
        system="all_knowing",
        description="Agent X: all datasets at once, one round over the union",
        dqn=_DEPLOY_DQN,
        sys=_DEPLOY_SYS,
        seed=100,
        n_patients=40,
        fast_train_steps=20,
    )
)

register(
    ScenarioSpec(
        name="baseline_partial",
        system="partial",
        description="Agent Y: a single dataset, a single round",
        dqn=_DEPLOY_DQN,
        sys=_DEPLOY_SYS,
        seed=200,
        n_patients=40,
        fast_train_steps=20,
    )
)

register(
    ScenarioSpec(
        name="baseline_sequential",
        system="sequential",
        description="Agent M: sequential lifelong learner, personal replay only",
        dqn=_DEPLOY_DQN,
        sys=_DEPLOY_SYS,
        seed=300,
        n_patients=40,
        fast_train_steps=20,
    )
)

register(
    ScenarioSpec(
        name="fedavg_sync",
        system="fedavg",
        description="Conventional synchronous FedAvg over DQN weights "
        "(central server, global barrier)",
        task_set="paper8",
        n_tasks=4,
        n_patients=16,
        dqn=_TINY_DQN,
        sys=_ablation_sys(n_agents=3, train_steps_per_round=40),
        seed=400,
        fast_train_steps=8,
    )
)

__all__ = ["get_scenario", "list_scenarios", "register"]
