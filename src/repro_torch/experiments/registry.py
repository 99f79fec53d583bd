"""Named scenario registry.

This slice of the port registers the paper's deployment experiment,
``paper_fig2``, with the reference's settings (``src/repro/experiments/
registry.py``); the other scenarios come with later slices.
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

register(
    ScenarioSpec(
        name="paper_fig2",
        description="Table 1 / Fig 3 deployment: 4 async agents, 3 hubs, "
        "heterogeneous V100/T4 speeds, 8 task-environments",
        dqn=_DEPLOY_DQN,
        sys=_DEPLOY_SYS,
        n_patients=40,
        fast_train_steps=20,
    )
)

__all__ = ["get_scenario", "register"]
