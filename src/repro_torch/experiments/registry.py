"""Named scenario registry.

The port registers the paper's deployment experiment (``paper_fig2``),
its Table 1 comparison rows (Agents X, Y and M), synchronous FedAvg, the
sharing-plane ablation (``plane_*``), the topology ablation (``topo_*``)
and the heterogeneous-link gossip scenario (``gossip_hetero``), with the
reference's settings (``src/repro/experiments/registry.py``).  The churn,
hub-failure, population and serving scenarios come with their slices.
"""

from __future__ import annotations

from repro_torch.configs.adfll_dqn import ADFLLConfig, DQNConfig
from repro_torch.core.gossip import LinkModel
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


# a priced link (4 MiB per sim-unit) for the topology rows
_PRICED = dict(link_latency=0.002, link_rate=float(2**22))


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

register(
    ScenarioSpec(
        name="gossip_hetero",
        system="adfll",
        description="Hub-less gossip over two sites with per-link "
        "heterogeneous rates: fast intra-site, slow cross-site",
        task_set="paper8",
        n_tasks=4,
        n_patients=16,
        dqn=_TINY_DQN,
        sys=_ablation_sys(
            n_agents=6,
            agent_hub=(),
            agent_speed=(1.0, 1.0, 2.5, 1.0, 1.0, 2.5),
            topology="gossip",
            gossip_sampler="random",
            gossip_fanout=2,
            share_planes=("erb", "weights"),
            **_PRICED,
        ),
        agent_sites=(0, 0, 0, 1, 1, 1),
        intra_link=LinkModel(latency=0.0005, rate=float(2**24)),
        inter_link=LinkModel(latency=0.01, rate=float(2**20)),
        fast_train_steps=10,
    )
)

# -- sharing-plane ablation (ERB vs weights vs hybrid) ----------------------
for _plane_name, _planes in (
    ("plane_erb_only", ("erb",)),
    ("plane_weight_only", ("weights",)),
    ("plane_hybrid", ("erb", "weights")),
):
    register(
        ScenarioSpec(
            name=_plane_name,
            system="adfll",
            description=f"Sharing-plane ablation row: share_planes={_planes}",
            task_set="paper8",
            n_tasks=4,
            n_patients=16,
            dqn=_TINY_DQN,
            sys=_ablation_sys(share_planes=_planes),
            fast_train_steps=10,
        )
    )

# -- topology ablation (hub vs gossip vs hybrid, + compressed weights) ------
for _topo_name, _topo_overrides in (
    ("topo_hub", dict(topology="hub")),
    (
        "topo_gossip",
        dict(topology="gossip", gossip_sampler="random", gossip_fanout=2),
    ),
    (
        "topo_hybrid",
        dict(topology="hybrid", gossip_sampler="random", gossip_fanout=2),
    ),
    (
        "topo_gossip_topk",
        dict(
            topology="gossip",
            gossip_sampler="random",
            gossip_fanout=2,
            weight_compression="topk",
            weight_topk_frac=0.05,
        ),
    ),
):
    register(
        ScenarioSpec(
            name=_topo_name,
            system="adfll",
            description=f"Topology ablation row over a priced link: {_topo_name}",
            task_set="paper8",
            n_tasks=4,
            n_patients=16,
            dqn=_TINY_DQN,
            sys=_ablation_sys(
                share_planes=("erb", "weights"), **_PRICED, **_topo_overrides
            ),
            fast_train_steps=10,
        )
    )

__all__ = ["get_scenario", "list_scenarios", "register"]
