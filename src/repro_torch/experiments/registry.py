"""Named scenario registry.

The port registers the paper's deployment experiment (``paper_fig2``),
its Table 1 comparison rows (Agents X, Y and M), synchronous FedAvg, the
Fig 4/5 churn ablations, the Table 2 hub-failure rows, the population
scenarios, the sharing-plane ablation (``plane_*``), the topology
ablation (``topo_*``), the heterogeneous-link gossip scenario
(``gossip_hetero``) and the train-while-serve scenario
(``serve_localization``), with the reference's settings
(``src/repro/experiments/registry.py``).
"""

from __future__ import annotations

from dataclasses import replace

from repro_torch.configs.adfll_dqn import ADFLLConfig, DQNConfig
from repro_torch.core.experiment import ChurnEvent, HubFailure
from repro_torch.core.gossip import LinkModel
from repro_torch.experiments.spec import ScenarioSpec
from repro_torch.population import Cohort, Diurnal, PopulationSpec, Sessions
from repro_torch.serve.traffic import TrafficSpec

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

# Fig 4/5 churn-ablation scale.
_CHURN_DQN = DQNConfig(
    volume_shape=(16, 16, 16),
    box_size=(6, 6, 6),
    conv_features=(4, 8),
    hidden=(48,),
    max_episode_steps=16,
    batch_size=24,
    eps_decay_steps=200,
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

register(
    ScenarioSpec(
        name="churn_addition_fig4",
        system="adfll",
        description="Fig 4: agents join 4 -> 8 -> 12 -> 16 under 75% "
        "dropout; late joiners catch up from the hub database",
        task_set="all",
        n_patients=40,
        dqn=_CHURN_DQN,
        sys=ADFLLConfig(
            n_agents=4,
            n_hubs=3,
            agent_hub=(),
            agent_speed=(),
            rounds=4,
            dropout=0.75,
            train_steps_per_round=40,
            erb_capacity=1024,
            erb_share_size=128,
            hub_sync_period=0.5,
        ),
        churn=(
            ChurnEvent(at=1.6, action="add", count=4),
            ChurnEvent(at=3.2, action="add", count=4),
            ChurnEvent(at=4.8, action="add", count=4),
        ),
        eval_tasks=8,
        fast_eval_tasks=4,
        fast_train_steps=15,
    )
)

register(
    ScenarioSpec(
        name="churn_deletion_fig5",
        system="adfll",
        description="Fig 5: agents leave 24 -> 12 -> 6 -> 3 -> 1 under 75% "
        "dropout; knowledge survives in the hub database",
        task_set="all",
        n_patients=40,
        dqn=_CHURN_DQN,
        sys=ADFLLConfig(
            n_agents=24,
            n_hubs=3,
            agent_hub=(),
            agent_speed=(),
            rounds=5,
            dropout=0.75,
            train_steps_per_round=30,
            erb_capacity=1024,
            erb_share_size=128,
            hub_sync_period=0.5,
        ),
        churn=(
            ChurnEvent(at=1.8, action="remove", count=12),
            ChurnEvent(at=3.6, action="remove", count=6),
            ChurnEvent(at=5.4, action="remove", count=3),
            ChurnEvent(at=7.2, action="remove", count=2),
        ),
        eval_tasks=8,
        fast_eval_tasks=4,
        fast_train_steps=12,
    )
)

# -- Table 2: hub failure mid-training --------------------------------------
# Round durations are simulated (independent of train_steps), so t=1.5
# is mid-training in both the full and the --fast variants.
register(
    ScenarioSpec(
        name="paper_table2_hub_failure",
        system="adfll",
        description="Table 2: hub 3 (serving two agents) dies mid-training; "
        "orphans re-home to the surviving hubs, whose databases retain "
        "the shared knowledge",
        dqn=_DEPLOY_DQN,
        sys=_DEPLOY_SYS,
        n_patients=40,
        seed=500,
        hub_failures=(HubFailure(at=1.5, hub_id=2),),
        fast_train_steps=20,
    )
)

register(
    ScenarioSpec(
        name="paper_table2_total_failure",
        system="adfll",
        description="Table 2 (worst case): every hub dies mid-training; "
        "pure-hub agents lose all sharing and finish on local data alone",
        dqn=_DEPLOY_DQN,
        sys=_DEPLOY_SYS,
        n_patients=40,
        seed=510,
        hub_failures=(
            HubFailure(at=1.5, hub_id=0),
            HubFailure(at=1.5, hub_id=1),
            HubFailure(at=1.5, hub_id=2),
        ),
        fast_train_steps=20,
    )
)

register(
    ScenarioSpec(
        name="paper_table2_hybrid_failover",
        system="adfll",
        description="Table 2 failover: every hub dies mid-training but the "
        "hybrid topology keeps replicating both planes peer-to-peer",
        dqn=_DEPLOY_DQN,
        sys=replace(
            _DEPLOY_SYS,
            topology="hybrid",
            gossip_sampler="random",
            gossip_fanout=2,
            gossip_period=0.25,
        ),
        n_patients=40,
        seed=520,
        hub_failures=(
            HubFailure(at=1.5, hub_id=0),
            HubFailure(at=1.5, hub_id=1),
            HubFailure(at=1.5, hub_id=2),
        ),
        fast_train_steps=20,
    )
)

# -- online inference plane: train-while-serve session ----------------------
register(
    ScenarioSpec(
        name="serve_localization",
        system="serve",
        description="Online inference plane: continuous-batching "
        "localization serving with a mid-session param hot swap "
        "(train-while-serve)",
        task_set="paper8",
        n_tasks=4,
        n_patients=16,
        dqn=_TINY_DQN,
        sys=_ablation_sys(n_agents=2, rounds=2, train_steps_per_round=20),
        serve_traffic=TrafficSpec(
            n_requests=32, max_batch=8, n_version_slots=2, max_staleness=1
        ),
        seed=600,
        eval_patients=2,
        eval_episodes=2,
        fast_train_steps=8,
    )
)

# -- population dynamics (trace-driven fleet simulation) --------------------
register(
    ScenarioSpec(
        name="hospital_diurnal",
        system="adfll",
        description="Hospital-network diurnal load: two sites of gossiping "
        "hospitals on opposite day/night shifts; availability-aware "
        "anti-entropy only reaches the site that is awake",
        task_set="paper8",
        n_tasks=4,
        n_patients=16,
        dqn=_TINY_DQN,
        sys=_ablation_sys(
            rounds=3,
            topology="gossip",
            gossip_sampler="random",
            gossip_fanout=2,
        ),
        population=PopulationSpec(
            cohorts=(
                Cohort(
                    name="site_a",
                    n_agents=3,
                    availability=Diurnal(
                        period=2.0, on_fraction=0.6, phase=0.0, jitter=0.1
                    ),
                ),
                Cohort(
                    name="site_b",
                    n_agents=3,
                    availability=Diurnal(
                        period=2.0, on_fraction=0.6, phase=1.0, jitter=0.1
                    ),
                ),
            ),
        ),
        seed=700,
        eval_patients=2,
        eval_episodes=2,
        fast_train_steps=8,
    )
)

register(
    ScenarioSpec(
        name="flash_crowd",
        system="adfll",
        description="Flash-crowd onboarding: 4 incumbent agents, then 200 "
        "more join over a staggered mid-run wave and catch up from the "
        "hub databases",
        task_set="paper8",
        n_tasks=4,
        n_patients=16,
        dqn=_TINY_DQN,
        sys=_ablation_sys(rounds=2, n_hubs=3),
        population=PopulationSpec(
            cohorts=(
                Cohort(name="incumbents", n_agents=4),
                Cohort(
                    name="crowd",
                    n_agents=200,
                    arrive_at=1.0,
                    arrive_spread=1.5,
                ),
            ),
        ),
        seed=710,
        eval_patients=2,
        eval_episodes=2,
        fast_train_steps=8,
        fast_population_scale=0.1,  # 4 + 200 agents -> 1 + 20 in CI
    )
)

register(
    ScenarioSpec(
        name="long_tail_stragglers",
        system="adfll",
        description="Long-tail stragglers: one cohort with a lognormal "
        "step-time tail (some machines far slower than the median) and "
        "heavy-tailed connectivity sessions",
        task_set="paper8",
        n_tasks=4,
        n_patients=16,
        dqn=_TINY_DQN,
        sys=_ablation_sys(rounds=3),
        population=PopulationSpec(
            cohorts=(
                Cohort(
                    name="fleet",
                    n_agents=8,
                    speed_sigma=0.75,
                    availability=Sessions(
                        mean_on=1.5,
                        mean_off=0.5,
                        distribution="lognormal",
                        sigma=1.0,
                    ),
                ),
            ),
        ),
        seed=720,
        eval_patients=2,
        eval_episodes=2,
        fast_train_steps=8,
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
