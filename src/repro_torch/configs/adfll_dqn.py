"""ADFLL DQN agent config — the paper's own model (Appendix A.1).

The 3D DQN is not part of the transformer zoo; it registers a separate
lightweight config consumed by ``repro_torch.rl``. Defaults reproduce the paper's
deployment experiment at CPU-tractable scale (the real system used 45^3
crops; we default to 24^3 synthetic volumes).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class DQNConfig:
    volume_shape: tuple[int, int, int] = (24, 24, 24)
    box_size: tuple[int, int, int] = (8, 8, 8)
    n_actions: int = 6  # +/- x, y, z
    frame_history: int = 1  # chain of locations in the state
    conv_features: tuple[int, ...] = (8, 16, 32)
    hidden: tuple[int, ...] = (128, 64)
    gamma: float = 0.9
    lr: float = 1e-3
    eps_start: float = 1.0
    eps_end: float = 0.05
    eps_decay_steps: int = 500
    target_update: int = 50  # steps between target-net syncs
    batch_size: int = 32
    max_episode_steps: int = 48
    step_size: int = 1  # voxels per action


@dataclass(frozen=True)
class ADFLLConfig:
    """System-level config for the deployment experiment (Fig. 2)."""

    n_agents: int = 4
    n_hubs: int = 3
    # hub assignment per agent (paper: A1->H1, A2->H2, A3/A4->H3)
    agent_hub: tuple[int, ...] = (0, 1, 2, 2)
    # relative training speed (paper: DGX-1 V100 agents ~2.5x faster than T4)
    agent_speed: tuple[float, ...] = (1.0, 1.0, 2.5, 2.5)
    hub_sync_period: float = 1.0  # simulated time between hub syncs
    dropout: float = 0.0  # communication dropout probability
    rounds: int = 3
    erb_capacity: int = 2048
    erb_share_size: int = 512  # experiences shared per round
    replay_mix: tuple[float, float, float] = (0.5, 0.25, 0.25)
    # fractions: (current task, personal past, incoming foreign)
    train_steps_per_round: int = 150
    seed: int = 0
    # -- execution engine ---------------------------------------------------
    # "fleet": rounds are submitted to the vectorized fleet engine and
    # execute lazily as batched scan-fused dispatches (the default);
    # "fleet-eager": same engine, flushed after every round (sequential
    # driving — bit-identical to "fleet", used by the equivalence tests);
    # "stepwise": the legacy one-dispatch-per-step path (benchmark
    # baseline; within float-fusion ULPs of the fused engine).
    engine: str = "fleet"
    # devices joining the fleet mesh (the stacked agent axis is sharded
    # across them): 0 = single-device (no mesh), -1 = every local device,
    # N = up to N — rounded down to a power of two; per-slot math is
    # bitwise invariant to the mesh, so reports match the 0 setting.
    fleet_devices: int = 0
    # task curriculum: "roundrobin" (the paper's rotation), "blocked"
    # (one task per cohort of n_agents draws before advancing), or
    # "shuffled" (seeded permutation of each full pass over the tasks)
    task_curriculum: str = "roundrobin"
    # -- topology (beyond-paper: hub-less gossip, BrainTorrent-style) ------
    # "hub": agents <-> hubs (the paper); "gossip": peer-to-peer anti-entropy,
    # no hub in the loop; "hybrid": both transports at once.
    topology: str = "hub"
    gossip_sampler: str = "random"  # ring | random | full | timevary
    gossip_fanout: int = 2  # peers per agent per round
    gossip_period: float = 0.5  # sim time between anti-entropy rounds
    # -- link model / bandwidth accounting ---------------------------------
    # every agent-link message costs latency + bytes/rate of simulated time
    # and may drop; the defaults are free+lossless (paper-faithful timing).
    link_latency: float = 0.0
    link_rate: float = float("inf")  # bytes per unit of simulated time
    link_drop: float = 0.0  # per-message gossip drop probability
    # -- sharing planes (beyond-paper: FedAsync-style weight plane) --------
    # which planes ride the topology: ("erb",), ("weights",), or both
    share_planes: tuple[str, ...] = ("erb",)
    # weight-plane wire compression: "none" (full float32 pytrees),
    # "int8" (dense quantized snapshots, ~4x), or "topk" (int8 top-k
    # deltas with sender-side error feedback, >=4x and usually ~15x)
    weight_compression: str = "none"
    weight_topk_frac: float = 0.05  # fraction of coords kept per delta
    mix_alpha: float = 0.6  # base mixing rate for peer weights
    staleness_flag: str = "poly"  # constant | hinge | poly
    # "time" measures staleness on the shared scheduler clock (robust to
    # heterogeneous agent speeds); "round" is FedAsync-literal counters
    staleness_clock: str = "time"
    staleness_hinge_a: float = 10.0
    staleness_hinge_b: float = 4.0
    staleness_poly_a: float = 0.5
    weight_max_versions: int = 2  # snapshots kept per agent per hub


DQN_CONFIG = DQNConfig()
ADFLL_CONFIG = ADFLLConfig()
