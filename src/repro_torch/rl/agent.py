"""DQN agent: epsilon-greedy exploration, target network, fused TD loss,
and the ADFLL round API (collect -> train on mixed replay -> share ERB).

The agent is a thin *view* over a :class:`~repro_torch.rl.fleet.FleetEngine`
slot: its params / target params / optimizer state live in the engine's
stacked :class:`~repro_torch.rl.fleet.FleetState`, and training rounds
are jobs the engine runs in batched flushes.  Every host draw (start
locations, exploration, replay plans, share slices) consumes the agent's
own ``np.random.Generator`` in the reference's order.

Waiting for later slices of the port: the legacy per-step backend
(``backend="stepwise"``) and the weight plane (``snapshot_params`` /
``mix_params``); both raise ``NotImplementedError``.
"""

from __future__ import annotations

from collections.abc import Sequence
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.configs.adfll_dqn import DQNConfig
from repro_torch.core.erb import ERB, TaskTag, erb_init, erb_share_slice
from repro_torch.core.replay import SelectiveReplaySampler
from repro_torch.rl.dqn import dqn_apply
from repro_torch.rl.env import LandmarkEnv
from repro_torch.rl.fleet import FleetEngine, TrainFuture, collect_fleet

_LATER = "the stepwise backend and the weight plane come in a later slice of the port"


@dataclass
class DQNAgent:
    """One ADFLL participant.

    State lives in a fleet slot: of a shared ``engine`` (the ADFLL system
    passes one so the whole fleet trains in batched flushes) or of a
    private single-slot engine built on ``device`` (``None`` = CUDA).
    """

    agent_id: int
    cfg: DQNConfig
    seed: int = 0
    speed: float = 1.0  # relative hardware speed (sim time)
    backend: str = "fleet"
    engine: FleetEngine | None = None
    device: str | torch.device | None = None

    def __post_init__(self):
        if self.backend == "stepwise":
            raise NotImplementedError(_LATER)
        if self.backend != "fleet":
            raise ValueError(f"unknown backend: {self.backend!r}")
        if self.engine is None:
            self.engine = FleetEngine(self.cfg, device=self.device)
        elif self.engine.cfg != self.cfg:
            raise ValueError("shared FleetEngine built for a different config")
        self.device = self.engine.device
        self.slot = self.engine.add_slot(self.seed)
        self.rng = np.random.default_rng(abs(self.seed + 1000 * self.agent_id))
        self.step_count = 0
        self.personal_erbs: list[ERB] = []
        self.seen_erb_ids: set = set()
        self.rounds_done = 0
        self.sampler = SelectiveReplaySampler()

    # -- state views (fleet slot) ----------------------------------------
    @property
    def params(self) -> dict:
        return self.engine.get_params(self.slot)

    @params.setter
    def params(self, value: dict):
        self.engine.set_params(self.slot, value)

    @property
    def target_params(self) -> dict:
        return self.engine.get_target(self.slot)

    @target_params.setter
    def target_params(self, value: dict):
        self.engine.set_target(self.slot, value)

    # -- acting ----------------------------------------------------------
    def epsilon(self) -> float:
        c = self.cfg
        frac = min(1.0, self.step_count / max(1, c.eps_decay_steps))
        return c.eps_start + frac * (c.eps_end - c.eps_start)

    @torch.no_grad()
    def q_values(self, obs: np.ndarray, loc: np.ndarray) -> np.ndarray:
        """One agent's q-values ``[B, n_actions]`` for a host batch."""
        q = dqn_apply(
            self.cfg,
            self.params,
            torch.from_numpy(obs).to(self.device),
            torch.from_numpy(loc).to(self.device),
        )
        return q.cpu().numpy()

    # -- experience collection ---------------------------------------------
    def collect(self, env: LandmarkEnv, erb: ERB, n_episodes: int) -> ERB:
        collect_fleet([self], [env], [erb], n_episodes)
        return erb

    # -- learning ------------------------------------------------------------
    def _submit_steps(
        self, n_steps: int, current: ERB | None, incoming: Sequence[ERB]
    ) -> TrainFuture:
        """Plan n minibatches (host index selection) and queue them as
        one fleet job."""
        plans = [
            self.sampler.plan(
                self.rng,
                self.cfg.batch_size,
                current,
                personal=self.personal_erbs,
                incoming=incoming,
            )
            for _ in range(n_steps)
        ]
        self.step_count += n_steps
        return self.engine.submit(self.slot, plans)

    def train_steps(
        self, n_steps: int, current: ERB | None, incoming: Sequence[ERB] = ()
    ) -> float:
        """Train ``n_steps`` now (submit and flush); returns the last-step
        loss, 0.0 for no steps."""
        future = self._submit_steps(n_steps, current, incoming)
        self.engine.flush()
        return future.loss if future.loss is not None else 0.0

    # -- weight plane (a later slice) ------------------------------------------
    def snapshot_params(self, sim_time: float = 0.0):
        raise NotImplementedError(_LATER)

    def mix_params(self, incoming, alphas) -> int:
        raise NotImplementedError(_LATER)

    # -- ADFLL round (paper A.3) ----------------------------------------------
    def new_round_erb(self, task: TaskTag, erb_capacity: int) -> ERB:
        """The empty current-round buffer (tagged with this agent's id and
        round index)."""
        return erb_init(
            erb_capacity,
            self.cfg.box_size,
            task=task,
            source_agent=self.agent_id,
            round_idx=self.rounds_done,
        )

    def begin_round(
        self,
        env: LandmarkEnv,
        task: TaskTag,
        incoming: Sequence[ERB],
        *,
        erb_capacity: int,
        share_size: int,
        train_steps: int,
        collect_episodes: int = 24,
        share_strategy: str = "uniform",
        current: ERB | None = None,
    ) -> tuple[ERB, TrainFuture]:
        """Collect on the round's task and *submit* the round's training
        (current + personal + incoming replay) to the fleet engine
        without forcing execution.  Returns (shared ERB, loss future) —
        the shared slice never depends on the round's own updates, so
        the system keeps scheduling while jobs accumulate into one
        batched flush."""
        if current is None:
            current = self.new_round_erb(task, erb_capacity)
            self.collect(env, current, collect_episodes)
        for e in incoming:
            self.seen_erb_ids.add(e.meta.erb_id)
        future = self._submit_steps(train_steps, current, incoming)
        self.personal_erbs.append(current)
        self.rounds_done += 1
        shared = erb_share_slice(current, share_size, self.rng, strategy=share_strategy)
        self.seen_erb_ids.add(shared.meta.erb_id)
        return shared, future

    def train_round(
        self,
        env: LandmarkEnv,
        task: TaskTag,
        incoming: Sequence[ERB],
        *,
        erb_capacity: int,
        share_size: int,
        train_steps: int,
        collect_episodes: int = 24,
        share_strategy: str = "uniform",
    ) -> tuple[ERB, float]:
        """Collect, then train on current + personal + incoming replay.
        Returns (shared ERB, loss)."""
        shared, future = self.begin_round(
            env,
            task,
            incoming,
            erb_capacity=erb_capacity,
            share_size=share_size,
            train_steps=train_steps,
            collect_episodes=collect_episodes,
            share_strategy=share_strategy,
        )
        self.engine.flush()
        return shared, future.loss

    # -- evaluation ------------------------------------------------------------
    def evaluate(
        self, env: LandmarkEnv, n_episodes: int = 8, max_steps: int | None = None
    ) -> float:
        """Greedy rollout from deterministic starts; mean final distance."""
        rng = np.random.default_rng(1234)
        locs = env.start_locs(n_episodes, rng)
        for _ in range(max_steps or self.cfg.max_episode_steps):
            q = self.q_values(env.observe(locs), env.norm_loc(locs))
            locs, _, done = env.step(locs, q.argmax(-1).astype(np.int32))
            if done.all():
                break
        return float(env.dist(locs).mean())
