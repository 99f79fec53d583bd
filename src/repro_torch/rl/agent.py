"""DQN agent: epsilon-greedy exploration, target network, fused TD loss,
and the ADFLL round API (collect -> train on mixed replay -> share ERB).

The agent is a thin *view* over a :class:`~repro_torch.rl.fleet.FleetEngine`
slot: its params / target params / optimizer state live in the engine's
stacked :class:`~repro_torch.rl.fleet.FleetState`.  Two backends:

* ``backend="fleet"`` (default): training rounds are jobs the engine
  runs in batched flushes, many agents per stacked step;
* ``backend="stepwise"``: the reference's legacy one-dispatch-per-step
  path, the baseline the fleet is measured against.  The agent owns a
  private one-slot engine (its own params, target and AdamW state) and
  trains each step as it is planned
  (:meth:`~repro_torch.rl.fleet.FleetEngine.train_step`): ``replay_gather``
  gathers each pick of the plan from its ERB's device copy, ``fused_td``
  computes the TD tail at N = 1, and the stacked AdamW updates at N = 1.
  This mirrors the reference's ``use_pallas=True`` stepwise path; there
  is no host-built batch.  The reference's ``dqn_step_traces`` counts
  JAX retraces of that path; eager PyTorch traces nothing, so it has no
  counterpart here.

Both backends collect through the stacked q-value program and draw every
host sample (start locations, exploration, replay plans, share slices)
from the agent's own ``np.random.Generator`` in the reference's order.
The weight plane's ``snapshot_params`` / ``mix_params`` read and write
the slot through the engine.
"""

from __future__ import annotations

from collections.abc import Sequence
from dataclasses import InitVar, dataclass

import numpy as np
import torch

from repro_torch.configs.adfll_dqn import DQNConfig
from repro_torch.core.erb import ERB, TaskTag, erb_init, erb_share_slice
from repro_torch.core.plane import WeightSnapshot, mix_params, new_snap_id
from repro_torch.core.replay import SelectiveReplaySampler
from repro_torch.rl.dqn import dqn_apply
from repro_torch.rl.env import LandmarkEnv
from repro_torch.rl.fleet import FleetEngine, TrainFuture, collect_fleet, tree_map
from repro_torch.telemetry import NO_SPAN


@dataclass
class DQNAgent:
    """One ADFLL participant.

    State lives in a fleet slot: of a shared ``engine`` (the ADFLL system
    passes one so the whole fleet trains in batched flushes) or of a
    private single-slot engine built on ``device`` (``None`` = CUDA).
    The stepwise backend always builds its own; ``n_picks_gathered``
    counts the ``replay_gather`` launches its steps made.  After
    construction ``agent.device`` is the device of the agent's slot, read
    from the engine (on a mesh, the slot's shard's device): evaluation
    and the stepwise ERB copies run there.
    """

    agent_id: int
    cfg: DQNConfig
    seed: int = 0
    speed: float = 1.0  # relative hardware speed (sim time)
    backend: str = "fleet"
    engine: FleetEngine | None = None
    device: InitVar[str | torch.device | None] = None

    def __post_init__(self, device):
        if self.backend not in ("fleet", "stepwise"):
            raise ValueError(f"unknown backend: {self.backend!r}")
        if self.backend == "stepwise" and self.engine is not None:
            raise ValueError("the stepwise backend keeps its own state: no engine")
        if self.engine is None:
            self.engine = FleetEngine(self.cfg, device=device)
        elif self.engine.cfg != self.cfg:
            raise ValueError("shared FleetEngine built for a different config")
        self.slot = self.engine.add_slot(self.seed)
        self.rng = np.random.default_rng(abs(self.seed + 1000 * self.agent_id))
        self.step_count = 0
        self.personal_erbs: list[ERB] = []
        self.seen_erb_ids: set = set()
        self.seen_snap_ids: set = set()
        self.rounds_done = 0
        self.active = True  # False once the agent has left the system
        self.online = True  # availability (population dynamics)
        self.n_picks_gathered = 0
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
        one fleet job: a ``fleet.plan`` wall span with enabled telemetry
        (a flush that the submit forces nests in it)."""
        tel = self.engine.telemetry
        with (
            tel.wall_span("fleet.plan", "fleet", steps=n_steps)
            if tel.enabled
            else NO_SPAN
        ):
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
        """Train ``n_steps`` now; returns the last-step loss, 0.0 for no
        steps.  The fleet backend submits one job and flushes; the
        stepwise backend plans and trains one step at a time (the same
        rng draws in the same order)."""
        if self.backend == "fleet":
            future = self._submit_steps(n_steps, current, incoming)
            self.engine.flush()
            return future.loss if future.loss is not None else 0.0
        last = 0.0
        for _ in range(n_steps):
            plan = self.sampler.plan(
                self.rng,
                self.cfg.batch_size,
                current,
                personal=self.personal_erbs,
                incoming=incoming,
            )
            last = self.engine.train_step(self.slot, plan)
            self.n_picks_gathered += len(plan.picks)
            self.step_count += 1
        return last

    # -- weight plane (FedAsync-style mixing) ----------------------------------
    def snapshot_params(self, sim_time: float = 0.0) -> WeightSnapshot:
        """Package current params for the weight plane (marked seen so the
        agent never pulls its own snapshot back).  The snapshot holds a
        copy: no later step or flush can change what was pushed."""
        params = tree_map(torch.clone, self.params)
        snap = WeightSnapshot(
            new_snap_id(), self.agent_id, self.rounds_done, sim_time, params
        )
        self.seen_snap_ids.add(snap.snap_id)
        return snap

    def mix_params(
        self, incoming: Sequence[WeightSnapshot], alphas: Sequence[float]
    ) -> int:
        """Fold peer snapshots into our params with staleness-discounted
        rates: ``p <- (1-a_k) p + a_k w_k`` (stalest first); compressed
        snapshots are dequantized on apply.  The target network keeps its
        own cadence (the next periodic sync picks up the mixed params).
        Returns the number of snapshots consumed."""
        snaps = [s for s in incoming if s.agent_id != self.agent_id]
        for s in incoming:
            self.seen_snap_ids.add(s.snap_id)
        if not snaps:
            return 0
        alphas = [
            a
            for s, a in zip(incoming, alphas, strict=True)
            if s.agent_id != self.agent_id
        ]
        self.params = mix_params(self.params, snaps, alphas)
        return len(snaps)

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
        batched flush.  On the stepwise backend the round trains now and
        the future is already resolved."""
        if current is None:
            current = self.new_round_erb(task, erb_capacity)
            self.collect(env, current, collect_episodes)
        for e in incoming:
            self.seen_erb_ids.add(e.meta.erb_id)
        if self.backend == "fleet":
            future = self._submit_steps(train_steps, current, incoming)
        else:
            future = TrainFuture()
            future.resolve(self.train_steps(train_steps, current, incoming))
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


# the slot's device, read from the engine on every use (a property set
# after the dataclass is built, so ``device`` stays an init argument)
DQNAgent.device = property(lambda self: self.engine.slot_device(self.slot))
