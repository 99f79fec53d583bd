"""Vectorized fleet engine: stacked-agent state, K-step training chunks,
and device-resident replay.

The PyTorch counterpart of ``src/repro/rl/fleet.py``:

* :class:`FleetState` — every agent's params / target params / optimizer
  state / step counter, each tensor with a leading agent axis.
* :class:`FleetSteps` — the fleet program of one config.  Its
  :meth:`~FleetSteps.train_chunk` runs K train steps for N agents at
  once: each step gathers the ``N * B`` minibatch rows from the pooled
  ``[R, F]`` device replay with the ``replay_gather`` kernel, runs the
  stacked DQN forward (grouped convs, batched matmuls), ends in the
  ``fused_td`` kernel on the flattened rows, backpropagates, applies the
  stacked AdamW and syncs each slot's target on its own count.  The
  reference ``lax.scan``s the steps and ``vmap``s the agents; here the
  steps are a Python loop and the agent axis is a batch dimension.
* :class:`CollectSteps` / :func:`collect_fleet` — the collection phase:
  one stacked q-value forward per environment step for a cohort, with
  epsilon-greedy sampling on the host consuming each agent's own rng in
  the reference order.
* :class:`FleetEngine` — the host-side orchestrator: slots in a pow2
  capacity with inert dead rows, a lazy job queue, flush-on-read, the
  ``(erb_id, version)``-keyed LRU device cache of flattened ERBs with a
  byte budget, the resident fast path, and futures that resolve in
  submission order.

State updates are functional (new tensors, never writes into the
resident ones), so a tensor handed out by ``get_params`` stays a valid
snapshot.  Waiting for later slices of the port: mesh sharding of the
agent axis, the observatory's stats chunk, and the serving plane's
batched act program.
"""

from __future__ import annotations

from collections import OrderedDict
from collections.abc import Callable, Sequence
from dataclasses import dataclass, fields, replace

import numpy as np
import torch

from repro_torch.configs.adfll_dqn import DQNConfig
from repro_torch.core.erb import ERB, erb_add, erb_flatten, flat_width
from repro_torch.device import resolve_device
from repro_torch.kernels.fused_td import td_loss
from repro_torch.kernels.replay_gather import replay_gather
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
from repro_torch.rl.dqn import dqn_apply_stacked, dqn_init


def tree_map(fn: Callable, tree, *rest):
    """Map ``fn`` over the tensor leaves of nested dicts."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


@dataclass
class FleetState:
    """Stacked per-agent training state, leading axis = agent slot."""

    params: dict  # [N, ...] stacked DQN parameters
    target: dict  # [N, ...] stacked target-network parameters
    opt: dict  # {"m": [N, ...], "v": [N, ...], "count": [N] int32}
    count: torch.Tensor  # [N] int32 per-slot step counters (target sync)

    def map(self, fn: Callable, *others: FleetState) -> FleetState:
        """Apply ``fn`` to every tensor (zipped with ``others``)."""
        return FleetState(
            **{
                f.name: tree_map(
                    fn, getattr(self, f.name), *(getattr(o, f.name) for o in others)
                )
                for f in fields(self)
            }
        )


def make_dqn_opt_cfg(cfg: DQNConfig) -> AdamWConfig:
    """The DQN optimizer settings of the reference (``fleet.py:103-108``)."""
    return AdamWConfig(
        lr=cfg.lr, weight_decay=0.0, clip_norm=10.0, warmup_steps=0, total_steps=10**9
    )


def _per_slot(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return x.reshape(-1, *([1] * (like.dim() - 1)))


class FleetSteps:
    """The fleet program of one config.

    ``train_chunk(state, pool, idx) -> (state, losses)`` where ``state``
    is a :class:`FleetState` of the participating slots, ``pool`` the
    flat ``[R, F]`` device replay pool, and ``idx`` the ``[K, N, B]``
    int32 global row-index tensor (the one host->device transfer of a
    flush).  ``losses`` is ``[K, N]``: each slot's mean TD loss per step.
    """

    def __init__(self, cfg: DQNConfig, device: str | torch.device | None = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.opt_cfg = make_dqn_opt_cfg(cfg)
        self.box = tuple(cfg.box_size)
        self.obs_f = int(np.prod(self.box))
        self.feat = flat_width(self.box)

    def split_rows(self, rows: torch.Tensor) -> dict[str, torch.Tensor]:
        """[N, B, F] flat rows -> batch dict (``FLAT_FIELDS`` column order;
        ``action`` is stored as float32 and cast back to an index)."""
        n, b, _ = rows.shape
        o, out = 0, {}
        for key, width in (
            ("obs", self.obs_f),
            ("loc", 3),
            ("action", 1),
            ("reward", 1),
            ("next_obs", self.obs_f),
            ("next_loc", 3),
            ("done", 1),
        ):
            v = rows[:, :, o : o + width]
            o += width
            if key in ("obs", "next_obs"):
                v = v.reshape(n, b, *self.box)
            elif key == "action":
                v = v.to(torch.int64)
            else:
                v = v.contiguous()
            out[key] = v
        return out

    def loss(self, params: dict, target: dict, batch: dict) -> torch.Tensor:
        """Per-slot mean TD loss ``[N]`` (``fleet.py::make_dqn_loss_fn``
        over the agent axis); the TD tail runs once on all N*B rows."""
        cfg = self.cfg
        q = dqn_apply_stacked(cfg, params, batch["obs"], batch["loc"])
        n, b, a = q.shape
        q_sel = q.gather(2, batch["action"]).reshape(n * b, 1)
        with torch.no_grad():
            q_next = dqn_apply_stacked(
                cfg, target, batch["next_obs"], batch["next_loc"]
            )
        rows = td_loss(
            q_sel,
            q_next.reshape(n * b, a),
            batch["reward"].reshape(n * b, 1),
            batch["done"].reshape(n * b, 1),
            cfg.gamma,
        )
        return rows.reshape(n, b).mean(1)

    def step(self, state: FleetState, rows: torch.Tensor):
        """One train step of every slot on its ``[B, F]`` rows ``[N, B, F]``."""
        batch = self.split_rows(rows)
        names = [(k, n) for k in state.params for n in state.params[k]]
        live = tree_map(lambda t: t.detach().requires_grad_(True), state.params)
        with torch.enable_grad():
            losses = self.loss(live, state.target, batch)
            # agents share no parameters: the gradient of the sum is each
            # agent's own gradient of its own mean loss
            flat = torch.autograd.grad(losses.sum(), [live[k][n] for k, n in names])
        grads: dict = {k: {} for k in state.params}
        for (k, n), g in zip(names, flat, strict=True):
            grads[k][n] = g
        with torch.no_grad():
            params, opt, _ = adamw_update(self.opt_cfg, state.params, grads, state.opt)
            count = state.count + 1
            sync = (count % self.cfg.target_update) == 0
            target = tree_map(
                lambda t, p: torch.where(_per_slot(sync, p), p, t), state.target, params
            )
        return FleetState(params, target, opt, count), losses.detach()

    def train_chunk(self, state: FleetState, pool: torch.Tensor, idx: torch.Tensor):
        k_steps, n, b = idx.shape
        ones = torch.ones(n * b, dtype=torch.float32, device=pool.device)
        losses = []
        for k in range(k_steps):
            rows = replay_gather(pool, idx[k].reshape(-1), ones)
            state, loss = self.step(state, rows.reshape(n, b, self.feat))
            losses.append(loss)
        return state, torch.stack(losses)

    def init_slot(self, seed: int) -> FleetState:
        """A 1-slot :class:`FleetState` from the port's own init (torch's
        generator seeded with ``seed``; the reference's distribution, not
        its bits)."""
        gen = torch.Generator().manual_seed(seed)
        params = tree_map(lambda t: t[None], dqn_init(self.cfg, gen, self.device))
        return FleetState(
            params=params,
            target=tree_map(torch.clone, params),
            opt=adamw_init(params),
            count=torch.zeros(1, dtype=torch.int32, device=self.device),
        )


class CollectSteps:
    """The stacked greedy-rollout q-value program of one config.

    ``qvals(stacked, obs, loc) -> q`` maps ``[A, ...]`` stacked params and
    ``[A, B, *box]`` / ``[A, B, 3]`` per-agent observation batches to
    ``[A, B, n_actions]`` q-values in one forward.
    """

    def __init__(self, cfg: DQNConfig):
        self.cfg = cfg

    @torch.no_grad()
    def qvals(self, stacked: dict, obs: torch.Tensor, loc: torch.Tensor):
        return dqn_apply_stacked(self.cfg, stacked, obs, loc)


def collect_fleet(agents, envs, erbs, n_episodes: int) -> None:
    """Collect one round of experience for a cohort of fleet agents:
    one stacked q-value forward per environment step for the cohort.

    ``agents[i]`` rolls ``n_episodes`` episodes in ``envs[i]``, appending
    transitions to ``erbs[i]``.  Every epsilon-greedy draw
    (``start_locs``, action integers, exploration coins) comes from that
    agent's own ``np.random.Generator`` in the reference's order; agents
    whose episodes all finish early stop consuming their rng and stop
    writing their ERB.
    """
    if not agents:
        return
    engine = agents[0].engine
    cfg = agents[0].cfg
    steps = CollectSteps(cfg)
    n = len(agents)
    stacked = engine.slot_params([a.slot for a in agents])
    box = cfg.box_size
    b = n_episodes
    locs = np.stack([env.start_locs(b, a.rng) for a, env in zip(agents, envs)])
    alive = np.ones((n, b), bool)
    obs_buf = np.zeros((n, b, *box), np.float32)
    loc_buf = np.zeros((n, b, 3), np.float32)
    for _ in range(cfg.max_episode_steps):
        live = [i for i in range(n) if alive[i].any()]
        if not live:
            break
        for i in live:
            obs_buf[i] = envs[i].observe(locs[i])
            loc_buf[i] = envs[i].norm_loc(locs[i])
        q = steps.qvals(
            stacked,
            torch.from_numpy(obs_buf).to(engine.device),
            torch.from_numpy(loc_buf).to(engine.device),
        )
        q = q.cpu().numpy()
        for i in live:
            agent, env, erb = agents[i], envs[i], erbs[i]
            eps = agent.epsilon()
            greedy = q[i].argmax(-1)
            rand = agent.rng.integers(0, cfg.n_actions, size=b)
            coin = agent.rng.random(b) < eps
            acts = np.where(coin, rand, greedy).astype(np.int32)
            new, r, done = env.step(locs[i], acts)
            idx = np.where(alive[i])[0]
            batch = {
                "obs": obs_buf[i][idx],
                "loc": loc_buf[i][idx],
                "action": acts[idx],
                "reward": r[idx],
                "next_obs": env.observe(new[idx]),
                "next_loc": env.norm_loc(new[idx]),
                "done": done[idx].astype(np.float32),
            }
            erb_add(erb, batch)
            locs[i] = new
            alive[i] &= ~done


class TrainFuture:
    """Resolution handle of a submitted training job: ``loss`` is the
    last-step TD loss once the job's chunk has flushed."""

    __slots__ = ("done", "loss", "_cbs")

    def __init__(self):
        self.done = False
        self.loss: float | None = None
        self._cbs: list[Callable[[float], None]] = []

    def on_done(self, cb: Callable[[float], None]) -> None:
        if self.done:
            cb(self.loss)
        else:
            self._cbs.append(cb)

    def resolve(self, loss: float) -> None:
        self.done = True
        self.loss = float(loss)
        cbs, self._cbs = self._cbs, []
        for cb in cbs:
            cb(self.loss)


class _Job:
    """One pending round of training for a slot: the ERBs it reads and
    the per-step (erb-position, row) selection, shuffle already applied."""

    __slots__ = ("slot", "n_steps", "erbs", "eidx", "rows", "future")

    def __init__(self, slot, n_steps, erbs, eidx, rows, future):
        self.slot = slot
        self.n_steps = n_steps
        self.erbs: list[ERB] = erbs
        self.eidx: np.ndarray = eidx  # [K, B] int32 position into self.erbs
        self.rows: np.ndarray = rows  # [K, B] int32 local row index
        self.future: TrainFuture = future


def _pow2(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


# bounds of the device cache of flattened ERBs: entries and total bytes
ERB_CACHE_SIZE = 128
ERB_CACHE_BYTES = 256 * 1024**2


class FleetEngine:
    """Host-side orchestrator of one stacked fleet on one device.

    Slots are added per agent; training rounds are *submitted* as jobs
    (pure index plans — no data moves) and executed lazily: any read or
    write of a slot's state forces a flush, and a flush trains **all**
    pending jobs in one stacked chunk per distinct K.  Futures resolve in
    submission order, so deferred bookkeeping (round records) lands in
    the same order as sequential execution.

    The resident slot axis is padded to a pow2 ``capacity``: rows past
    ``n_slots`` are *dead* — inert copies that are never read and get
    overwritten when a slot is added, so growth does not force a flush
    while capacity is spare.  A flush whose jobs cover every resident
    row in order passes the resident state straight through the chunk
    (no gather in, no scatter out); any other flush gathers the slots of
    its jobs, and only those, and scatters them back.  Cohorts and flushes
    are not padded: eager PyTorch compiles nothing per shape.

    ``n_chunk_steps`` counts stacked train steps: each launches the
    ``replay_gather`` and ``fused_td`` kernels once.
    """

    def __init__(self, cfg: DQNConfig, *, device: str | torch.device | None = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.steps = FleetSteps(cfg, self.device)
        self.state: FleetState | None = None
        self.n_slots = 0
        self.capacity = 0  # resident rows (pow2; >= n_slots)
        self._pending: list[_Job] = []
        self._pending_slots: set = set()
        self._erb_cache: OrderedDict[tuple[str, int], torch.Tensor] = OrderedDict()
        self._erb_cache_nbytes = 0
        # flush statistics
        self.n_flushes = 0
        self.n_steps_trained = 0
        self.n_chunk_steps = 0
        self.flush_sizes: list[int] = []

    # -- slots ---------------------------------------------------------------
    def add_slot(self, seed: int) -> int:
        slot = self.n_slots
        fresh = self.steps.init_slot(seed)
        if slot < self.capacity:
            # reuse a dead row: live rows are untouched, so jobs already
            # queued for other slots keep batching (no flush)
            at = torch.tensor([slot], device=self.device)
            self.state = self.state.map(lambda s, v: s.index_copy(0, at, v), fresh)
        else:
            if self.state is not None:
                self.flush()  # resident axis grows: retire pending jobs first
            new_cap = _pow2(slot + 1)
            # the dead tail holds copies of the fresh slot: inert rows
            tail = fresh.map(lambda v: v.expand(new_cap - slot, *v.shape[1:]))
            if self.state is None:
                self.state = tail.map(torch.clone)
            else:
                self.state = self.state.map(lambda s, t: torch.cat([s, t]), tail)
            self.capacity = new_cap
        self.n_slots = slot + 1
        return slot

    # -- state access (flush-on-read/write) -----------------------------------
    def ensure_flushed(self, slot: int) -> None:
        """Flush all pending jobs iff ``slot`` has one."""
        if slot in self._pending_slots:
            self.flush()

    def _slot_tree(self, tree, slot: int):
        return tree_map(lambda x: x[slot], tree)

    def get_params(self, slot: int) -> dict:
        self.ensure_flushed(slot)
        return self._slot_tree(self.state.params, slot)

    def get_target(self, slot: int) -> dict:
        self.ensure_flushed(slot)
        return self._slot_tree(self.state.target, slot)

    def slot_params(self, slots: Sequence[int]) -> dict:
        """Stacked params of ``slots``, flushing only the touched slots'
        pending work.  When the cohort covers every resident row in
        order, the resident tensors are returned."""
        for s in set(slots):
            self.ensure_flushed(s)
        if list(slots) == list(range(self.capacity)):
            return self.state.params
        g = torch.tensor(list(slots), device=self.device)
        return tree_map(lambda x: x.index_select(0, g), self.state.params)

    def _set_field(self, slot: int, field: str, value: dict) -> None:
        self.ensure_flushed(slot)
        at = torch.tensor([slot], device=self.device)
        updated = tree_map(
            lambda s, v: s.index_copy(0, at, v.to(s.device, s.dtype)[None]),
            getattr(self.state, field),
            value,
        )
        self.state = replace(self.state, **{field: updated})

    def set_params(self, slot: int, params: dict) -> None:
        self._set_field(slot, "params", params)

    def set_target(self, slot: int, target: dict) -> None:
        self._set_field(slot, "target", target)

    # -- replay pool ----------------------------------------------------------
    def _flat_erb(self, erb: ERB) -> torch.Tensor:
        """Device-resident [size, F] matrix of an ERB (LRU-cached; keyed
        by (erb_id, version) so host-side ring appends invalidate; bounded
        by entry count *and* total bytes)."""
        key = (erb.meta.erb_id, erb.version)
        hit = self._erb_cache.get(key)
        if hit is not None:
            self._erb_cache.move_to_end(key)
            return hit
        flat = torch.from_numpy(erb_flatten(erb)).to(self.device)
        self._erb_cache[key] = flat
        self._erb_cache_nbytes += flat.numel() * flat.element_size()
        while len(self._erb_cache) > 1 and (
            len(self._erb_cache) > ERB_CACHE_SIZE
            or self._erb_cache_nbytes > ERB_CACHE_BYTES
        ):
            _, evicted = self._erb_cache.popitem(last=False)
            self._erb_cache_nbytes -= evicted.numel() * evicted.element_size()
        return flat

    # -- job queue ------------------------------------------------------------
    def submit(self, slot: int, plans: Sequence) -> TrainFuture:
        """Queue one job: K minibatch :class:`~repro_torch.core.replay.ReplayPlan`s
        for ``slot``. Returns a future resolving to the last-step loss."""
        if slot in self._pending_slots:
            self.flush()  # one in-flight round per slot
        future = TrainFuture()
        n_steps = len(plans)
        if n_steps == 0:
            future.resolve(0.0)
            return future
        batch = plans[0].batch_size
        erbs: list[ERB] = []
        positions: dict[str, int] = {}
        eidx = np.empty((n_steps, batch), np.int32)
        rows = np.empty((n_steps, batch), np.int32)
        for k, plan in enumerate(plans):
            e_parts, r_parts = [], []
            for erb, ridx in plan.picks:
                pos = positions.get(erb.meta.erb_id)
                if pos is None:
                    pos = len(erbs)
                    positions[erb.meta.erb_id] = pos
                    erbs.append(erb)
                e_parts.append(np.full(len(ridx), pos, np.int32))
                r_parts.append(np.asarray(ridx, np.int32))
            # permuting indices before the gather == permuting rows after
            eidx[k] = np.concatenate(e_parts)[plan.perm]
            rows[k] = np.concatenate(r_parts)[plan.perm]
        self._pending.append(_Job(slot, n_steps, erbs, eidx, rows, future))
        self._pending_slots.add(slot)
        return future

    def flush(self) -> None:
        """Train every pending job (one stacked chunk per distinct K)."""
        if not self._pending:
            return
        jobs, self._pending = self._pending, []
        self._pending_slots = set()
        # chunk consecutive jobs of equal K so futures resolve in
        # submission order (one K per ADFLL run; mixed only in tests)
        i = 0
        while i < len(jobs):
            j = i + 1
            while j < len(jobs) and jobs[j].n_steps == jobs[i].n_steps:
                j += 1
            self._flush_group(jobs[i:j])
            i = j

    def _flush_group(self, jobs: list[_Job]) -> None:
        n_jobs = len(jobs)
        k_steps = jobs[0].n_steps
        batch = jobs[0].eidx.shape[1]
        # one shared device pool: the union of every job's ERBs
        offsets: dict[str, int] = {}
        parts: list[torch.Tensor] = []
        total = 0
        for job in jobs:
            for erb in job.erbs:
                if erb.meta.erb_id not in offsets:
                    offsets[erb.meta.erb_id] = total
                    total += erb.size
                    parts.append(self._flat_erb(erb))
        pool = parts[0] if len(parts) == 1 else torch.cat(parts)
        slots = [job.slot for job in jobs]
        # resident fast path: the jobs cover every resident row in order,
        # so the resident state IS the chunk operand
        resident = slots == list(range(self.capacity))
        idx = np.empty((k_steps, n_jobs, batch), np.int32)
        for jpos, job in enumerate(jobs):
            base = np.array([offsets[e.meta.erb_id] for e in job.erbs], np.int32)
            idx[:, jpos, :] = base[job.eidx] + job.rows
        # the kernel does not bound-check: the index range is checked
        # here, on the host, before the transfer
        if idx.min() < 0 or idx.max() >= total:
            raise IndexError(f"replay row index out of range [0, {total})")
        if resident:
            sub = self.state
        else:
            g = torch.tensor(slots, device=self.device)
            sub = self.state.map(lambda x: x.index_select(0, g))
        new, losses = self.steps.train_chunk(
            sub, pool, torch.from_numpy(idx).to(self.device)
        )
        if resident:
            self.state = new
        else:
            self.state = self.state.map(lambda s, ns: s.index_copy(0, g, ns), new)
        losses_np = losses.cpu().numpy()  # the flush's one host sync
        self.n_flushes += 1
        self.n_steps_trained += n_jobs * k_steps
        self.n_chunk_steps += k_steps
        self.flush_sizes.append(n_jobs)
        for jpos, job in enumerate(jobs):
            job.future.resolve(float(losses_np[-1, jpos]))


__all__ = [
    "CollectSteps",
    "FleetEngine",
    "FleetState",
    "FleetSteps",
    "TrainFuture",
    "collect_fleet",
    "make_dqn_opt_cfg",
    "tree_map",
]
