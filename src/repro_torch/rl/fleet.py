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
  ``fused_td`` kernel, which computes the whole TD tail (action select,
  TD target, Huber loss, per-agent mean and its gradient) of all agents
  in one launch from the stacked Q-values and the gathered rows,
  backpropagates, applies the stacked AdamW and syncs each slot's target
  on its own count.  The reference ``lax.scan``s the steps and ``vmap``s
  the agents; here the steps are a Python loop and the agent axis is a
  batch dimension.  :meth:`~FleetSteps.train_chunk_stats` is the same
  loop carrying the fleet observatory's statistics: ``fused_td`` writes
  each step's ``td_abs`` and ``q_max`` from its one launch, and the
  chunk packs them with the losses, the gradient norms and a
  params-finite flag into one tensor, so the flush still makes one
  host transfer.
* :class:`CollectSteps` / :func:`collect_fleet` — the collection phase:
  one stacked q-value forward per environment step for a cohort (one
  per shard on a mesh), with epsilon-greedy sampling on the host
  consuming each agent's own rng in the reference order.
* :class:`FleetEngine` — the host-side orchestrator: slots in a pow2
  capacity with inert dead rows, a lazy job queue, flush-on-read, the
  ``(erb_id, version)``-keyed LRU cache of flattened ERBs on each device
  with a byte budget per device, the resident fast path, and futures
  that resolve in submission order.  :meth:`FleetEngine.train_step` is
  the stepwise backend's one-step dispatch on the same state and cache.
  With an observatory attached, flushes run the stats chunk and drain it
  into the observatory at the flush's one host sync; with enabled
  telemetry they record the flush span and counters.
* :class:`ActSteps` / :func:`make_act_steps` — the serving plane's
  batched greedy-act program: each request gathers its own parameter
  row and the batch runs as one stacked forward.

Enabled telemetry on the engine (``FleetEngine.telemetry``) traces the
host loop as nested wall spans on the ``fleet`` track:
``fleet.collect`` (one a :func:`collect_fleet` call: ``agents``,
``env_steps``, ``rows``, and ``syncs`` and ``sync_s``, its environment
steps' blocking copies and their seconds), ``fleet.plan`` (one a
``DQNAgent._submit_steps``: ``steps``), ``fleet.flush`` (``jobs``,
``k_steps``, ``devices``, and ``graph``: how its chunks ran, below) and
``fleet.sync`` around every other
blocking host<->device copy: a cohort's gather index and a flush's
copies (``dir`` ``h2d`` or ``d2h``, ``bytes``).  A flush forced by a
read nests in the span that read.  With telemetry off each span site
costs one attribute check.

Fleet-axis sharding: given a 1-D device mesh
(:func:`repro_torch.models.sharding.make_fleet_mesh`, or a
:class:`~repro_torch.models.sharding.FleetMesh` built by hand), the
engine partitions the stacked agent axis across the mesh's devices, slot
``i`` on ``devices[i % n]`` (:class:`~repro_torch.models.sharding.FleetSharding`).
Each shard is a :class:`FleetState` of its own on its device.  A flush
runs the single-device chunk once per shard that has jobs, on that
shard's rows, that device's copy of the replay pool (the reference's
replicated pool) and the shard's slice of the index tensor: per stacked
step, ``replay_gather`` and ``fused_td`` launch once per such shard, on
its device.  Nothing crosses shards inside a chunk, as in the reference.
The shards' losses (and statistics) meet on the mesh's first device and
come to the host in one copy.  A mesh may repeat a device, which runs
every part of this path on one card (or on the CPU); copies between
cards and overlap across them need a host with several.

CUDA graphs: a flush's chunk is a fixed chain of a few hundred small
launches a stacked step, at shapes that recur from flush to flush, and
on the card its host dispatch, not the device, sets the pace.  So the
engine replays it, recorded by :mod:`repro_torch.kernels.graphs` into
a memory pool the engine keeps a device.  A chunk's key is what the
engine observes in its operands: its shape (device, rows N, steps K,
batch B, statistics on or off) and the row capacity of the device's
replay pool.  The first chunk of a shape runs eagerly (it warms cuDNN's
algorithm choice, the allocator and the kernel library); the second is
warmed up and captured; every later chunk of the key replays it.  Other
device types never capture.  A captured chunk reads fixed addresses: the
replay pool is one buffer per device whose row capacity is a power of
two, reallocated with room for four times the rows when the pool
outgrows it (the union of a flush's ERBs grows as ERBs are shared),
which is a new key for every shape, so each shape's next chunk captures
again, with no second warm-up, and replays its new graph for its result;
the index goes into a static ``[K, N, B]`` buffer, the chunk's state
into static tensors, and the outputs are copied out after the replay.
The work inside is the eager chunk's, launch for launch, and so are the
kernels' launch counts.  ``n_graph_captures`` and ``n_graph_replays``
count chunks; with enabled telemetry so do ``fleet.graph.captures`` and
``fleet.graph.replays``, and a flush span's ``graph`` is ``"eager"``
where some chunk ran eagerly, else ``"capture"`` where one was captured,
else ``"replay"``.

State updates are functional (new tensors, never writes into the
resident ones), so a tensor handed out by ``get_params`` or
``stacked_params`` stays a valid snapshot.
"""

from __future__ import annotations

import functools
import time
from collections import OrderedDict
from collections.abc import Callable, Sequence
from dataclasses import dataclass, fields, replace

import numpy as np
import torch

from repro_torch.configs.adfll_dqn import DQNConfig
from repro_torch.core.erb import ERB, erb_add, erb_flatten, flat_columns, flat_width
from repro_torch.device import resolve_device
from repro_torch.kernels import graphs
from repro_torch.kernels.fused_td import td_loss
from repro_torch.kernels.replay_gather import replay_gather
from repro_torch.models.sharding import FleetMesh, FleetSharding
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update, leaves
from repro_torch.rl.dqn import dqn_apply_stacked, dqn_init
from repro_torch.telemetry import NO_SPAN, NULL


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
    ``train_chunk_stats`` returns the same state with the statistics
    packed beside the losses (:func:`unpack_stats`).
    """

    def __init__(self, cfg: DQNConfig, device: str | torch.device | None = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.opt_cfg = make_dqn_opt_cfg(cfg)
        self.box = tuple(cfg.box_size)
        self.feat = flat_width(self.box)
        self.columns = flat_columns(self.box)
        # where the TD tail reads action, reward and done in a row
        self.td_cols = tuple(
            self.columns[k].start for k in ("action", "reward", "done")
        )

    def split_rows(self, rows: torch.Tensor) -> dict[str, torch.Tensor]:
        """[N, B, F] flat rows -> the DQN inputs ``obs``, ``loc``,
        ``next_obs``, ``next_loc`` (``FLAT_FIELDS`` column order); the TD
        tail reads ``action``, ``reward`` and ``done`` from the rows."""
        n, b, _ = rows.shape
        out = {}
        for key in ("obs", "loc", "next_obs", "next_loc"):
            v = rows[:, :, self.columns[key]]
            if key.endswith("obs"):
                out[key] = v.reshape(n, b, *self.box)
            else:
                out[key] = v.contiguous()
        return out

    def loss(
        self, params: dict, target: dict, batch: dict, rows: torch.Tensor, stats=None
    ):
        """Per-slot mean TD loss ``[N]`` (``fleet.py::make_dqn_loss_fn``
        over the agent axis) of the ``[N, B, F]`` rows split into
        ``batch``; the TD tail is one ``fused_td`` launch for all agents.
        With ``stats`` (the ``td_abs``, ``q_max`` [N] tensors that launch
        writes), ``(loss, td_abs, q_max)``."""
        cfg = self.cfg
        q = dqn_apply_stacked(cfg, params, batch["obs"], batch["loc"])
        with torch.no_grad():
            q_next = dqn_apply_stacked(
                cfg, target, batch["next_obs"], batch["next_loc"]
            )
        return td_loss(q, q_next, rows, self.td_cols, cfg.gamma, stats)

    def _step(self, state: FleetState, rows: torch.Tensor, stats):
        """One train step; returns the new state, the losses ``[N]`` and
        each slot's gradient norm ``[N]`` (the one AdamW clips by)."""
        batch = self.split_rows(rows)
        names = [(k, n) for k in state.params for n in state.params[k]]
        live = tree_map(lambda t: t.detach().requires_grad_(True), state.params)
        with torch.enable_grad():
            out = self.loss(live, state.target, batch, rows, stats)
            losses = out if stats is None else out[0]
            # agents share no parameters: the gradient of the sum is each
            # agent's own gradient of its own mean loss
            flat = torch.autograd.grad(losses.sum(), [live[k][n] for k, n in names])
        grads: dict = {k: {} for k in state.params}
        for (k, n), g in zip(names, flat, strict=True):
            grads[k][n] = g
        with torch.no_grad():
            params, opt, gnorm = adamw_update(
                self.opt_cfg, state.params, grads, state.opt
            )
            count = state.count + 1
            sync = (count % self.cfg.target_update) == 0
            target = tree_map(
                lambda t, p: torch.where(_per_slot(sync, p), p, t), state.target, params
            )
        return FleetState(params, target, opt, count), losses.detach(), gnorm

    def step(self, state: FleetState, rows: torch.Tensor):
        """One train step of every slot on its ``[B, F]`` rows ``[N, B, F]``."""
        state, losses, _ = self._step(state, rows, None)
        return state, losses

    def train_chunk(self, state: FleetState, pool: torch.Tensor, idx: torch.Tensor):
        k_steps, n, b = idx.shape
        ones = torch.ones(n * b, dtype=torch.float32, device=pool.device)
        losses = []
        for k in range(k_steps):
            rows = replay_gather(pool, idx[k].reshape(-1), ones)
            state, loss = self.step(state, rows.reshape(n, b, self.feat))
            losses.append(loss)
        return state, torch.stack(losses)

    def train_chunk_stats(
        self, state: FleetState, pool: torch.Tensor, idx: torch.Tensor
    ):
        """:meth:`train_chunk` with the observatory's statistics (the
        reference's ``train_chunk_stats``): the same launches and the same
        state bit for bit, and instead of the losses one float32
        ``[4K + 1, N]`` tensor, read with :func:`unpack_stats`.  Step k's
        ``fused_td`` launch writes its ``td_abs`` and ``q_max`` straight
        into rows ``K + k`` and ``2K + k``; the loss goes to row ``k``,
        the gradient norm to ``3K + k``, and the last row is 1 where every
        parameter of the slot is finite after the chunk."""
        k_steps, n, b = idx.shape
        ones = torch.ones(n * b, dtype=torch.float32, device=pool.device)
        packed = torch.empty(
            4 * k_steps + 1, n, dtype=torch.float32, device=pool.device
        )
        for k in range(k_steps):
            rows = replay_gather(pool, idx[k].reshape(-1), ones)
            stats = (packed[k_steps + k], packed[2 * k_steps + k])
            state, loss, gnorm = self._step(state, rows.reshape(n, b, self.feat), stats)
            packed[k].copy_(loss)
            packed[3 * k_steps + k].copy_(gnorm)
        flat = torch.cat([x.reshape(n, -1) for x in leaves(state.params)], 1)
        packed[4 * k_steps].copy_(torch.isfinite(flat).all(1))
        return state, packed

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


def unpack_stats(packed: np.ndarray, k_steps: int) -> dict[str, np.ndarray]:
    """The host copy of :meth:`FleetSteps.train_chunk_stats`' tensor as
    the reference's stats dict: ``loss``, ``td_abs``, ``q_max`` and
    ``grad_norm`` ``[K, N]``, ``params_finite`` ``[N]`` bool."""
    k = k_steps
    return {
        "loss": packed[:k],
        "td_abs": packed[k : 2 * k],
        "q_max": packed[2 * k : 3 * k],
        "grad_norm": packed[3 * k : 4 * k],
        "params_finite": packed[4 * k] > 0.5,
    }


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


def _sync_span(tel, direction: str, nbytes: int):
    """A ``fleet.sync`` wall span around one blocking host<->device copy
    (it waits for every operation queued before it)."""
    return tel.wall_span("fleet.sync", "fleet", dir=direction, bytes=int(nbytes))


def collect_fleet(agents, envs, erbs, n_episodes: int) -> None:
    """Collect one round of experience for a cohort of fleet agents:
    one stacked q-value forward per environment step for the cohort, or
    on a mesh one per shard that holds cohort agents, on its device.

    ``agents[i]`` rolls ``n_episodes`` episodes in ``envs[i]``, appending
    transitions to ``erbs[i]``.  Every epsilon-greedy draw
    (``start_locs``, action integers, exploration coins) comes from that
    agent's own ``np.random.Generator`` in the reference's order; agents
    whose episodes all finish early stop consuming their rng and stop
    writing their ERB.  The shards' q-values meet on the engine's first
    device and come to the host in one copy a step.
    """
    if not agents:
        return
    tel = agents[0].engine.telemetry
    if not tel.enabled:
        _collect(agents, envs, erbs, n_episodes, tel)
        return
    with tel.wall_span("fleet.collect", "fleet", agents=len(agents)) as span:
        env_steps, rows, syncs, sync_s = _collect(agents, envs, erbs, n_episodes, tel)
        span["args"].update(env_steps=env_steps, rows=rows, syncs=syncs, sync_s=sync_s)


def _collect(agents, envs, erbs, n_episodes: int, tel) -> tuple[int, int, int, float]:
    """:func:`collect_fleet`'s body; returns the environment steps taken,
    the transitions written, and the blocking copies of the steps (obs
    and loc up a part, q-values down) and their seconds, timed with
    enabled telemetry (a span each would fill the tracer's cap in
    minutes)."""
    traced = tel.enabled
    sync_s = 0.0
    engine = agents[0].engine
    cfg = agents[0].cfg
    steps = CollectSteps(cfg)
    n = len(agents)
    parts = engine.slot_params([a.slot for a in agents])
    box = cfg.box_size
    b = n_episodes
    locs = np.stack([env.start_locs(b, a.rng) for a, env in zip(agents, envs)])
    alive = np.ones((n, b), bool)
    # each part's host staging; lane[i] = (part, row in it) of agent i
    bufs = [
        (
            np.zeros((len(pos), b, *box), np.float32),
            np.zeros((len(pos), b, 3), np.float32),
        )
        for _, pos, _ in parts
    ]
    lane = {}
    offset = 0
    for p, (_, pos, _) in enumerate(parts):
        for r, i in enumerate(pos):
            lane[i] = (p, r, offset + r)
        offset += len(pos)
    env_steps = n_rows = 0
    for _ in range(cfg.max_episode_steps):
        live = [i for i in range(n) if alive[i].any()]
        if not live:
            break
        env_steps += 1
        for i in live:
            p, r, _ = lane[i]
            bufs[p][0][r] = envs[i].observe(locs[i])
            bufs[p][1][r] = envs[i].norm_loc(locs[i])
        qs = []
        for (dev, _, stacked), (obs, loc) in zip(parts, bufs):
            c0 = time.perf_counter() if traced else 0.0
            obs_d = torch.from_numpy(obs).to(dev)
            loc_d = torch.from_numpy(loc).to(dev)
            if traced:
                sync_s += time.perf_counter() - c0
            qs.append(steps.qvals(stacked, obs_d, loc_d))
        if len(qs) == 1:
            q_d = qs[0]
        else:
            home = engine.device
            q_d = torch.cat([x.to(home, non_blocking=True) for x in qs])
        c0 = time.perf_counter() if traced else 0.0
        q = q_d.cpu().numpy()
        if traced:
            sync_s += time.perf_counter() - c0
        for i in live:
            agent, env, erb = agents[i], envs[i], erbs[i]
            p, r, row = lane[i]
            obs_i, loc_i = bufs[p][0][r], bufs[p][1][r]
            eps = agent.epsilon()
            greedy = q[row].argmax(-1)
            rand = agent.rng.integers(0, cfg.n_actions, size=b)
            coin = agent.rng.random(b) < eps
            acts = np.where(coin, rand, greedy).astype(np.int32)
            new, rew, done = env.step(locs[i], acts)
            idx = np.where(alive[i])[0]
            batch = {
                "obs": obs_i[idx],
                "loc": loc_i[idx],
                "action": acts[idx],
                "reward": rew[idx],
                "next_obs": env.observe(new[idx]),
                "next_loc": env.norm_loc(new[idx]),
                "done": done[idx].astype(np.float32),
            }
            erb_add(erb, batch)
            n_rows += len(idx)
            locs[i] = new
            alive[i] &= ~done
    return env_steps, n_rows, env_steps * (2 * len(parts) + 1), sync_s


class ActSteps:
    """The batched greedy-act program of one config on one device.

    ``act(stacked, slot, obs, loc) -> (actions, q)`` where ``stacked``
    is a parameter tree with one leading stacked axis (fleet slots, or
    the serving plane's flattened version x agent ring), ``slot`` the
    per-request ``[B]`` int row into that axis, and ``obs`` / ``loc``
    the ``[B, *box]`` / ``[B, 3]`` observation batch.  Each request
    gathers its own parameter rows (``index_select`` on every leaf) and
    runs as its own agent of one stacked forward (grouped conv3d with
    ``groups=B``, batched matmuls), so what a request computes does not
    depend on the batch it shares a dispatch with: batched serving gives
    single-request serving's results.  A lone request runs as two lanes
    (itself twice): at ``groups=1`` PyTorch takes its ungrouped
    convolution path, which rounds differently from the grouped one (on
    the CPU at ``DQNConfig()``, 3e-7 after the second conv).

    ``n_traces`` counts the first dispatch of each new (batch, stacked
    rows) shape, what a compiled program would be specialised to, so a
    service that pads to pow2 buckets shows no new shapes once its
    buckets are warm.  The program itself is eager: it compiles nothing.
    """

    def __init__(self, cfg: DQNConfig, device: str | torch.device | None = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.n_traces = 0
        self._shapes: set[tuple[int, int]] = set()

    @torch.no_grad()
    def act(
        self, stacked: dict, slot: torch.Tensor, obs: torch.Tensor, loc: torch.Tensor
    ):
        b = obs.shape[0]
        shape = (b, leaves(stacked)[0].shape[0])
        if shape not in self._shapes:
            self._shapes.add(shape)
            self.n_traces += 1
        if b == 1:
            slot, obs, loc = (torch.cat([t, t]) for t in (slot, obs, loc))
        p = tree_map(lambda x: x.index_select(0, slot), stacked)
        q = dqn_apply_stacked(self.cfg, p, obs[:, None], loc[:, None])[:b, 0]
        return q.argmax(-1).to(torch.int32), q

    def warmup(self, stacked: dict, batch_sizes: Sequence[int]) -> None:
        """Dispatch every bucket once (zero-filled inputs; the results
        are discarded)."""
        for b in batch_sizes:
            self.act(
                stacked,
                torch.zeros(b, dtype=torch.int64, device=self.device),
                torch.zeros((b, *self.cfg.box_size), device=self.device),
                torch.zeros((b, 3), device=self.device),
            )
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


_ACT_STEPS_CACHE: dict[tuple[DQNConfig, torch.device], ActSteps] = {}


def make_act_steps(
    cfg: DQNConfig, device: str | torch.device | None = None
) -> ActSteps:
    """The ``(cfg, device)``-keyed act program, shared by every service of
    that config on that device (its bucket shapes stay warm across them)."""
    dev = resolve_device(device)
    steps = _ACT_STEPS_CACHE.get((cfg, dev))
    if steps is None:
        steps = ActSteps(cfg, dev)
        _ACT_STEPS_CACHE[(cfg, dev)] = steps
    return steps


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


@dataclass(eq=False)
class _ChunkGraph:
    """One key's chunk as a CUDA graph: the static operands it reads
    (``state``, ``idx``; the device's replay pool besides) and, once
    captured, the graph, whose outputs are ``(new state, losses)``."""

    state: FleetState
    idx: torch.Tensor
    captured: graphs.Graph | None = None


# bounds of the device cache of flattened ERBs: entries and total bytes
ERB_CACHE_SIZE = 128
ERB_CACHE_BYTES = 256 * 1024**2


class FleetEngine:
    """Host-side orchestrator of one stacked fleet, on one device or
    sharded over a device mesh.

    Slots are added per agent; training rounds are *submitted* as jobs
    (pure index plans — no data moves) and executed lazily: any read or
    write of a slot's state forces a flush, and a flush trains **all**
    pending jobs in one stacked chunk per distinct K (per shard on a
    mesh).  Futures resolve in submission order, so deferred bookkeeping
    (round records) lands in the same order as sequential execution.

    The resident slot axis is padded to a pow2 ``capacity`` (at least
    the mesh's size): rows past ``n_slots`` are *dead* — inert copies
    that are never read and get overwritten when a slot is added, so
    growth does not force a flush while capacity is spare.  With a
    ``mesh`` (:class:`~repro_torch.models.sharding.FleetMesh`), slot
    ``i`` is row ``i // n`` of shard ``i % n`` on ``mesh.devices[i % n]``
    (``self.sharding``), each shard a :class:`FleetState` on its device,
    and ``device`` is the mesh's first device, where the publish
    snapshot and the flush's host copy meet; a mesh of another device
    type than ``device`` is refused.  Without one the engine holds one
    shard on ``device``.  A shard whose flush jobs cover its rows in
    order passes its resident state straight through the chunk (no
    gather in, no scatter out); any other shard with jobs gathers the
    rows of its jobs, and only those, and scatters them back.  Cohorts
    and flushes are not padded; only each device's replay pool is, to a
    power of two of rows, so that its captured chunks keep their key
    while the pool grows (the module's docstring: CUDA graphs).

    ``n_chunk_steps`` counts stacked train steps and ``n_shard_steps``
    the per-shard steps they ran: each of those launches the
    ``replay_gather`` kernel once (the minibatch rows of the shard's
    agents) and the ``fused_td`` kernel once (their TD tail), with the
    observatory on as well as off.  Without a mesh the two are equal.

    The owning system (``ADFLLSystem``, a serving session) replaces
    ``telemetry``, ``sim_clock`` and ``observatory`` after construction;
    the defaults cost nothing.  With an observatory, flushes run
    :meth:`FleetSteps.train_chunk_stats` and hand its drain to
    ``observatory.on_flush`` at the flush's one host sync.
    """

    def __init__(
        self,
        cfg: DQNConfig,
        *,
        device: str | torch.device | None = None,
        mesh: FleetMesh | None = None,
    ):
        self.cfg = cfg
        dev = resolve_device(device)
        if mesh is not None and mesh.devices[0].type != dev.type:
            raise ValueError(
                f"a fleet mesh of {mesh.devices[0].type} devices for a "
                f"{dev.type} caller"
            )
        self.mesh = mesh
        self.sharding = FleetSharding(mesh if mesh is not None else FleetMesh((dev,)))
        self.device = self.sharding.devices[0]
        self.steps = FleetSteps(cfg, self.device)
        self._shards: list[FleetState] | None = None
        self.n_slots = 0
        self.capacity = 0  # resident rows (pow2, >= mesh size; >= n_slots)
        self._pending: list[_Job] = []
        self._pending_slots: set = set()
        # per device: (erb_id, version) -> flat ERB, LRU order; bytes held
        self._erb_cache: dict[torch.device, OrderedDict] = {}
        self._erb_cache_nbytes: dict[torch.device, int] = {}
        # flush statistics
        self.n_flushes = 0
        self.n_steps_trained = 0
        self.n_chunk_steps = 0
        self.n_shard_steps = 0
        self.flush_sizes: list[int] = []
        # per device: the replay pool's buffer, and (erb key, row offset)
        # of each ERB copied into it since it was allocated
        self._pool_bufs: dict[torch.device, torch.Tensor] = {}
        self._pool_held: dict[torch.device, set] = {}
        # CUDA graphs of the chunk: shapes run once, shapes captured once
        # (warmed up), the graphs of the pools' current capacities, and
        # per device their memory pool
        self._graph_shapes: set = set()
        self._graph_warm: set = set()
        self._graphs: dict[tuple, _ChunkGraph] = {}
        self._graph_pools: dict[torch.device, tuple] = {}
        self.n_graph_captures = 0
        self.n_graph_replays = 0
        # observability (observe-only)
        self.telemetry = NULL
        self.sim_clock: Callable[[], float] | None = None
        self.observatory = None

    # -- resident state ---------------------------------------------------------
    @property
    def state(self) -> FleetState | None:
        """Every resident row in slot order: the one shard itself without
        a mesh, else the shards' rows gathered onto ``device`` (a copy)."""
        if self._shards is None or len(self._shards) == 1:
            return None if self._shards is None else self._shards[0]
        gather = self.sharding.gather
        return self._shards[0].map(lambda *xs: gather(xs), *self._shards[1:])

    @state.setter
    def state(self, value: FleetState) -> None:
        take = self.sharding.take
        self._shards = [
            value.map(lambda x, j=j: take(x, j)) for j in range(self.sharding.size)
        ]

    def slot_device(self, slot: int) -> torch.device:
        """The device that holds ``slot``'s state."""
        return self.sharding.device_of(slot)

    def _rows_per_shard(self) -> int:
        return self.capacity // self.sharding.size

    def _locate(self, slot: int) -> tuple[int, int, torch.device]:
        sh = self.sharding
        j = sh.shard_of(slot)
        return j, sh.row_of(slot), sh.devices[j]

    # -- slots ---------------------------------------------------------------
    def add_slot(self, seed: int) -> int:
        slot = self.n_slots
        fresh = self.steps.init_slot(seed)
        if slot < self.capacity:
            # reuse a dead row: live rows are untouched, so jobs already
            # queued for other slots keep batching (no flush)
            j, row, dev = self._locate(slot)
            at = torch.tensor([row], device=dev)
            self._shards[j] = self._shards[j].map(
                lambda s, v: s.index_copy(0, at, v.to(dev)), fresh
            )
        else:
            if self._shards is not None:
                self.flush()  # resident axis grows: retire pending jobs first
            new_cap = max(_pow2(slot + 1), self.sharding.size)
            grow = (new_cap - self.capacity) // self.sharding.size
            # every shard's new rows hold copies of the fresh slot: inert
            # dead rows (the new slot is the first of shard 0's)
            shards = []
            for j, dev in enumerate(self.sharding.devices):
                tail = fresh.map(lambda v, d=dev: v.to(d).expand(grow, *v.shape[1:]))
                if self._shards is None:
                    shards.append(tail.map(torch.clone))
                else:
                    grown = self._shards[j].map(lambda s, t: torch.cat([s, t]), tail)
                    shards.append(grown)
            self._shards = shards
            self.capacity = new_cap
        self.n_slots = slot + 1
        return slot

    # -- state access (flush-on-read/write) -----------------------------------
    def ensure_flushed(self, slot: int) -> None:
        """Flush all pending jobs iff ``slot`` has one."""
        if slot in self._pending_slots:
            self.flush()

    def _slot_field(self, slot: int, field: str):
        self.ensure_flushed(slot)
        j, row, _ = self._locate(slot)
        return tree_map(lambda x: x[row], getattr(self._shards[j], field))

    def get_params(self, slot: int) -> dict:
        return self._slot_field(slot, "params")

    def get_target(self, slot: int) -> dict:
        return self._slot_field(slot, "target")

    def get_opt(self, slot: int) -> dict:
        return self._slot_field(slot, "opt")

    def stacked_params(self) -> dict:
        """Flush-on-read snapshot of every live slot's params as one
        stacked ``[n_slots, ...]`` tree on ``device``: the serving
        plane's publish path (on a mesh, the one gather of the shards a
        publish).  Every pending job trains first, so a snapshot never
        sees a half-applied round; dead padding rows never leak (the
        slice stops at ``n_slots``).  State updates are functional, so
        the snapshot does not change when the engine trains on."""
        self.flush()
        params = self.state.params
        if self.n_slots == self.capacity:
            return params
        return tree_map(lambda x: x[: self.n_slots], params)

    def slot_params(
        self, slots: Sequence[int]
    ) -> list[tuple[torch.device, list[int], dict]]:
        """Stacked params of ``slots`` per shard, flushing only the
        touched slots' pending work: ``(device, positions, tree)`` for
        each shard holding some of them, in shard order, ``positions``
        indexing ``slots`` (one entry without a mesh).  A shard whose
        rows the cohort covers in order hands out its resident
        tensors."""
        for s in set(slots):
            self.ensure_flushed(s)
        tel = self.telemetry
        rows_all = list(range(self._rows_per_shard()))
        out = []
        for j, positions, rows in self.sharding.groups(slots):
            dev = self.sharding.devices[j]
            params = self._shards[j].params
            if rows != rows_all:
                with _sync_span(tel, "h2d", 8 * len(rows)) if tel.enabled else NO_SPAN:
                    g = torch.tensor(rows, device=dev)
                params = tree_map(lambda x: x.index_select(0, g), params)
            out.append((dev, positions, params))
        return out

    def _set_field(self, slot: int, field: str, value: dict) -> None:
        self.ensure_flushed(slot)
        j, row, dev = self._locate(slot)
        at = torch.tensor([row], device=dev)
        shard = self._shards[j]
        updated = tree_map(
            lambda s, v: s.index_copy(0, at, v.to(dev, s.dtype)[None]),
            getattr(shard, field),
            value,
        )
        self._shards[j] = replace(shard, **{field: updated})

    def set_params(self, slot: int, params: dict) -> None:
        self._set_field(slot, "params", params)

    def set_target(self, slot: int, target: dict) -> None:
        self._set_field(slot, "target", target)

    # -- replay pool ----------------------------------------------------------
    def _flat_erb(self, erb: ERB, device: torch.device | None = None) -> torch.Tensor:
        """The [size, F] matrix of an ERB on ``device`` (default: the
        engine's first device).  LRU-cached per device, keyed by
        (erb_id, version) so host-side ring appends invalidate, and
        bounded on each device by entry count *and* total bytes: a pool
        every shard reads costs its bytes on each device, as the
        reference's replicated pool does."""
        dev = self.device if device is None else device
        cache = self._erb_cache.setdefault(dev, OrderedDict())
        key = (erb.meta.erb_id, erb.version)
        hit = cache.get(key)
        if hit is not None:
            cache.move_to_end(key)
            self.telemetry.count("fleet.erb_cache.hits", 1)
            return hit
        tel = self.telemetry
        tel.count("fleet.erb_cache.misses", 1)
        host = erb_flatten(erb)
        with _sync_span(tel, "h2d", host.nbytes) if tel.enabled else NO_SPAN:
            flat = torch.from_numpy(host).to(dev)
        cache[key] = flat
        nbytes = self._erb_cache_nbytes.get(dev, 0) + flat.numel() * flat.element_size()
        while len(cache) > 1 and (
            len(cache) > ERB_CACHE_SIZE or nbytes > ERB_CACHE_BYTES
        ):
            _, evicted = cache.popitem(last=False)
            nbytes -= evicted.numel() * evicted.element_size()
            self.telemetry.count("fleet.erb_cache.evictions", 1)
        self._erb_cache_nbytes[dev] = nbytes
        return flat

    def _fill_pool(
        self, dev: torch.device, erbs: list[ERB], total: int
    ) -> torch.Tensor:
        """The replay pool of a flush on ``dev``: ``erbs`` back to back
        from row 0 of the device's one pool buffer (one copy, as a
        concatenation makes).  When ``total`` outgrows the buffer it is
        reallocated at the power of two of rows that holds four times
        ``total``: the pool is the union of the flush's ERBs, which grows
        as ERBs are shared, and each new buffer is a new key for every
        chunk shape of the device, so its old graphs go and the next
        chunk of each shape captures again (a capture costs the host
        about three eager chunks, so the rows may grow fourfold before
        the next one)."""
        buf = self._pool_bufs.get(dev)
        if buf is None or buf.shape[0] < total:
            feat = self.steps.feat
            buf = torch.empty(_pow2(4 * total), feat, dtype=torch.float32, device=dev)
            self._pool_bufs[dev] = buf
            for key in [k for k in self._graphs if k[0] == dev]:
                del self._graphs[key]
            # the next graphs take a new memory pool: the old one is freed
            # once its graphs are, and capture may not share a dead pool
            self._graph_pools.pop(dev, None)
        torch.cat([self._flat_erb(e, dev) for e in erbs], out=buf[:total])
        return buf

    # -- CUDA graphs of the chunk ---------------------------------------------
    def _graph_mode(self, key: tuple) -> str:
        """How the chunk of ``key`` runs: ``"eager"`` off CUDA and the
        first time its shape (the key less the pool's capacity) runs,
        ``"capture"`` the second time and the first at each new capacity,
        ``"replay"`` once its graph is captured."""
        if key[0].type != "cuda":
            return "eager"
        if key in self._graphs:
            return "replay"
        if key[:-1] in self._graph_shapes:
            return "capture"
        self._graph_shapes.add(key[:-1])
        return "eager"

    def _graph_for(self, key: tuple, shard: FleetState, idx: np.ndarray) -> _ChunkGraph:
        """The captured graph of ``key``, or static operands for one."""
        graph = self._graphs.get(key)
        if graph is None:
            dev, n = key[0], key[1]
            state = shard.map(lambda x: x.new_empty((n, *x.shape[1:])))
            static_idx = torch.empty(idx.shape, dtype=torch.int32, device=dev)
            graph = _ChunkGraph(state, static_idx)
        return graph

    def _capture(
        self, graph: _ChunkGraph, chunk: Callable, pool: torch.Tensor, key: tuple
    ) -> tuple[FleetState, torch.Tensor]:
        """Capture ``chunk`` on the graph's static operands.  A shape's
        first capture warms it up, whose outputs are this chunk's result;
        a shape captured before, at a smaller pool, replays its new graph
        for the result instead (the caller copies the static state out)."""
        dev = pool.device
        if dev not in self._graph_pools:
            self._graph_pools[dev] = torch.cuda.graph_pool_handle()
        warm = key[:-1] in self._graph_warm
        run = functools.partial(chunk, graph.state, pool, graph.idx)
        if not warm:
            new, out = graphs.warm_up(run, dev)
            self._graph_warm.add(key[:-1])
        graph.captured = graphs.capture(run, dev, self._graph_pools[dev])
        self._graphs[key] = graph
        self.n_graph_captures += 1
        self.telemetry.count("fleet.graph.captures", 1)
        if warm:
            return self._launch(graph)
        return new, out

    def _replay(self, graph: _ChunkGraph) -> tuple[FleetState, torch.Tensor]:
        """Replay a captured chunk; returns its static state (the caller
        copies it out) and a copy of its losses or statistics."""
        self.n_graph_replays += 1
        self.telemetry.count("fleet.graph.replays", 1)
        return self._launch(graph)

    @staticmethod
    def _launch(graph: _ChunkGraph) -> tuple[FleetState, torch.Tensor]:
        new, out = graphs.replay(graph.captured)
        return new, out.clone()

    # -- one step now (the stepwise backend) -----------------------------------
    def train_step(self, slot: int, plan) -> float:
        """Train ``slot`` one step on ``plan`` now, in its own dispatch on
        the slot's device: each of the plan's picks is gathered by
        ``replay_gather`` from its ERB's copy there, the plan's shuffle
        is applied, and the slot takes one stacked step at N = 1
        (``fused_td`` for its TD tail).  Returns the step's loss (one
        host sync)."""
        self.ensure_flushed(slot)
        j, row, dev = self._locate(slot)
        parts = []
        for erb, ridx in plan.picks:
            flat = self._flat_erb(erb, dev)
            ridx = np.asarray(ridx, np.int32)
            # the kernel does not bound-check: check on the host first
            if ridx.min() < 0 or ridx.max() >= flat.shape[0]:
                raise IndexError(
                    f"replay row index out of range [0, {flat.shape[0]})"
                )
            idx = torch.from_numpy(ridx).to(dev)
            ones = torch.ones(len(ridx), dtype=torch.float32, device=dev)
            parts.append(replay_gather(flat, idx, ones))
        perm = torch.from_numpy(np.asarray(plan.perm, np.int64)).to(dev)
        rows = torch.cat(parts).index_select(0, perm)
        at = torch.tensor([row], device=dev)
        shard = self._shards[j]
        resident = self._rows_per_shard() == 1
        sub = shard if resident else shard.map(lambda x: x.index_select(0, at))
        new, loss = self.steps.step(sub, rows[None])
        if resident:
            self._shards[j] = new
        else:
            self._shards[j] = shard.map(lambda s, ns: s.index_copy(0, at, ns), new)
        self.n_steps_trained += 1
        return float(loss[0])

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
        tel = self.telemetry
        n_jobs = len(jobs)
        if not tel.enabled:
            losses, _ = self._train_group(jobs)
        else:
            k_steps = jobs[0].n_steps
            with tel.wall_span(
                "fleet.flush",
                "fleet",
                jobs=n_jobs,
                k_steps=k_steps,
                devices=self.sharding.size,
            ) as span:
                losses, mode = self._train_group(jobs)
                span["args"]["graph"] = mode
            if self.sim_clock is not None:
                # the same flush pinned to simulated time, so trace views
                # can correlate host cost with scheduler progress
                tel.instant("fleet.flush", "fleet", self.sim_clock(), jobs=n_jobs)
            tel.count("fleet.flushes", 1)
            tel.count("fleet.steps_trained", n_jobs * k_steps)
            tel.observe("fleet.flush.jobs", n_jobs)
            tel.observe("fleet.flush.wall_s", span["t1"] - span["t0"])
        for jpos, job in enumerate(jobs):
            job.future.resolve(float(losses[-1, jpos]))

    def _train_group(self, jobs: list[_Job]) -> tuple[np.ndarray, str]:
        """Train one group of jobs of equal K as one stacked chunk (per
        shard); returns the host copy of the losses ``[K, jobs]`` and how
        the chunks ran (the flush span's ``graph``)."""
        tel = self.telemetry
        traced = tel.enabled
        n_jobs = len(jobs)
        k_steps = jobs[0].n_steps
        batch = jobs[0].eidx.shape[1]
        # one pool, the union of every job's ERBs, copied to each device
        # that trains some of the jobs
        offsets: dict[str, int] = {}
        erbs: list[ERB] = []
        total = 0
        for job in jobs:
            for erb in job.erbs:
                if erb.meta.erb_id not in offsets:
                    offsets[erb.meta.erb_id] = total
                    total += erb.size
                    erbs.append(erb)
        slots = [job.slot for job in jobs]
        idx = np.empty((k_steps, n_jobs, batch), np.int32)
        for jpos, job in enumerate(jobs):
            base = np.array([offsets[e.meta.erb_id] for e in job.erbs], np.int32)
            idx[:, jpos, :] = base[job.eidx] + job.rows
        # the kernel does not bound-check: the index range is checked
        # here, on the host, before the transfer
        if idx.min() < 0 or idx.max() >= total:
            raise IndexError(f"replay row index out of range [0, {total})")
        obs = self.observatory
        chunk = self.steps.train_chunk if obs is None else self.steps.train_chunk_stats
        rows_all = list(range(self._rows_per_shard()))
        groups = self.sharding.groups(slots)
        pools: dict[torch.device, torch.Tensor] = {}
        outs = []
        modes = set()
        for j, positions, rows in groups:
            dev = self.sharding.devices[j]
            pool = pools.get(dev)
            if pool is None:
                pool = pools[dev] = self._fill_pool(dev, erbs, total)
            shard = self._shards[j]
            # resident fast path: the shard's jobs cover its rows in
            # order, so its resident state IS the chunk operand
            whole = rows == rows_all
            # a lone job on a shard of a mesh trains as two lanes (a copy
            # of itself beside it), as ActSteps serves a lone request: at
            # groups=1 PyTorch takes its ungrouped convolution, which
            # rounds differently from the grouped one the single-device
            # engine runs.  The copy is a second row of the gathered
            # state, so autograd gives each lane its own gradient; only
            # lane 0's state and output columns are kept.
            lone = len(rows) == 1 and self.sharding.size > 1
            rows_g = rows * 2 if lone else rows
            if lone:
                idx_j = np.ascontiguousarray(idx[:, positions * 2])
            elif len(groups) == 1:
                idx_j = idx
            else:
                idx_j = np.ascontiguousarray(idx[:, positions])
            key = (dev, len(rows_g), k_steps, batch, obs is not None, pool.shape[0])
            mode = self._graph_mode(key)
            modes.add(mode)
            graph = None if mode == "eager" else self._graph_for(key, shard, idx_j)
            # the chunk's operands: the resident shard itself or its jobs'
            # rows gathered, and the index; a graph's go into its static
            # tensors
            if whole and not lone:
                if graph is None:
                    sub = shard
                else:
                    sub = graph.state.map(lambda s, x: s.copy_(x), shard)
            else:
                with _sync_span(tel, "h2d", 8 * len(rows_g)) if traced else NO_SPAN:
                    g = torch.tensor(rows_g, device=dev)
                if graph is None:
                    sub = shard.map(lambda x: x.index_select(0, g))
                else:
                    sub = shard.map(
                        lambda x, s: torch.index_select(x, 0, g, out=s), graph.state
                    )
            with _sync_span(tel, "h2d", idx_j.nbytes) if traced else NO_SPAN:
                if graph is None:
                    idx_d = torch.from_numpy(idx_j).to(dev)
                else:
                    idx_d = graph.idx.copy_(torch.from_numpy(idx_j))
            if mode == "replay":
                new, out = self._replay(graph)
            elif mode == "capture":
                new, out = self._capture(graph, chunk, pool, key)
            else:
                new, out = chunk(sub, pool, idx_d)
            # a replay's state is the graph's own, overwritten by its next
            # replay: copied out here (index_copy, a clone) before that
            static = graph is not None and new is graph.captured.outputs[0]
            if lone:
                new = new.map(lambda x: x[:1].clone())
                out = out[:, :1]
                g = g[:1]
                static = False
            if whole:
                self._shards[j] = new.map(torch.clone) if static else new
            else:
                self._shards[j] = shard.map(lambda s, ns: s.index_copy(0, g, ns), new)
            outs.append(out)
        # the flush's one host sync: the losses, and with the observatory
        # the statistics packed beside them, each shard's columns put
        # back in job order
        if len(outs) == 1:
            cols, order = outs[0], None
        else:
            home = self.device
            cols = torch.cat([o.to(home, non_blocking=True) for o in outs], 1)
            order = np.argsort(np.concatenate([pos for _, pos, _ in groups]))
        with _sync_span(tel, "d2h", cols.nbytes) if traced else NO_SPAN:
            host = cols.cpu().numpy()
        if order is not None:
            host = host[:, order]
        if obs is None:
            losses_np = host
        else:
            stats = unpack_stats(host, k_steps)
            losses_np = stats["loss"]
            sim_t = self.sim_clock() if self.sim_clock is not None else 0.0
            obs.on_flush(slots, stats, n_jobs, sim_t)
        self.n_flushes += 1
        self.n_steps_trained += n_jobs * k_steps
        self.n_chunk_steps += k_steps
        self.n_shard_steps += k_steps * len(groups)
        self.flush_sizes.append(n_jobs)
        mode = next(m for m in ("eager", "capture", "replay") if m in modes)
        return losses_np, mode


__all__ = [
    "ActSteps",
    "CollectSteps",
    "FleetEngine",
    "FleetState",
    "FleetSteps",
    "TrainFuture",
    "collect_fleet",
    "make_act_steps",
    "make_dqn_opt_cfg",
    "tree_map",
    "unpack_stats",
]
