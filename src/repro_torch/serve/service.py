"""Continuous-batching localization service over a served fleet.

The serving loop is a sequence of *ticks*. Each tick:

1. **swap** — if the :class:`~repro_torch.serve.publisher.ParamPublisher`
   has a newer version, hot-swap it into a free slot of the version ring
   (in-flight requests keep the slot they pinned at admission); when the
   service would fall more than ``max_staleness`` versions behind and
   the swap is still blocked by in-flight work, admission pauses until
   the ring frees up — the staleness bound.
2. **admit** — pop queued requests into free batch slots (FIFO) up to
   ``max_batch``; each pins the newest installed version.
3. **act** — one batched act program
   (:class:`~repro_torch.rl.fleet.ActSteps`) computes every active
   request's greedy move: observations staged on the host per request
   into a pooled per-bucket buffer set (one allocation per bucket for
   the service's lifetime), the batch padded to the next power-of-two
   bucket so the set of dispatched shapes is fixed after warmup; then
   the tick's one host sync reads the actions back.
4. **retire** — requests that oscillate onto a visited voxel (or exhaust
   their step budget) leave their slot; new requests are admitted into
   the freed slots next tick.

Params live as one flat ``[V*N, ...]`` tree on the service's device
(version-ring slot major, fleet agent minor), owned by the service: a
swap copies the new version into its slot's rows.  A request's program
row is ``vslot * n_agents + agent_id``.  Every request gathers its own
row and runs as its own agent of the stacked forward, so batched
results equal single-request serving's — tested, and the property that
makes continuous batching safe to enable everywhere.

The service runs on ``device`` (``None`` = the CUDA card): its ring and
each tick's batch live there, and a missing card raises.  With enabled
``telemetry`` each request is a span on its agent's wall-clock track,
each tick a span, swaps, deferred swaps and stalls instants, beside
their counters and the latency histograms (observe-only).
"""

from __future__ import annotations

import time
from collections.abc import Sequence

import numpy as np
import torch

from repro_torch.configs.adfll_dqn import DQNConfig
from repro_torch.device import resolve_device
from repro_torch.rl.env import apply_actions
from repro_torch.rl.fleet import _pow2, make_act_steps, tree_map
from repro_torch.serve.publisher import ParamPublisher, ParamVersion
from repro_torch.serve.queue import RequestQueue, ServeRequest, ServeResult, _Ticket
from repro_torch.serve.report import RequestRecord, ServeReport
from repro_torch.telemetry import NULL, Telemetry


class LocalizationService:
    """Front a fleet's params with a request queue and batched ticks."""

    def __init__(
        self,
        cfg: DQNConfig,
        *,
        publisher: ParamPublisher | None = None,
        params: dict | None = None,
        max_batch: int = 16,
        n_version_slots: int = 2,
        max_staleness: int = 0,
        warmup: bool = True,
        telemetry: Telemetry | None = None,
        device: str | torch.device | None = None,
    ):
        self.telemetry = telemetry if telemetry is not None else NULL
        if (publisher is None) == (params is None):
            raise ValueError("exactly one of publisher= or params= is required")
        if publisher is None:
            publisher = ParamPublisher(lambda: params)
        if publisher.latest is None:
            publisher.publish()
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if n_version_slots < 1:
            raise ValueError(f"n_version_slots must be >= 1, got {n_version_slots}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.publisher = publisher
        self.max_batch = int(max_batch)
        self.n_version_slots = int(n_version_slots)
        self.max_staleness = int(max_staleness)
        self.steps = make_act_steps(cfg, self.device)
        pv = publisher.latest
        self.n_agents = pv.n_agents
        # pow2 batch buckets: the shapes the act program sees, fixed after
        # warmup (admission never exceeds max_batch)
        self.buckets: list[int] = []
        b = 1
        while b < self.max_batch:
            self.buckets.append(b)
            b *= 2
        self.buckets.append(_pow2(self.max_batch))
        # version ring as one flat [V*N, ...] tree (slot-major): a swap
        # rewrites one slot's rows, shapes never change
        v = self.n_version_slots
        self._vparams = tree_map(
            lambda x: x.to(self.device).repeat(v, *[1] * (x.dim() - 1)), pv.params
        )
        self._slot_version: list[int | None] = [None] * v
        self._slot_active = [0] * v
        self._newest_slot = 0
        self._slot_version[0] = pv.version
        # pooled host staging: one (obs, norm, slot, locs, vol) buffer set
        # per batch bucket, reused every tick
        self._staging: dict[int, tuple[np.ndarray, ...]] = {}
        # request plane
        self.queue = RequestQueue()
        self.active: list[_Ticket] = []
        self.results: dict[int, ServeResult] = {}
        self._next_request_id = 0
        self.report = ServeReport()
        if warmup:
            self.steps.warmup(self._vparams, self.buckets)
        self.report.act_traces_start = self.steps.n_traces
        self.report.act_traces_end = self.steps.n_traces

    # -- params ------------------------------------------------------------
    @property
    def current_version(self) -> int:
        """Version number new admissions pin."""
        return self._slot_version[self._newest_slot]

    def install(self, pv: ParamVersion) -> bool:
        """Hot-swap a published version into the next ring slot; False
        (deferred) while that slot still serves in-flight requests."""
        if pv.n_agents != self.n_agents:
            raise ValueError(
                f"published fleet has {pv.n_agents} agents, "
                f"service built for {self.n_agents}"
            )
        cur = self.current_version
        if cur is not None and pv.version <= cur:
            return False  # stale or duplicate publish
        target = (self._newest_slot + 1) % self.n_version_slots
        if self._slot_active[target] > 0:
            self.report.n_deferred_swaps += 1
            if self.telemetry.enabled:
                self.telemetry.instant(
                    "serve.swap.deferred",
                    "serve",
                    self.telemetry.wall(),
                    clock="wall",
                    version=pv.version,
                )
                self.telemetry.count("serve.swaps.deferred", 1)
            return False
        n = self.n_agents
        tree_map(
            lambda buf, new: buf[target * n : (target + 1) * n].copy_(new),
            self._vparams,
            pv.params,
        )
        self._slot_version[target] = pv.version
        self._newest_slot = target
        self.report.n_swaps += 1
        if self.telemetry.enabled:
            self.telemetry.instant(
                "serve.swap",
                "serve",
                self.telemetry.wall(),
                clock="wall",
                version=pv.version,
                slot=target,
            )
            self.telemetry.count("serve.swaps", 1)
        return True

    def sync_params(self) -> bool:
        """Pull the publisher's latest version if it is newer (the
        between-ticks hot-swap path). Returns True when a swap landed."""
        latest = self.publisher.latest
        if latest is None or latest.version <= self.current_version:
            return False
        return self.install(latest)

    @property
    def staleness(self) -> int:
        """How many published versions behind the service is serving."""
        return max(0, self.publisher.version - self.current_version)

    def _stage(self, bucket: int) -> tuple[np.ndarray, ...]:
        """The bucket's pooled staging buffers, allocated once per bucket
        for the service's lifetime."""
        hit = self._staging.get(bucket)
        if hit is None:
            hit = (
                np.zeros((bucket, *self.cfg.box_size), np.float32),  # obs
                np.zeros((bucket, 3), np.float32),  # norm_loc
                np.zeros(bucket, np.int64),  # program row (slot)
                np.zeros((bucket, 3), np.int32),  # locs
                np.zeros(bucket, np.int32),  # per-row volume side
            )
            self._staging[bucket] = hit
        return hit

    # -- request plane -----------------------------------------------------
    def submit(self, request: ServeRequest, *, not_before: float = 0.0) -> int:
        """Queue one request; returns its id (results keyed by it)."""
        ticket = _Ticket(self._next_request_id, request, self.cfg)
        self._next_request_id += 1
        self.queue.push(ticket, not_before)
        return ticket.request_id

    def _admit(self, now: float) -> None:
        while len(self.active) < self.max_batch:
            ticket = self.queue.pop_ready(now)
            if ticket is None:
                return
            ticket.vslot = self._newest_slot
            ticket.version = self.current_version
            ticket.admitted_at = now
            self._slot_active[ticket.vslot] += 1
            self.active.append(ticket)

    def _retire(self, ticket: _Ticket, now: float) -> None:
        self._slot_active[ticket.vslot] -= 1
        err = ticket.dist_err()
        result = ServeResult(
            request_id=ticket.request_id,
            final_loc=ticket.loc.copy(),
            version=ticket.version,
            n_ticks=ticket.n_ticks,
            dist_err=err,
        )
        ticket.result = result
        self.results[ticket.request_id] = result
        self.report.requests.append(
            RequestRecord(
                request_id=ticket.request_id,
                agent_id=ticket.request.agent_id,
                version=ticket.version,
                n_ticks=ticket.n_ticks,
                latency_s=now - ticket.submitted_at,
                queued_s=ticket.admitted_at - ticket.submitted_at,
                final_loc=ticket.loc.copy(),
                dist_err=err,
            )
        )
        v = self.report.versions_served
        v[ticket.version] = v.get(ticket.version, 0) + 1
        if self.telemetry.enabled:
            tel = self.telemetry
            # the request's life on its agent's wall-clock track
            tel.span(
                "request",
                f"agent{ticket.request.agent_id}",
                tel.to_wall(ticket.submitted_at),
                tel.to_wall(now),
                clock="wall",
                request_id=ticket.request_id,
                version=ticket.version,
                n_ticks=ticket.n_ticks,
            )
            tel.count("serve.requests.completed", 1)
            tel.observe("serve.latency_s", now - ticket.submitted_at)
            tel.observe("serve.queued_s", ticket.admitted_at - ticket.submitted_at)

    def tick(self) -> int:
        """One serving tick; returns how many requests completed."""
        now = time.perf_counter()
        tel = self.telemetry
        tick_t0 = tel.wall() if tel.enabled else 0.0
        traces0 = self.steps.n_traces
        self.sync_params()
        if self.staleness > self.max_staleness:
            # staleness bound: the swap is blocked by in-flight rollouts
            # on the oldest slot — pause admission until it lands
            self.report.n_stall_ticks += 1
            if tel.enabled:
                tel.instant(
                    "serve.stall",
                    "serve",
                    tel.wall(),
                    clock="wall",
                    staleness=self.staleness,
                )
                tel.count("serve.stall_ticks", 1)
        else:
            self._admit(now)
        self.report.queue_depth.append(len(self.queue))
        if not self.active:
            return 0
        n_active = len(self.active)
        bucket = next(b for b in self.buckets if b >= n_active)
        obs, norm, slot, loc_buf, vol = self._stage(bucket)
        for i, t in enumerate(self.active):
            if not 0 <= t.request.agent_id < self.n_agents:
                raise ValueError(f"agent_id out of range: {t.request.agent_id}")
            slot[i] = t.vslot * self.n_agents + t.request.agent_id
            loc_buf[i] = t.loc
            vol[i] = t.env.n
            obs[i] = t.env.observe(t.loc[None])[0]
            norm[i] = t.env.norm_loc(t.loc)
        if bucket > n_active:  # pad rows (discarded; lanes are independent)
            obs[n_active:] = 0.0
            norm[n_active:] = 0.0
            slot[n_active:] = 0
        locs = loc_buf[:n_active]
        dev = self.device
        actions, _ = self.steps.act(
            self._vparams,
            torch.from_numpy(slot).to(dev),
            torch.from_numpy(obs).to(dev),
            torch.from_numpy(norm).to(dev),
        )
        actions = actions.cpu().numpy()[:n_active]  # the tick's one host sync
        new_locs = apply_actions(locs, actions, vol[:n_active], self.cfg.step_size)
        now = time.perf_counter()
        done = 0
        still_active = []
        for ticket, new_loc in zip(self.active, new_locs, strict=True):
            if ticket.advance(new_loc):
                self._retire(ticket, now)
                done += 1
            else:
                still_active.append(ticket)
        self.active = still_active
        self.report.n_ticks += 1
        self.report.batch_sizes.append(bucket)
        self.report.act_traces_end = self.steps.n_traces
        if tel.enabled:
            tick_t1 = tel.wall()
            # new act shapes this tick (what a compiled program would
            # retrace for; the reference's names)
            compiled = self.steps.n_traces - traces0
            tel.span(
                "serve.tick",
                "serve",
                tick_t0,
                tick_t1,
                clock="wall",
                n_active=n_active,
                bucket=bucket,
                done=done,
                compiled=compiled,
            )
            if compiled:
                tel.instant("serve.compile", "serve", tick_t1, clock="wall")
                tel.count("serve.compiles", compiled)
            tel.count("serve.ticks", 1)
            tel.observe("serve.tick.batch", n_active)
        return done

    def drain(self) -> ServeReport:
        """Tick until the queue and every batch slot are empty."""
        t0 = time.perf_counter()
        while self.queue or self.active:
            if self.tick() == 0 and not self.active:
                time.sleep(1e-4)  # open-loop: head-of-queue not arrived yet
        self.report.wall_time_s += time.perf_counter() - t0
        self.report.act_traces_end = self.steps.n_traces
        return self.report

    def serve(
        self, requests: Sequence[ServeRequest], *, rate: float | None = None
    ) -> ServeReport:
        """Submit a batch of requests and drain the service.

        ``rate`` (requests per second) spaces arrivals open-loop on the
        wall clock; None submits everything at once (closed-loop, the
        deterministic mode tests use).
        """
        t0 = time.perf_counter()
        for i, req in enumerate(requests):
            not_before = 0.0 if rate is None else t0 + i / rate
            self.submit(req, not_before=not_before)
        return self.drain()


__all__ = ["LocalizationService"]
