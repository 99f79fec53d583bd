"""Request plane: what a caller submits and how it waits (a copy of the
reference's ``repro/serve/queue.py``).

A :class:`ServeRequest` is one localization query — a volume, a start
voxel, and which fleet agent should answer. The service wraps each in a
:class:`_Ticket` carrying the per-rollout host state (environment view,
pinned param version slot, visited-voxel cycle detector) and parks it in
a :class:`RequestQueue` until a batch slot frees up.

Requests know nothing about landmarks: termination is greedy-rollout
oscillation (the next move revisits a voxel the rollout has already
occupied — the classic landmark-localization stopping rule) or the step
budget. ``landmark`` is optional ground truth used only for accuracy
reporting on synthetic traffic.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np

from repro_torch.configs.adfll_dqn import DQNConfig
from repro_torch.rl.env import LandmarkEnv

_NO_LANDMARK = np.zeros(3, np.float32)


@dataclass
class ServeRequest:
    """One localization query against the served fleet."""

    volume: np.ndarray  # [n,n,n] f32
    start: np.ndarray  # [3] int voxel
    agent_id: int = 0  # which fleet slot answers
    max_steps: int | None = None  # None -> cfg.max_episode_steps
    landmark: np.ndarray | None = None  # ground truth (reporting only)


@dataclass
class ServeResult:
    """Resolution of one request (also recorded in the ServeReport)."""

    request_id: int
    final_loc: np.ndarray  # [3] int voxel
    version: int  # param version of the whole rollout
    n_ticks: int
    dist_err: float | None = None


class _Ticket:
    """Host-side rollout state of one admitted (or queued) request."""

    __slots__ = (
        "request_id",
        "request",
        "env",
        "loc",
        "visited",
        "n_ticks",
        "vslot",
        "version",
        "max_steps",
        "submitted_at",
        "admitted_at",
        "result",
    )

    def __init__(self, request_id: int, request: ServeRequest, cfg: DQNConfig):
        self.request_id = request_id
        self.request = request
        # LandmarkEnv doubles as the observation view; the dummy landmark
        # is never read (serving uses observe/norm_loc only).
        self.env = LandmarkEnv(request.volume, _NO_LANDMARK, cfg)
        self.loc = np.asarray(request.start, np.int32).copy()
        self.visited = {tuple(int(v) for v in self.loc)}
        self.n_ticks = 0
        self.vslot: int = -1  # version ring slot pinned at admission
        self.version: int = -1  # ... and its monotonic version number
        self.max_steps = (
            request.max_steps
            if request.max_steps is not None
            else cfg.max_episode_steps
        )
        self.submitted_at = time.perf_counter()
        self.admitted_at: float = 0.0
        self.result: ServeResult | None = None

    def advance(self, new_loc: np.ndarray) -> bool:
        """Record one greedy move; True when the rollout terminated
        (oscillation back onto a visited voxel, or the step budget)."""
        self.n_ticks += 1
        key = tuple(int(v) for v in new_loc)
        if key in self.visited or self.n_ticks >= self.max_steps:
            self.loc = np.asarray(new_loc, np.int32)
            return True
        self.visited.add(key)
        self.loc = np.asarray(new_loc, np.int32)
        return False

    def dist_err(self) -> float | None:
        lm = self.request.landmark
        if lm is None:
            return None
        return float(np.linalg.norm(self.loc.astype(np.float32) - lm))


@dataclass
class RequestQueue:
    """FIFO admission queue with arrival-time gating.

    ``push`` accepts a ticket with an optional ``not_before`` wall-clock
    time (open-loop synthetic traffic schedules arrivals ahead of time);
    ``pop_ready`` releases tickets in submission order, never jumping a
    not-yet-arrived head (FIFO is part of the determinism contract).
    """

    _items: deque = field(default_factory=deque)

    def push(self, ticket: _Ticket, not_before: float = 0.0) -> None:
        self._items.append((not_before, ticket))

    def pop_ready(self, now: float) -> _Ticket | None:
        if not self._items:
            return None
        not_before, ticket = self._items[0]
        if not_before > now:
            return None
        self._items.popleft()
        return ticket

    def __len__(self) -> int:
        return len(self._items)


__all__ = ["RequestQueue", "ServeRequest", "ServeResult"]
