"""Synthetic localization traffic: seeded request streams over the
synthetic BraTS-like task volumes (a copy of the reference's
``repro/serve/traffic.py``: the same seed draws the same stream).

A :class:`TrafficSpec` is the frozen, declarative description a
scenario or CLI embeds (how many requests, batching limits,
hot-swap cadence); :func:`synthetic_requests` expands one into concrete
:class:`~repro_torch.serve.queue.ServeRequest` values with known landmarks,
so served accuracy is measurable alongside latency.
"""

from __future__ import annotations

from collections.abc import Sequence
from dataclasses import dataclass

import numpy as np

from repro_torch.configs.adfll_dqn import DQNConfig
from repro_torch.rl.synth import make_volume, paper_eight_tasks
from repro_torch.serve.queue import ServeRequest


@dataclass(frozen=True)
class TrafficSpec:
    """One declarative synthetic-traffic workload."""

    n_requests: int = 64
    max_batch: int = 8  # service admission limit (pow2-bucketed)
    n_version_slots: int = 2  # live param versions the ring can hold
    max_staleness: int = 1  # versions the service may lag the publisher
    max_steps: int | None = None  # per-request budget (None -> cfg)
    rate: float | None = None  # req/s open-loop; None = all at once
    n_tasks: int = 4  # distinct task volumes in the stream
    n_patients: int = 8  # distinct patients per task
    seed: int = 0


def synthetic_requests(
    spec: TrafficSpec,
    cfg: DQNConfig,
    *,
    n_agents: int = 1,
    tasks: Sequence | None = None,
) -> list[ServeRequest]:
    """Expand a spec into a seeded, deterministic request list.

    Requests cycle round-robin over tasks x patients x agents; start
    voxels draw from the same central band the training environments
    use. Landmarks ride along for accuracy reporting only.
    """
    task_list = list(tasks if tasks is not None else paper_eight_tasks())
    task_list = task_list[: spec.n_tasks] or task_list
    rng = np.random.default_rng(spec.seed)
    n = cfg.volume_shape[0]
    lo, hi = n // 4, 3 * n // 4
    out: list[ServeRequest] = []
    for i in range(spec.n_requests):
        task = task_list[i % len(task_list)]
        patient = int(rng.integers(0, spec.n_patients))
        vol, lm = make_volume(task, patient, n=n)
        out.append(
            ServeRequest(
                volume=vol,
                start=rng.integers(lo, hi, size=3).astype(np.int32),
                agent_id=i % n_agents,
                max_steps=spec.max_steps,
                landmark=lm,
            )
        )
    return out


__all__ = ["TrafficSpec", "synthetic_requests"]
