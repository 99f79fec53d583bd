"""Selective experience replay — the lifelong-learning mechanism (A.2).

During training an agent samples each minibatch from three pools:
  (1) the ERB of its *current* task,
  (2) its *personal* past-task ERBs,
  (3) *incoming* ERBs received from the network (other agents' experience).
Mixing (2) and (3) into every update is what prevents catastrophic
forgetting and what federates learning without sharing weights.

The sampler is split into *selection* (:meth:`SelectiveReplaySampler.plan`
— pure host-side index math) and *materialization* (gathering the rows).
The classic host path does both; the fleet engine takes only the plan and
gathers the rows on the device from resident ERB buffers with the
hand-written ``replay_gather`` CUDA kernel. Both paths consume the
``rng`` stream in exactly the same order, so they select bit-identical
batches.
"""

from __future__ import annotations

from collections.abc import Sequence
from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.erb import ERB, erb_sample_indices, erb_take, stack_batches


@dataclass(frozen=True)
class ReplayPlan:
    """One minibatch worth of selection: ordered per-ERB row picks plus
    the final in-batch shuffle. ``picks`` concatenated in order (before
    ``perm``) spell out the batch exactly as the host path stacks it."""

    picks: tuple[tuple[ERB, np.ndarray], ...]  # (erb, local row indices)
    perm: np.ndarray = field(repr=False)  # [batch_size] final shuffle

    @property
    def batch_size(self) -> int:
        return len(self.perm)


@dataclass
class SelectiveReplaySampler:
    """mix = (current, personal, incoming) fractions; renormalized over
    non-empty pools."""

    mix: Sequence[float] = (0.5, 0.25, 0.25)

    def plan(
        self,
        rng: np.random.Generator,
        batch_size: int,
        current: ERB | None,
        personal: Sequence[ERB] = (),
        incoming: Sequence[ERB] = (),
    ) -> ReplayPlan:
        """Select which rows make up the next minibatch without touching
        the experience data itself."""
        pools: list[list[ERB]] = [
            [e for e in ([current] if current is not None else []) if len(e) > 0],
            [e for e in personal if len(e) > 0],
            [e for e in incoming if len(e) > 0],
        ]
        weights = np.array(
            [m if pool else 0.0 for m, pool in zip(self.mix, pools, strict=True)],
            np.float64,
        )
        if weights.sum() == 0:
            raise ValueError("all replay pools are empty")
        weights = weights / weights.sum()
        counts = np.floor(weights * batch_size).astype(int)
        counts[int(np.argmax(weights))] += batch_size - counts.sum()

        picks: list[tuple[ERB, np.ndarray]] = []
        for pool, n in zip(pools, counts, strict=True):
            if n == 0 or not pool:
                continue
            # spread n over the ERBs in this pool, uniformly per-ERB
            per = np.bincount(rng.integers(0, len(pool), size=n), minlength=len(pool))
            for erb, m in zip(pool, per, strict=True):
                if m > 0:
                    picks.append((erb, erb_sample_indices(erb, rng, int(m))))
        perm = rng.permutation(batch_size)
        return ReplayPlan(picks=tuple(picks), perm=perm)

    def sample(
        self,
        rng: np.random.Generator,
        batch_size: int,
        current: ERB | None,
        personal: Sequence[ERB] = (),
        incoming: Sequence[ERB] = (),
    ) -> dict[str, np.ndarray]:
        plan = self.plan(rng, batch_size, current, personal=personal, incoming=incoming)
        return self.materialize(plan)

    def materialize(self, plan: ReplayPlan) -> dict[str, np.ndarray]:
        """Host-side row gather of a plan (the classic path)."""
        batches = [erb_take(erb, idx) for erb, idx in plan.picks]
        batch = stack_batches(batches)
        return {k: v[plan.perm] for k, v in batch.items()}
