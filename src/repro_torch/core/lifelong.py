"""LifelongTrainer — model-agnostic ADFLL wrapper.

The paper's replay mixing is model-free: it works for any learner whose
update consumes a batch of numpy arrays.  This wrapper federates *any*
``train_step``: the DQN agents do the same through
``DQNAgent.train_steps``, and any other learner can be lifelong-trained
on a stream of tasks by handing its step function to this class.
"""

from __future__ import annotations

from collections.abc import Callable, Sequence
from dataclasses import dataclass, field
from typing import Any

import numpy as np

from repro_torch.core.erb import ERB
from repro_torch.core.replay import SelectiveReplaySampler


@dataclass
class LifelongTrainer:
    """train_step(state, batch) -> (state, metrics); batches are dicts
    of numpy arrays sampled from ERBs via selective replay."""

    train_step: Callable
    state: Any
    batch_size: int
    mix: Sequence[float] = (0.5, 0.25, 0.25)
    rng: np.random.Generator = field(default_factory=lambda: np.random.default_rng(0))
    personal: list[ERB] = field(default_factory=list)
    seen_erb_ids: set = field(default_factory=set)

    def __post_init__(self):
        self.sampler = SelectiveReplaySampler(mix=self.mix)

    def steps(
        self, n: int, current: ERB | None, incoming: Sequence[ERB] = ()
    ) -> dict[str, float]:
        for e in incoming:
            self.seen_erb_ids.add(e.meta.erb_id)
        metrics: dict[str, float] = {}
        for _ in range(n):
            batch = self.sampler.sample(
                self.rng,
                self.batch_size,
                current,
                personal=self.personal,
                incoming=incoming,
            )
            self.state, m = self.train_step(self.state, batch)
            metrics = {k: float(v) for k, v in m.items()}
        if current is not None:
            self.personal.append(current)
            self.seen_erb_ids.add(current.meta.erb_id)
        return metrics


__all__ = ["LifelongTrainer"]
