"""Deterministic synthetic data pipelines.

A copy of the reference's ``repro/data/pipeline.py`` (pure numpy, so the
streams are the reference's bit for bit).

Two kinds of streams:
* token streams for the LM zoo (structured synthetic language: enough
  statistical structure that loss decreases, fully deterministic per seed);
* federated task streams: per-agent shards of task-tagged batches, the LM
  analogue of the paper's imaging task-environments, consumable as ERBs by
  the LifelongTrainer.
"""

from __future__ import annotations

from collections.abc import Iterator, Sequence
from dataclasses import dataclass

import numpy as np

from repro_torch.core.erb import ERB, ERBMeta, TaskTag, new_erb_id


@dataclass
class TokenStreamConfig:
    vocab_size: int
    seq_len: int
    batch_size: int
    seed: int = 0
    # markov-ish structure: each "task" has its own transition flavor
    n_styles: int = 4


def _style_tokens(rng, vocab, seq, style):
    """Branching-walk tokens: style shifts the transition kernel so
    different tasks are statistically distinct (forgetting measurable)."""
    base = rng.integers(0, vocab, size=seq)
    walk = np.cumsum(rng.integers(-3 - style, 4 + style, size=seq))
    return (base + walk) % vocab


def token_batches(
    cfg: TokenStreamConfig, style: int = 0
) -> Iterator[dict[str, np.ndarray]]:
    rng = np.random.default_rng(cfg.seed + 7919 * style)
    while True:
        toks = np.stack(
            [
                _style_tokens(rng, cfg.vocab_size, cfg.seq_len + 1, style)
                for _ in range(cfg.batch_size)
            ]
        ).astype(np.int32)
        yield {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def lm_task_erb(
    cfg: TokenStreamConfig,
    style: int,
    n_batches: int,
    *,
    source_agent: int = -1,
    round_idx: int = 0,
) -> ERB:
    """Materialize an LM 'task' as an ERB of (tokens, labels) rows —
    the supervised analogue of the paper's experience tuples."""
    it = token_batches(cfg, style)
    toks, labs = [], []
    for _ in range(n_batches):
        b = next(it)
        toks.append(b["tokens"])
        labs.append(b["labels"])
    data = {"tokens": np.concatenate(toks, 0), "labels": np.concatenate(labs, 0)}
    n = data["tokens"].shape[0]
    task = TaskTag(
        modality=f"style{style}",
        orientation="lm",
        pathology="none",
        landmark="next_token",
    )
    meta = ERBMeta(new_erb_id("LMERB"), task, source_agent, round_idx, n)
    erb = ERB(meta=meta, data=data, capacity=n, size=n, cursor=0)
    return erb


def federated_shards(
    cfg: TokenStreamConfig, n_agents: int
) -> Sequence[Iterator[dict[str, np.ndarray]]]:
    """Disjoint per-agent streams (different seeds + style rotation)."""
    return [
        token_batches(
            TokenStreamConfig(
                cfg.vocab_size,
                cfg.seq_len,
                cfg.batch_size,
                seed=cfg.seed + 104729 * a,
                n_styles=cfg.n_styles,
            ),
            style=a % cfg.n_styles,
        )
        for a in range(n_agents)
    ]
