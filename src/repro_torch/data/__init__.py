"""Synthetic token streams and LM task ERBs (copies of the reference's)."""

from repro_torch.data.pipeline import (
    TokenStreamConfig,
    federated_shards,
    lm_task_erb,
    token_batches,
)

__all__ = ["TokenStreamConfig", "federated_shards", "lm_task_erb", "token_batches"]
