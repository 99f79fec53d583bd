"""Experience Replay Buffers (ERBs) — the unit of federation in ADFLL.

An ERB is (a) a fixed-capacity ring buffer of [s, a, r, s', done] tuples
held as a dict of host numpy arrays, and (b) a metadata record (Fig. 7 of the
paper: modality / landmark / pathology tags plus provenance) that hubs use
to index their shared database.

The paper shares experience *data*, never model weights — that is what
makes ADFLL architecture-agnostic. ERBs are therefore self-describing and
model-free.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, replace
from typing import Any

import numpy as np

_ERB_COUNTER = itertools.count()


@dataclass(frozen=True)
class TaskTag:
    """One BraTS task-environment: modality x orientation x pathology."""

    modality: str  # t1 | t1ce | t2 | flair
    orientation: str  # axial | coronal | sagittal
    pathology: str  # HGG | LGG
    landmark: str = "top_left_ventricle"

    @property
    def name(self) -> str:
        return f"{self.orientation}_{self.pathology}_{self.modality}"


@dataclass(frozen=True)
class ERBMeta:
    erb_id: str
    task: TaskTag
    source_agent: int
    round_idx: int
    size: int
    #: observatory-stamped provenance: sorted (agent_id, round_idx) pairs
    #: of the sender's peer-progress view at share time; never read by
    #: the numeric path (default stays empty when telemetry is off).
    version_vector: tuple = ()


def new_erb_id(prefix: str = "ERB") -> str:
    return f"{prefix}_{next(_ERB_COUNTER):05d}"


@dataclass
class ERB:
    """data: dict of arrays with leading dim = capacity; ``size`` filled."""

    meta: ERBMeta
    data: dict[str, Any]
    capacity: int
    size: int = 0
    cursor: int = 0
    version: int = 0  # bumped by erb_add; device-side caches key on it

    def __len__(self) -> int:
        return self.size


def erb_init(
    capacity: int,
    obs_shape: tuple[int, ...],
    *,
    task: TaskTag,
    source_agent: int = -1,
    round_idx: int = 0,
    dtype=np.float32,
) -> ERB:
    data = {
        "obs": np.zeros((capacity, *obs_shape), dtype),
        "loc": np.zeros((capacity, 3), dtype),
        "action": np.zeros((capacity,), np.int32),
        "reward": np.zeros((capacity,), np.float32),
        "next_obs": np.zeros((capacity, *obs_shape), dtype),
        "next_loc": np.zeros((capacity, 3), dtype),
        "done": np.zeros((capacity,), np.float32),
    }
    meta = ERBMeta(new_erb_id(), task, source_agent, round_idx, 0)
    return ERB(meta=meta, data=data, capacity=capacity)


def erb_add(erb: ERB, batch: dict[str, np.ndarray]) -> ERB:
    """Ring-append a batch of experiences (host-side, in place on data)."""
    n = int(batch["action"].shape[0])
    cap = erb.capacity
    idx = (erb.cursor + np.arange(n)) % cap
    for k, v in batch.items():
        erb.data[k][idx] = np.asarray(v)
    size = min(cap, erb.size + n)
    erb.size = size
    erb.cursor = (erb.cursor + n) % cap
    erb.version += 1
    erb.meta = replace(erb.meta, size=size)
    return erb


def erb_sample_indices(erb: ERB, rng: np.random.Generator, n: int) -> np.ndarray:
    """The index-selection half of :func:`erb_sample`: uniformly choose n
    row indices (with replacement iff n > size), consuming ``rng`` exactly
    as ``erb_sample`` does.  The fleet engine uses this to plan batches on
    the host while materializing rows on device."""
    assert erb.size > 0, "sampling an empty ERB"
    replace_ = n > erb.size
    return rng.choice(erb.size, size=n, replace=replace_)


def erb_take(erb: ERB, idx: np.ndarray) -> dict[str, np.ndarray]:
    """Materialize the rows selected by ``idx`` (host gather; the fleet
    engine gathers on the device instead)."""
    return {k: v[idx] for k, v in erb.data.items()}


def erb_sample(erb: ERB, rng: np.random.Generator, n: int) -> dict[str, np.ndarray]:
    """Uniformly sample n experiences (with replacement if n > size)."""
    return erb_take(erb, erb_sample_indices(erb, rng, n))


# -- flat row layout (device-resident replay) --------------------------------
# The fleet engine keeps each ERB on device as one [size, F] float32 matrix
# so a minibatch is a single row gather. Column order is fixed:
FLAT_FIELDS: tuple[str, ...] = (
    "obs",
    "loc",
    "action",
    "reward",
    "next_obs",
    "next_loc",
    "done",
)


def flat_width(obs_shape: tuple[int, ...]) -> int:
    """Row width of the flattened experience layout."""
    obs_f = int(np.prod(obs_shape))
    return 2 * obs_f + 3 + 3 + 3  # obs+next_obs, loc+next_loc, a/r/done


def erb_flatten(erb: ERB) -> np.ndarray:
    """[size, F] float32 view of the filled rows, columns in FLAT_FIELDS
    order (action stored as float32 — exact for small ints)."""
    s = erb.size
    cols = []
    for k in FLAT_FIELDS:
        v = erb.data[k][:s]
        cols.append(v.reshape(s, -1).astype(np.float32, copy=False))
    return np.concatenate(cols, axis=1)


def erb_share_slice(
    erb: ERB, n: int, rng: np.random.Generator, strategy: str = "uniform"
) -> ERB:
    """Selective share: a new ERB holding <=n selected experiences.

    This is the paper's 'resulting experience from the training is shared'
    step; selective experience replay (Rolnick et al.) shares a subset, not
    the raw stream.

    strategy:
      "uniform" — uniform subsample (the paper's implicit choice);
      "reward"  — beyond-paper: surprise-weighted selection, sampling
                  proportional to |reward| + eps (Rolnick et al. found
                  reward-based selection strongest for forgetting).
    """
    n = min(n, erb.size)
    if strategy == "reward":
        w = np.abs(erb.data["reward"][: erb.size]).astype(np.float64) + 1e-3
        p = w / w.sum()
        idx = rng.choice(erb.size, size=n, replace=False, p=p)
    else:
        idx = rng.choice(erb.size, size=n, replace=False)
    data = {k: v[idx].copy() for k, v in erb.data.items()}
    # pad to capacity n exactly (shared ERBs are full by construction)
    meta = ERBMeta(
        new_erb_id(), erb.meta.task, erb.meta.source_agent, erb.meta.round_idx, n
    )
    return ERB(meta=meta, data=data, capacity=n, size=n, cursor=0)


def stack_batches(batches) -> dict[str, np.ndarray]:
    keys = batches[0].keys()
    return {k: np.concatenate([b[k] for b in batches], 0) for k in keys}
