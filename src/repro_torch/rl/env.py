"""3D landmark-localization environment (paper Appendix A.1).

Agent = 3D bounding box; 6 actions (+/- x, y, z); reward = decrease in
Euclidean distance to the target landmark; episode terminates on
proximity or step budget. Vectorized over parallel episodes (numpy host
side; the Q-network forward runs on the device).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.configs.adfll_dqn import DQNConfig

# actions: 0:+x 1:-x 2:+y 3:-y 4:+z 5:-z  (acting on [z,y,x] index order)
_DELTA = np.array(
    [[0, 0, 1], [0, 0, -1], [0, 1, 0], [0, -1, 0], [1, 0, 0], [-1, 0, 0]], np.int32
)


def apply_actions(
    locs: np.ndarray, actions: np.ndarray, n, step_size: int
) -> np.ndarray:
    """Move ``locs`` [B,3] by ``actions`` [B] and clip to the volume.

    The landmark-free half of :meth:`LandmarkEnv.step`. ``n`` is the
    volume side: a scalar, or [B] per-row sides when the batch mixes
    volumes.
    """
    hi = np.asarray(n, np.int32) - 1
    if hi.ndim:
        hi = hi[:, None]
    return np.clip(locs + step_size * _DELTA[actions], 0, hi).astype(np.int32)


@dataclass
class LandmarkEnv:
    volume: np.ndarray  # [n,n,n] f32
    landmark: np.ndarray  # [3] float (zyx)
    cfg: DQNConfig
    # pad-once cache: np.pad of the full volume on *every* observe call
    # dominated the host-side round cost before the batched gather below
    _padded: np.ndarray | None = field(default=None, repr=False, compare=False)

    @property
    def n(self) -> int:
        return self.volume.shape[0]

    def observe(self, locs: np.ndarray) -> np.ndarray:
        """locs [B,3] int -> crops [B, bx,by,bz] centered at locs
        (zero-padded at boundaries). One batched fancy-index gather from
        a cached zero-padded volume — no per-row Python loop."""
        bx, by, bz = self.cfg.box_size
        half = np.array([bx // 2, by // 2, bz // 2])
        pad = max(bx, by, bz)
        if self._padded is None:
            self._padded = np.pad(self.volume, pad)
        c = locs + pad - half  # [B,3] window starts
        iz = c[:, 0, None] + np.arange(bx)  # [B,bx]
        iy = c[:, 1, None] + np.arange(by)  # [B,by]
        ix = c[:, 2, None] + np.arange(bz)  # [B,bz]
        out = self._padded[
            iz[:, :, None, None], iy[:, None, :, None], ix[:, None, None, :]
        ]
        return np.ascontiguousarray(out, dtype=np.float32)

    def norm_loc(self, locs: np.ndarray) -> np.ndarray:
        return locs.astype(np.float32) / (self.n - 1)

    def dist(self, locs: np.ndarray) -> np.ndarray:
        return np.linalg.norm(locs.astype(np.float32) - self.landmark, axis=-1)

    def start_locs(self, batch: int, rng: np.random.Generator) -> np.ndarray:
        lo, hi = self.n // 4, 3 * self.n // 4
        return rng.integers(lo, hi, size=(batch, 3)).astype(np.int32)

    def step(
        self, locs: np.ndarray, actions: np.ndarray
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """-> (new_locs, reward, done)."""
        new = apply_actions(locs, actions, self.n, self.cfg.step_size)
        r = self.dist(locs) - self.dist(new)
        done = self.dist(new) < 1.5
        return new, r.astype(np.float32), done
