"""A frozen copy of the program's synthetic BraTS-like volumes
(``src/repro_torch/rl/synth.py`` at commit 9a6aff9: ``make_volume`` and
what it calls), so the benchmark's inputs do not move when the program
changes.  A task is a ``(modality, orientation, pathology)`` tuple here,
not the program's ``TaskTag``; the volumes are the same, bit for bit.
"""

from __future__ import annotations

import zlib
from functools import lru_cache

import numpy as np

MODALITIES = ("t1", "t1ce", "t2", "flair")
ORIENTATIONS = ("axial", "coronal", "sagittal")
PATHOLOGIES = ("HGG", "LGG")


def _grid(n: int):
    ax = np.linspace(-1.0, 1.0, n, dtype=np.float32)
    return np.meshgrid(ax, ax, ax, indexing="ij")


@lru_cache(maxsize=512)
def _canonical(patient: int, pathology: str, n: int):
    """Patient anatomy in the canonical axial frame.

    Returns (tissue maps dict, landmark zyx float array)."""
    rng = np.random.default_rng(10_000 + patient)
    z, y, x = _grid(n)

    def jit(s):
        return rng.uniform(-s, s)

    # head: ellipsoid
    head = ((z / 0.95) ** 2 + (y / 0.85) ** 2 + (x / 0.8) ** 2) < 1.0
    # lateral ventricles: two curved slabs around the midline
    vz, vy, vx = jit(0.08), jit(0.08), 0.22 + jit(0.05)
    vent_l = (
        ((z - vz) / 0.32) ** 2 + ((y - vy) / 0.18) ** 2 + ((x + vx) / 0.14) ** 2
    ) < 1.0
    vent_r = (
        ((z - vz) / 0.32) ** 2 + ((y - vy) / 0.18) ** 2 + ((x - vx) / 0.14) ** 2
    ) < 1.0
    vent = (vent_l | vent_r) & head
    # landmark: anterior-superior tip of the LEFT ventricle ("top left")
    lm_cont = np.array([vz - 0.30, vy - 0.16, -vx], np.float32)
    landmark = (lm_cont + 1.0) / 2.0 * (n - 1)

    # lesion: one blob in a random hemisphere location (not on ventricle)
    big = pathology == "HGG"
    r = (0.30 if big else 0.16) + jit(0.03)
    cz, cy = rng.uniform(-0.4, 0.4, 2)
    cx = rng.choice([-1, 1]) * rng.uniform(0.3, 0.55)
    lesion = (((z - cz) / r) ** 2 + ((y - cy) / r) ** 2 + ((x - cx) / r) ** 2) < 1.0
    lesion &= head & ~vent
    edema = (
        ((z - cz) / (r * 1.6)) ** 2
        + ((y - cy) / (r * 1.6)) ** 2
        + ((x - cx) / (r * 1.6)) ** 2
    ) < 1.0
    edema &= head & ~vent & ~lesion

    tissue = {
        "head": head.astype(np.float32),
        "vent": vent.astype(np.float32),
        "lesion": lesion.astype(np.float32),
        "edema": edema.astype(np.float32),
    }
    return tissue, landmark


_MODALITY_MIX = {
    #          head   vent  lesion edema
    "t1": (0.60, 0.15, 0.40, 0.55),
    "t1ce": (0.60, 0.15, 0.95, 0.55),
    "t2": (0.45, 0.95, 0.65, 0.75),
    "flair": (0.50, 0.10, 0.80, 0.95),
}

_ORIENT_PERM = {"axial": (0, 1, 2), "coronal": (1, 0, 2), "sagittal": (2, 1, 0)}


def task_name(modality: str, orientation: str, pathology: str) -> str:
    return f"{orientation}_{pathology}_{modality}"


def make_volume(
    task: tuple[str, str, str], patient: int, n: int = 24, noise: float = 0.03
) -> tuple[np.ndarray, np.ndarray]:
    """``task`` (modality, orientation, pathology) -> (volume f32
    [n,n,n] in [0,1], landmark float [3] in volume idx)."""
    modality, orientation, pathology = task
    tissue, landmark = _canonical(patient, pathology, n)
    wh, wv, wl, we = _MODALITY_MIX[modality]
    vol = (
        wh
        * tissue["head"]
        * (1 - tissue["vent"])
        * (1 - tissue["lesion"])
        * (1 - tissue["edema"])
        + wv * tissue["vent"]
        + wl * tissue["lesion"]
        + we * tissue["edema"]
    )
    # process-stable seed (Python's str hash is salted per interpreter,
    # which made every benchmark run draw different volume noise)
    name = task_name(modality, orientation, pathology)
    rng = np.random.default_rng(zlib.crc32(f"{name}:{patient}".encode()))
    vol = vol + noise * rng.standard_normal(vol.shape).astype(np.float32)
    vol = np.clip(vol, 0.0, 1.0).astype(np.float32)
    perm = _ORIENT_PERM[orientation]
    vol = np.transpose(vol, perm)
    lm = landmark[list(perm)].copy()
    return vol, lm
