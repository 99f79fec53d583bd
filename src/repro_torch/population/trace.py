"""Replayable availability trace files.

A trace file is JSONL: one ``{"on": t0, "off": t1}`` object per line,
times relative to the agent's join, windows disjoint and increasing —
the exact contract of :class:`repro_torch.population.spec.Trace`.  Traces
round-trip losslessly (floats serialized with ``repr`` precision), so a
recorded availability timeline replays bit-identically.
"""

from __future__ import annotations

import json
from collections.abc import Sequence
from pathlib import Path

PathLike = str | Path


def load_windows(path: PathLike) -> tuple[tuple[float, float], ...]:
    """Read ``(on, off)`` windows from a JSONL trace file."""
    windows = []
    for i, line in enumerate(Path(path).read_text().splitlines()):
        line = line.strip()
        if not line:
            continue
        row = json.loads(line)
        try:
            windows.append((float(row["on"]), float(row["off"])))
        except (KeyError, TypeError) as e:
            raise ValueError(f"{path}:{i + 1}: bad trace row {line!r}") from e
    return tuple(windows)


def save_windows(path: PathLike, windows: Sequence[tuple[float, float]]) -> None:
    """Write ``(on, off)`` windows as a JSONL trace file."""
    lines = [json.dumps({"on": on, "off": off}) for on, off in windows]
    Path(path).write_text("\n".join(lines) + ("\n" if lines else ""))


__all__ = ["load_windows", "save_windows"]
