"""On-disk JSONL result store: the unit of sweep resumability.

One line per finished cell, keyed by the content-addressed cell key
(variant label + seed + device type + derived-spec hash), so one store
holds a sweep's CPU and card rows apart.  Re-running a sweep loads
the store first and only executes cells without an ``"ok"`` row — an
interrupted 20-cell sweep with 14 completed cells re-executes exactly
the missing 6.  Failed cells (errors, budget overruns) are re-attempted
on the next run; their old rows are superseded because later lines win.

The store is written by a single process (the sweep executor appends as
futures complete) and read by anyone; rows are self-contained JSON
objects, so a truncated final line (a crash mid-write) is skipped
rather than poisoning the file.
"""

from __future__ import annotations

import json
import os
from collections.abc import Iterable
from typing import Any

Row = dict[str, Any]

STATUS_OK = "ok"
STATUS_ERROR = "error"
STATUS_BUDGET = "budget_exceeded"


class ReportStore:
    """Append-only JSONL of per-cell results, keyed by cell key."""

    def __init__(self, path: str):
        self.path = str(path)

    # -- reading -----------------------------------------------------------
    def load(self) -> dict[str, Row]:
        """key -> newest row (malformed/truncated lines are skipped)."""
        rows: dict[str, Row] = {}
        if not os.path.exists(self.path):
            return rows
        with open(self.path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    row = json.loads(line)
                except json.JSONDecodeError:
                    continue  # crash mid-append: ignore the torn tail
                key = row.get("key")
                if isinstance(key, str):
                    rows[key] = row
        return rows

    def completed(self) -> dict[str, Row]:
        """key -> row for cells that finished successfully."""
        return {k: r for k, r in self.load().items() if r.get("status") == STATUS_OK}

    def get(self, key: str) -> Row | None:
        return self.load().get(key)

    # -- writing -----------------------------------------------------------
    def append(self, row: Row) -> None:
        if "key" not in row:
            raise ValueError("store rows need a 'key'")
        parent = os.path.dirname(self.path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        with open(self.path, "a") as f:
            f.write(json.dumps(row, sort_keys=True) + "\n")
            f.flush()

    def extend(self, rows: Iterable[Row]) -> None:
        for row in rows:
            self.append(row)

    def prune(self, keep_keys: Iterable[str]) -> int:
        """Rewrite the file keeping only ``keep_keys`` (newest rows);
        returns how many rows were dropped.  Useful after a sweep's grid
        changed and stale cells would otherwise accumulate forever."""
        keep = set(keep_keys)
        rows = self.load()
        kept: list[Row] = [r for k, r in sorted(rows.items()) if k in keep]
        dropped = len(rows) - len(kept)
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            for r in kept:
                f.write(json.dumps(r, sort_keys=True) + "\n")
        os.replace(tmp, self.path)
        return dropped


__all__ = ["ReportStore", "Row", "STATUS_BUDGET", "STATUS_ERROR", "STATUS_OK"]
