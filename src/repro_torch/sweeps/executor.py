"""Parallel sweep execution with per-run isolation and resumability.

Cells run in a ``spawn``-context process pool (one fresh interpreter
per worker: no CUDA context, RNG, or registry mutation leaks between
cells; a forked child cannot use its parent's CUDA context, so the pool
never forks), results stream back to the parent, and every finished
cell is appended to the :class:`~repro_torch.sweeps.store.ReportStore`
as it lands — an interrupted sweep resumes from the store and
re-executes only the missing cells.  ``workers=1`` (or ``0``) runs cells
inline in this process, which is what tests and tiny grids want.  Every
cell runs on ``device`` (``None`` = the CUDA card); each spawned worker
initializes CUDA itself and loads the same kernel library, a start-up
that four workers on one card repay on full-depth cells and not on
``--fast`` ones (``PERF.md``).  A cell's key and its row carry the
device type, so a cached CPU row never stands in for the card's.

Wall-time budgets are enforced per cell: an interval timer inside the
worker interrupts a cell that overruns its budget (Python-level code;
a hang inside a C extension, a CUDA synchronize included, is only
caught on return to the interpreter), and a finished cell whose wall
clock exceeded the budget is recorded the same way.  Either path yields
a ``budget_exceeded`` row, which fails the sweep (CI uses this to keep
scenario runtime honest).  A worker that raises records an ``error``
row instead of killing the sweep; both failure kinds are retried on the
next run.
"""
from __future__ import annotations

import multiprocessing
import os
import signal
import threading
import time
import traceback
from concurrent.futures import FIRST_COMPLETED, ProcessPoolExecutor, wait
from contextlib import contextmanager
from typing import Any

from repro_torch.device import device_type
from repro_torch.experiments import runner
from repro_torch.sweeps.aggregate import forgetting_of, summarize
from repro_torch.sweeps.spec import SweepCell, SweepSpec
from repro_torch.sweeps.store import (
    STATUS_BUDGET,
    STATUS_ERROR,
    STATUS_OK,
    ReportStore,
    Row,
)


def default_workers(n_cells: int) -> int:
    return max(1, min(4, os.cpu_count() or 1, n_cells))


class _BudgetExceeded(Exception):
    """Raised inside a worker when the cell's interval timer fires."""


@contextmanager
def _budget_alarm(budget_s: float | None):
    """Interrupt the cell when its wall-time budget elapses.

    Uses ``SIGALRM``/``setitimer``, so it only arms on platforms that
    have it and in the process's main thread (both true for spawn-pool
    workers and the inline path); otherwise the post-hoc elapsed check
    still catches slow-but-finishing cells."""
    usable = (
        budget_s is not None
        and hasattr(signal, "setitimer")
        and threading.current_thread() is threading.main_thread()
    )
    if not usable:
        yield
        return

    def on_alarm(signum, frame):
        raise _BudgetExceeded

    prev = signal.signal(signal.SIGALRM, on_alarm)
    signal.setitimer(signal.ITIMER_REAL, budget_s)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0.0)
        signal.signal(signal.SIGALRM, prev)


def _run_cell(payload: tuple[SweepCell, float | None, str | None]) -> Row:
    """Execute one cell (top-level so the spawn pool can pickle it)."""
    cell, budget_s, device = payload
    t0 = time.monotonic()
    row: Row = {
        "key": cell.key,
        "sweep": cell.sweep,
        "label": cell.label,
        "scenario": cell.scenario,
        "seed": cell.seed,
        "device": cell.device,
    }
    try:
        # the cell's spec is fully derived (seed + fast already applied)
        with _budget_alarm(budget_s):
            report = runner.run(cell.spec, device=device)
        summary = report.summary()
        summary["forgetting"] = forgetting_of(summary)
        row["summary"] = summary
        row["status"] = STATUS_OK
    except _BudgetExceeded:
        row["status"] = STATUS_BUDGET
    except Exception:
        row["status"] = STATUS_ERROR
        row["error"] = traceback.format_exc(limit=8)
    row["elapsed_s"] = time.monotonic() - t0
    if (
        row["status"] == STATUS_OK
        and budget_s is not None
        and row["elapsed_s"] > budget_s
    ):
        row["status"] = STATUS_BUDGET
    if row["status"] == STATUS_BUDGET:
        row["error"] = (
            f"cell took {row['elapsed_s']:.1f}s, budget is {budget_s:.1f}s"
        )
    return row


def run_sweep(
    sweep: SweepSpec,
    *,
    fast: bool = False,
    workers: int | None = None,
    store: ReportStore | None = None,
    budget_s: float | None = None,
    echo=None,
    device: str | None = None,
) -> dict[str, Any]:
    """Expand, execute (resuming from ``store``) on ``device`` (``None`` =
    the CUDA card), aggregate.

    Returns the summary document from
    :func:`~repro_torch.sweeps.aggregate.summarize`; cells that failed (error
    or budget) appear in its ``cells`` ledger with their status."""
    say = echo or (lambda *_: None)
    cells = sweep.expand(fast=fast, device=device)
    budget = sweep.cell_budget_s if budget_s is None else budget_s
    cached: dict[str, Row] = {}
    if store is not None:
        done = store.completed()
        cached = {c.key: dict(done[c.key], cached=True) for c in cells if c.key in done}
    pending = [c for c in cells if c.key not in cached]
    say(
        f"sweep {sweep.name}: {len(cells)} cells "
        f"({len(cached)} cached, {len(pending)} to run)"
    )

    fresh: dict[str, Row] = {}

    def record(row: Row) -> None:
        fresh[row["key"]] = row
        if store is not None:
            store.append(row)
        status = row["status"]
        mde = (row.get("summary") or {}).get("mean_dist_err")
        detail = (
            f"mean_dist_err={mde:.3f}"
            if isinstance(mde, float)
            else (row.get("error") or "").splitlines()[-1][:80]
        )
        say(
            f"  [{status}] {row['label']} seed={row['seed']} "
            f"({row['elapsed_s']:.1f}s) {detail}"
        )

    n_workers = default_workers(len(pending)) if workers is None else workers
    if pending and n_workers <= 1:
        for cell in pending:
            record(_run_cell((cell, budget, device)))
    elif pending:
        ctx = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(max_workers=n_workers, mp_context=ctx) as pool:
            futures = {
                pool.submit(_run_cell, (c, budget, device)): c for c in pending
            }
            remaining = set(futures)
            while remaining:
                finished, remaining = wait(remaining, return_when=FIRST_COMPLETED)
                for fut in finished:
                    cell = futures[fut]
                    exc = fut.exception()
                    if exc is None:
                        record(fut.result())
                    else:  # the worker process itself died
                        record(
                            {
                                "key": cell.key,
                                "sweep": cell.sweep,
                                "label": cell.label,
                                "scenario": cell.scenario,
                                "seed": cell.seed,
                                "device": cell.device,
                                "status": STATUS_ERROR,
                                "error": f"worker failed: {exc!r}",
                                "elapsed_s": float("nan"),
                            }
                        )

    rows: list[Row] = [
        cached[c.key] if c.key in cached else fresh[c.key]
        for c in cells
        if c.key in cached or c.key in fresh
    ]
    return summarize(sweep, rows, fast=fast, device=device_type(device))


def failed_cells(summary: dict[str, Any]) -> list[dict[str, Any]]:
    """The summary's non-ok cells (empty list = clean sweep)."""
    return [c for c in summary.get("cells", []) if c.get("status") != STATUS_OK]


__all__ = ["default_workers", "failed_cells", "run_sweep"]
