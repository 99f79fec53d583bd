"""One run of one cell: set-up, the measured window, the check of what
the window produced, the metrics, and the result line.

A driver module (``drivers/<name>.py``) holds ``Driver(run)`` with

* ``setup()``: builds the system under test from the seed and warms up
  every shape the window uses (timed as ``setup_s``);
* ``window(seconds)``: drives the system for ``seconds`` of host time,
  calling ``run.tick(units)`` at each boundary of a whole unit of work,
  and fills ``run.window`` (``seconds``, ``units``; anything its metric
  readers want) and ``run.attempted`` / ``run.failed``;
* ``check(mode)``: once the window has closed and the peak memory is
  read, frees the program's state and compares what the window produced
  with the configuration's plain reference; returns ``{name: value}``.
  ``mode`` is ``"program"`` (the run's own check) or ``"control"`` (the
  reference in the precision below the configuration's, read against
  the reference; calibration only);
* ``check_needs_window``: False where the check reads only set-up's
  first steps (a training cell), so calibration can skip the window.

A fault (``--fault``, calibration and tests only) is planted by the
driver in the timed path before set-up.
"""

from __future__ import annotations

import gc
import json
import math
import sys
import time
from dataclasses import dataclass, field

import torch

from perfbench.harness import bench
from perfbench.harness.profiling import Profile, WindowProfiler

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")  # whole top-level names


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is one
    of :data:`FORBIDDEN`; ``repro_torch`` is not ``repro``."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


@dataclass
class Run:
    cell: bench.Cell
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    fault: str | None = None
    t_start: float = field(default_factory=time.perf_counter)
    setup_s: float | None = None
    window: dict = field(default_factory=dict)
    attempted: int = 0
    failed: int = 0
    telemetry: object = None  # the program's Telemetry, where the driver attached one
    profiler: WindowProfiler | None = None
    _w0: float = 0.0

    @property
    def profile(self) -> Profile | None:
        return None if self.profiler is None else self.profiler.profile

    def note(self, what: str) -> None:
        """A line on standard error: ``what`` at the seconds since the
        process started (where set-up's time goes)."""
        print(f"perfbench: {time.perf_counter() - self.t_start:.3f} s {what}", file=sys.stderr)

    def start_window(self, t0: float | None = None) -> float:
        self._w0 = time.perf_counter() if t0 is None else t0
        return self._w0

    @property
    def window_start(self) -> float:
        return self._w0

    def tick(self, units: float, can_start: bool = True) -> None:
        if self.profiler is not None:
            self.profiler.tick(time.perf_counter() - self._w0, units, can_start)

    def end_window(self, units: float) -> float:
        """Stops the profiler; returns the seconds of the window that ran
        unprofiled (all of it in an untraced run)."""
        t1 = time.perf_counter()
        if self.profiler is None or self.profiler.started_at is None:
            return t1 - self._w0
        self.profiler.stop(units)
        return self.profiler.started_at - self._w0


def _device_info(run: Run) -> dict:
    dev = run.device
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
    return {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(dev),
        "count": run.cell.chips,
        "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev)),
    }


def judge(readings: dict, limits: dict) -> tuple[bool, dict]:
    """Each number the cell's limits file names against its limit; one
    the check did not read, or that is not a finite number, fails.  A
    driver's other readings are calibration's candidates, not compared."""
    checks = {}
    ok = bool(limits)
    for name in limits:
        value = readings.get(name)
        limit = limits[name].get("limit")
        good = (
            limit is not None
            and isinstance(value, (int, float))
            and math.isfinite(value)
            and value <= limit
        )
        ok &= good
        checks[name] = {"value": value, "limit": limit}
    return ok, checks


def free_device() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def run_cell(
    name: str,
    seed: int,
    seconds: float,
    trace: bool,
    *,
    device: str = "cuda",
    fault: str | None = None,
    overrides: dict | None = None,
    t_start: float | None = None,
    root=bench.ROOT,
) -> dict:
    """One run; returns the result object the last line prints."""
    cell = bench.load_cell(name, root)
    if overrides:
        cell.config.update(overrides.get("config", {}))
        cell.traffic.update(overrides.get("traffic", {}))
    run = Run(cell, seed, seconds, trace, torch.device(device), fault)
    if t_start is not None:
        run.t_start = t_start
    prof_cfg = cell.traffic.get("profile", {})
    prof_s = min(prof_cfg.get("seconds", 3.0), 0.5 * seconds)
    run.profiler = WindowProfiler(
        trace and run.device.type == "cuda",
        after_s=seconds - prof_s,
        max_units=prof_cfg.get("max_units", float("inf")),
    )
    driver = cell.driver().Driver(run)
    run.note("set-up starts")
    driver.setup()
    run.setup_s = time.perf_counter() - run.t_start
    run.note("set-up done")
    driver.window(seconds)
    device = _device_info(run)  # the peak, before the reference runs
    run.note("window done")
    readings = driver.check("program")
    run.note("check done")
    free_device()
    ok, checks = judge(readings, cell.limits)
    metrics = {}
    for m in cell.per_layer if trace else cell.end_to_end:
        value = cell.metric_reader(m.name).read(run)
        if value is not None:
            metrics[m.name] = {"value": float(value), "unit": m.unit}
    result = {
        "correct": ok,
        "attempted": int(run.attempted),
        "failed": int(run.failed),
        "metrics": metrics,
        "device": device,
    }
    prof = run.profile
    if trace and prof is not None:
        device["busy_s"] = prof.busy_s
        device["window_s"] = prof.window_s
        result["breakdown"] = prof.breakdown()
    result["checks"] = checks
    return result


def _worst(driver) -> dict:
    """The leaves where a training check's worst gaps were (a diagnosis
    of the readings, printed beside them)."""
    return {
        k: str(getattr(driver, k))
        for k in ("worst_grad", "worst_change")
        if hasattr(driver, k)
    }


def calibrate(
    name: str,
    seeds: list[int],
    seconds: float,
    *,
    device: str = "cuda",
    fault: str | None = None,
    control: bool = False,
    overrides: dict | None = None,
) -> list[dict]:
    """The readings of the program (or, with ``fault``, of the program
    with that fault planted) and, with ``control``, of the control, seed
    by seed in one process: what the limits are set from.  Each row also
    says whether the cell's limits, through :func:`judge`, find the
    program (``correct``) and the control (``control_correct``) correct."""
    out = []
    for seed in seeds:
        cell = bench.load_cell(name)
        if overrides:
            cell.config.update(overrides.get("config", {}))
            cell.traffic.update(overrides.get("traffic", {}))
        run = Run(cell, seed, seconds, False, torch.device(device), fault)
        driver = cell.driver().Driver(run)
        driver.setup()
        if getattr(driver, "check_needs_window", True):
            driver.window(seconds)
        row = {"seed": seed, "fault": fault, "program": driver.check("program")}
        row["worst"] = _worst(driver)
        row["correct"] = judge(row["program"], cell.limits)[0]
        if control:
            row["control"] = driver.check("control")
            row["control_worst"] = _worst(driver)
            row["control_correct"] = judge(row["control"], cell.limits)[0]
        del driver
        free_device()
        out.append(row)
        print(json.dumps(row), flush=True)
    return out
