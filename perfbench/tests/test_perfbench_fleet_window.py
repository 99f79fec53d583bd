"""The fleet cell's window stops at flush boundaries and adds no flush:
set-up and the window together flush exactly as one unsliced run of
the same system does."""

from __future__ import annotations

import torch
from conftest import SMALL

from perfbench.harness import bench, runner


def _driver(seed: int):
    cell = bench.load_cell("adfll-dqn.fleet_paper")
    small = SMALL["adfll-dqn.fleet_paper"]
    cell.config.update(small["config"])
    cell.traffic.update(small["traffic"])
    run = runner.Run(cell, seed, 0.3, False, torch.device("cpu"))
    driver = cell.driver().Driver(run)
    driver.setup()
    return driver


def test_window_flushes_match_one_unsliced_run():
    sliced = _driver(5)
    sliced.window(0.3)
    sliced.window(0.3)
    n = sliced.engine.n_flushes
    whole = _driver(5)
    whole.system.sched.run(stop=lambda: whole.engine.n_flushes >= n)
    assert sliced.engine.flush_sizes == whole.engine.flush_sizes
    assert sliced.engine.n_steps_trained == whole.engine.n_steps_trained


def test_window_counts_the_steps_of_its_flushes():
    d = _driver(6)
    before = d.engine.n_steps_trained
    d.window(0.3)
    w = d.run.window
    assert w["units"] == d.engine.n_steps_trained - before > 0
    assert w["units"] == sum(n for _, _, _, sizes in w["log"] for n in sizes) * w["k_steps"]
