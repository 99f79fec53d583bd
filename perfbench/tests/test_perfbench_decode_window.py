"""The decode cell's window serves whole cycles of its traffic file's
prompt lengths, from the cycle's start, so every window holds the mix
exactly."""

from __future__ import annotations

import torch
from conftest import SMALL

from perfbench.harness import bench, runner

CELL = "deepseek-v2-lite-16b.decode"


def test_the_window_ends_at_the_end_of_a_cycle():
    cell = bench.load_cell(CELL)
    cell.config.update(SMALL[CELL]["config"])
    cell.traffic.update(SMALL[CELL]["traffic"])
    cycle = cell.traffic["cycle"]
    run = runner.Run(cell, 2147483659, 0.0, False, torch.device("cpu"))
    driver = cell.driver().Driver(run)
    driver.setup()
    driver.window(0.0)
    assert [x[0] for x in driver.batches] == cycle
    b, g = cell.traffic["batch"], cell.traffic["gen"]
    assert run.window["units"] == len(cycle) * b * (g + 1)
