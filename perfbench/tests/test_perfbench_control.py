"""The controls on the card: each cell's reference in the precision
below the configuration's, put in the program's place.  At the size a
test run holds (the fleet at its own widths, the language model at its
CPU test size) the control reads at least three times what the program
reads on the same seeds in one of the cell's compared numbers.  At the
cells' own sizes, where the limits were set (``perfbench/limits``), the
harness's own comparison finds the program correct and the control
not."""

from __future__ import annotations

import pytest
from conftest import SMALL

from perfbench.harness import bench, runner

CELLS = ["adfll-dqn.fleet_paper", "deepseek-v2-lite-16b.train", "deepseek-v2-lite-16b.decode"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_separates_from_the_program(cell, cuda_card):
    small = {} if cell.startswith("adfll-dqn") else SMALL[cell]
    rows = runner.calibrate(cell, [11, 12, 13], 5.0, control=True, overrides=small)
    limits = bench.load_cell(cell).limits
    for row in rows:
        prog, ctl = row["program"], row["control"]
        assert any(ctl[k] >= 3 * max(prog[k], 1e-12) for k in limits), row
        if not small:
            assert row["correct"] and not row["control_correct"], row


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS[1:])
def test_control_is_not_correct_at_the_cells_size(cell, cuda_card):
    """One seed of each language-model cell at its full size, its window
    (one whole cycle for decode) and its check as a run makes them."""
    (row,) = runner.calibrate(cell, [3000000611], 5.0, control=True)
    assert row["correct"] and not row["control_correct"], row
