"""Each cell's check on the CPU: sound runs come out correct, and a run
with the timed path broken underneath comes out not correct, once for
each fault the cell can have (the harness's look for a card skipped)."""

from __future__ import annotations

import pytest
from conftest import SMALL

from perfbench.harness import runner

CASES = [
    ("adfll-dqn.fleet_paper", None),
    ("adfll-dqn.fleet_paper", "unchanged"),
    ("adfll-dqn.fleet_paper", "half_batch"),
    ("adfll-dqn.fleet_paper", "altered"),
    ("deepseek-v2-lite-16b.train", None),
    ("deepseek-v2-lite-16b.train", "unchanged"),
    ("deepseek-v2-lite-16b.train", "half_batch"),
    ("deepseek-v2-lite-16b.train", "altered"),
    ("deepseek-v2-lite-16b.decode", None),
    ("deepseek-v2-lite-16b.decode", "altered"),
]


@pytest.mark.parametrize("cell,fault", CASES)
def test_check_catches_the_fault(cell, fault):
    out = runner.run_cell(cell, 1234567890123, 1.0, False, device="cpu",
                          fault=fault, overrides=SMALL[cell])  # fmt: skip
    assert out["correct"] is (fault is None), out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "checks"
