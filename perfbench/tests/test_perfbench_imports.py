"""What the benchmark loads: never ``jax``, ``jaxlib``, ``flax`` or the
JAX package ``repro`` (top-level names compared whole, so the port
``repro_torch`` is fine), and the references nothing of the port."""

from __future__ import annotations

import ast
import json
import subprocess
import sys

from conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path) -> set[str]:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module.split(".")[0])
    return names


def test_no_file_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in (ROOT / "perfbench").rglob("*.py"):
        assert not _imports(path) & FORBIDDEN, path


def test_the_references_import_nothing_of_the_program():
    for path in (ROOT / "perfbench" / "reference").glob("*.py"):
        assert not _imports(path) & (FORBIDDEN | {"repro_torch"}), path


def test_a_run_loads_no_jax_module():
    """A whole cell run on the CPU in a fresh process, then its modules."""
    code = f"""
import json, sys
sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}, {str(ROOT / 'perfbench' / 'tests')!r}]
from conftest import SMALL
from perfbench.harness import runner
r = runner.run_cell("adfll-dqn.fleet_paper", 1, 0.5, False, device="cpu",
                    overrides=SMALL["adfll-dqn.fleet_paper"])
print(json.dumps({{"correct": r["correct"], "bad": runner.forbidden_modules()}}))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, check=True)  # fmt: skip
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"correct": True, "bad": []}


def test_the_command_refuses_without_a_card():
    out = subprocess.run(
        [sys.executable, str(ROOT / "perfbench" / "run.py"), "--workload",
         "adfll-dqn.fleet_paper", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=120,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"},
    )  # fmt: skip
    assert out.returncode != 0 and out.stdout.strip() == ""
