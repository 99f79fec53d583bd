"""The port stands alone: it imports neither JAX nor the reference
package, and its entry points run on the CUDA card unless asked for the
CPU — without a card they raise instead of falling back."""

import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: these sizes gain nothing from more, and spinning
# OpenMP threads in parallel test workers would starve the other tests
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]

_PROBE = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
# the framework-free copies are scanned like the rest
assert {"repro_torch.telemetry.trace", "repro_torch.observatory.learning"} <= set(names)
assert {"repro_torch.launch.train", "repro_torch.checkpoint.ckpt"} <= set(names)
assert {"repro_torch.models.sharding", "repro_torch.launch.dryrun"} <= set(names)
for name in names:
    importlib.import_module(name)
import chip_smoke
import importlib.util
for ex in ("quickstart", "adfll_deployment", "federated_lm", "train_lm_125m"):
    spec = importlib.util.spec_from_file_location(ex, f"examples/torch_{ex}.py")
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(
    m for m in sys.modules
    if m == "jax" or m.startswith(("jax.", "jaxlib")) or m == "repro"
    or m.startswith("repro.")
)
print(len(names), bad)
"""


def test_port_imports_no_jax_and_no_reference():
    env = dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}{os.pathsep}{ROOT}")
    out = subprocess.run(
        [sys.executable, "-c", _PROBE],
        cwd=ROOT,
        env=env,
        capture_output=True,
        text=True,
        timeout=300,
        check=True,
    ).stdout.split()
    n_modules, bad = int(out[0]), " ".join(out[1:])
    # every module of the port was imported: the zoo's, the experiments',
    # the sweeps', the telemetry's, the observatory's, the LM training
    # slice's (data, checkpoint, launch.train) and the planner's
    # (models.sharding, launch.mesh, launch.analysis, launch.dryrun) too;
    # and the four examples/torch_*.py
    assert n_modules >= 92
    assert bad == "[]"


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None runs on it")
    from repro_torch.configs.adfll_dqn import ADFLLConfig, DQNConfig
    from repro_torch.configs.base import get_config
    from repro_torch.core.federated import (
        ADFLLSystem,
        CentralAggregationSystem,
        train_all_knowing,
        train_partial,
        train_sequential_ll,
    )
    from repro_torch.experiments.__main__ import main
    from repro_torch.experiments.runner import run
    from repro_torch.experiments.systems import BaselineSystem
    from repro_torch.launch import serve, train
    from repro_torch.models.model import Model
    from repro_torch.rl.agent import DQNAgent
    from repro_torch.rl.fleet import FleetEngine
    from repro_torch.rl.synth import paper_eight_tasks
    from repro_torch.serve import LocalizationService, TrafficSpec, build_session
    from repro_torch.sweeps import SweepSpec, SweepVariant, run_sweep
    from repro_torch.sweeps.__main__ import main as sweeps_main

    def example(name):
        path = ROOT / "examples" / f"torch_{name}.py"
        spec = importlib.util.spec_from_file_location(f"_example_{name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.main

    cfg = DQNConfig(box_size=(4, 4, 4), conv_features=(2,), hidden=(8,))
    tasks = paper_eight_tasks()
    for make in (
        lambda: FleetEngine(cfg),
        lambda: DQNAgent(0, cfg),
        lambda: ADFLLSystem(ADFLLConfig(), cfg, tasks, [0, 1]),
        lambda: CentralAggregationSystem(2, cfg, tasks, [0, 1]),
        lambda: train_all_knowing(cfg, tasks, [0, 1]),
        lambda: train_partial(cfg, tasks[0], [0, 1]),
        lambda: train_sequential_ll(cfg, tasks, [0, 1]),
        lambda: BaselineSystem("partial", cfg, tasks, [0, 1]).run(),
        lambda: run("paper_fig2", fast=True),
        lambda: run("baseline_partial", fast=True),
        lambda: main(["--scenario", "fedavg_sync", "--fast"]),
        lambda: Model(get_config("h2o-danube-3-4b-smoke")),
        lambda: serve.main(["--arch", "h2o-danube-3-4b-smoke", "--gen", "1"]),
        lambda: serve.main(["--fleet", "--requests", "2"]),
        lambda: train.main(["--arch", "h2o-danube-3-4b-smoke", "--steps", "1"]),
        lambda: run("serve_localization", fast=True),
        lambda: build_session(cfg, n_agents=1, traffic=TrafficSpec(n_requests=2)),
        lambda: LocalizationService(cfg, params={"fc0": {"b": torch.zeros(1, 6)}}),
        lambda: example("quickstart")([]),
        lambda: example("adfll_deployment")(["--fast"]),
        lambda: example("federated_lm")(["--steps", "1"]),
        lambda: example("train_lm_125m")(["--arch", "xlstm-125m-smoke"]),
    ):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    # a sweep records each cell's failure: no cell falls back to the CPU
    sweep = SweepSpec(name="t", variants=(SweepVariant("y", "baseline_partial"),))
    summary = run_sweep(sweep.with_seeds((0,)), fast=True, workers=1)
    (cell,) = summary["cells"]
    assert cell["status"] == "error" and "CUDA" in cell["error"]
    args = ["--sweep", "paper_table1_sweep", "--seeds", "1", "--fast"]
    assert sweeps_main([*args, "--workers", "1", "--store", "none"]) == 1
    assert FleetEngine(cfg, device="cpu").device.type == "cpu"
    assert Model(get_config("h2o-danube-3-4b-smoke"), "cpu").device.type == "cpu"


def test_lower_layers_import_nothing_of_the_cli():
    """No module under ``repro_torch.models``, ``.rl``, ``.core`` or
    ``.kernels`` imports ``repro_torch.launch``, at its top or inside a
    function: the entry points sit above the layers they drive."""
    import ast

    src = ROOT / "src" / "repro_torch"
    found = []
    for layer in ("models", "rl", "core", "kernels"):
        for path in sorted((src / layer).rglob("*.py")):
            package = ["repro_torch", *path.relative_to(src).parent.parts]
            for node in ast.walk(ast.parse(path.read_text(), str(path))):
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom):
                    up = len(package) + 1 - node.level
                    base = package[:up] if node.level else []
                    mod = ".".join([*base, node.module or ""]).strip(".")
                    names = [mod] + [f"{mod}.{a.name}" for a in node.names]
                else:
                    continue
                if any(n.split(".")[:2] == ["repro_torch", "launch"] for n in names):
                    found.append(f"{path.relative_to(src)}:{node.lineno}")
    assert found == []
