"""The fleet engine's CUDA graphs as far as the CPU sees them, and the
benchmark's reader of them.

* A CPU engine never captures: a traced ADFLL run's ``fleet.flush``
  spans all carry ``graph="eager"``, and no chunk is captured or
  replayed (the card's side is ``tests/test_torch_cuda_paths.py -m
  cuda``: graphs against direct chunk calls, bit for bit).
* The replay pool is one buffer per device whose row capacity is a
  power of two: reused while the flush's rows fit, reallocated with
  room for four times them when they outgrow it, the ERBs back to back
  from row 0;
  the engine's flushes over it train as direct ``train_chunk`` calls on
  the concatenated ERBs do, bit for bit.
* ``perfbench/metrics/graph_share.fleet.py`` on hand-made
  ``fleet.flush`` spans: the replayed share of ``jobs x k_steps``, the
  window ended at the flush boundary where the profiler was asked to
  start, and nothing read from a program whose spans lack ``graph``,
  from a run without telemetry or from a tracer that dropped events.
"""

import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.configs.adfll_dqn import ADFLLConfig, DQNConfig  # noqa: E402
from repro_torch.core.erb import TaskTag, erb_add, erb_flatten, erb_init  # noqa: E402
from repro_torch.core.replay import SelectiveReplaySampler  # noqa: E402
from repro_torch.experiments import ScenarioSpec  # noqa: E402
from repro_torch.experiments.runner import build  # noqa: E402
from repro_torch.optim.adamw import leaves  # noqa: E402
from repro_torch.rl.fleet import FleetEngine  # noqa: E402
from repro_torch.telemetry import Telemetry  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench.harness import bench  # noqa: E402

CPU = torch.device("cpu")
TINY = DQNConfig(
    volume_shape=(12, 12, 12),
    box_size=(4, 4, 4),
    conv_features=(2,),
    hidden=(8,),
    batch_size=4,
    max_episode_steps=4,
    eps_decay_steps=20,
)


def _spec(n_agents: int) -> ScenarioSpec:
    return ScenarioSpec(
        name="tiny",
        system="adfll",
        task_set="paper8",
        n_tasks=2,
        n_patients=8,
        dqn=TINY,
        sys=ADFLLConfig(
            n_agents=n_agents,
            n_hubs=1,
            agent_hub=(0,) * n_agents,
            agent_speed=(1.0, 2.0, 1.5)[:n_agents],
            rounds=3,
            erb_capacity=64,
            erb_share_size=8,
            train_steps_per_round=3,
            hub_sync_period=0.5,
        ),
        eval_patients=1,
        eval_episodes=1,
    )


@pytest.mark.parametrize("n_agents", [1, 2, 3])
def test_cpu_engine_never_captures(n_agents):
    system = build(_spec(n_agents), device="cpu")
    engine = system.engine
    tel = engine.telemetry = Telemetry()
    system.run()
    flushes = tel.tracer.spans("fleet.flush")
    assert flushes and engine.n_flushes == len(flushes)
    assert {e["args"]["graph"] for e in flushes} == {"eager"}
    assert engine.n_graph_captures == engine.n_graph_replays == 0
    assert not engine._graphs and not engine._graph_shapes and not engine._graph_warm
    assert tel.registry.counter_value("fleet.graph.captures") == 0
    assert tel.registry.counter_value("fleet.graph.replays") == 0


def _rows(rng, n):
    box = TINY.box_size
    return {
        "obs": rng.standard_normal((n, *box)).astype(np.float32),
        "loc": rng.random((n, 3)).astype(np.float32),
        "action": rng.integers(0, TINY.n_actions, n).astype(np.int32),
        "reward": rng.standard_normal(n).astype(np.float32),
        "next_obs": rng.standard_normal((n, *box)).astype(np.float32),
        "next_loc": rng.random((n, 3)).astype(np.float32),
        "done": (rng.random(n) < 0.1).astype(np.float32),
    }


@pytest.mark.parametrize(
    "adds,capacities",
    [
        ((100, 20, 80, 400), (1024, 1024, 1024, 8192)),
        ((3, 1, 4, 60), (32, 32, 32, 1024)),
    ],
)
def test_pool_buffer_grows_by_powers_of_two(adds, capacities):
    """Two slots, each on its own ERB, flush after each growth of both
    ERBs: the pool holds the first ERB then the second, one buffer while
    their rows fit, then a new one of the power of two that holds four
    times them; state and losses as direct chunk calls on the concatenated
    ERBs."""
    rng = np.random.default_rng(len(adds) + adds[0])
    task = TaskTag("t1", "axial", "HGG")
    erbs = [erb_init(1024, TINY.box_size, task=task, source_agent=a) for a in range(2)]
    engine = FleetEngine(TINY, device="cpu")
    for seed in range(2):
        engine.add_slot(seed)
    ref = engine.state.map(torch.clone)
    sampler = SelectiveReplaySampler()
    bufs = []
    for add, cap in zip(adds, capacities, strict=True):
        for erb in erbs:
            erb_add(erb, _rows(rng, add))
        plans = [
            [sampler.plan(rng, TINY.batch_size, erb) for _ in range(3)] for erb in erbs
        ]
        futures = [engine.submit(slot, p) for slot, p in enumerate(plans)]
        engine.flush()
        pool = engine._pool_bufs[CPU]
        total = sum(e.size for e in erbs)
        assert pool.shape == (cap, engine.steps.feat) and cap >= total
        want_pool = np.concatenate([erb_flatten(e) for e in erbs])
        assert np.array_equal(pool[:total].numpy(), want_pool)
        bufs.append(pool)
        # the direct chunk: slot j reads its own ERB at its offset
        base = [0, erbs[0].size]
        idx = np.stack(
            [
                np.stack(
                    [np.concatenate([r for _, r in p.picks])[p.perm] + base[j] for p in job]
                )
                for j, job in enumerate(plans)
            ],
            1,
        ).astype(np.int32)
        ref, losses = engine.steps.train_chunk(
            ref, torch.from_numpy(want_pool), torch.from_numpy(idx)
        )
        for a, b in zip(leaves(engine.state.params), leaves(ref.params), strict=True):
            assert torch.equal(a, b)
        assert [f.loss for f in futures] == [float(x) for x in losses[-1]]
    for i in range(1, len(bufs)):
        same = capacities[i] == capacities[i - 1]
        assert (bufs[i] is bufs[i - 1]) == same


# -- the benchmark's reader ----------------------------------------------------


def _read(run):
    return bench.load_cell("adfll-dqn.fleet_paper").metric_reader("graph_share.fleet").read(run)


def _flush(t0, t1, jobs, graph=None, k_steps=80):
    args = {"jobs": jobs, "k_steps": k_steps, "devices": 1}
    if graph is not None:
        args["graph"] = graph
    return {"kind": "span", "name": "fleet.flush", "track": "fleet", "clock": "wall",
            "t0": t0, "t1": t1, "args": args, "id": int(t1 * 10), "parent": None}  # fmt: skip


def _fake_run(events, dropped=0, profiled=False):
    tracer = SimpleNamespace(
        events=events,
        n_dropped=dropped,
        spans=lambda name: [e for e in events if e["name"] == name],
    )
    # the window starts at perf_counter 100, wall 0; flush boundaries at
    # 4.5, 8.5 and 10 s, the profiler asked to start at the second
    log = [(104.5, 240, 0, [3]), (108.5, 560, 0, [4]), (110.0, 800, 0, [3])]
    window = {"tel_t0": 0.0, "unprofiled_s": 10.0, "units": 800, "t0": 100.0, "log": log}
    return SimpleNamespace(
        telemetry=SimpleNamespace(tracer=tracer),
        window=window,
        profile=SimpleNamespace(t0=109.0) if profiled else None,
    )


FLUSHES = [
    _flush(-1.0, -0.5, 4, "replay"),  # before the window
    _flush(1.0, 2.0, 2, "eager"),
    _flush(3.0, 4.5, 1, "capture"),
    _flush(6.0, 8.5, 4, "replay"),
    _flush(9.0, 10.0, 3, "replay"),  # after the profiler was asked to start
]


def test_graph_share_is_the_cell_s_metric():
    cell = bench.load_cell("adfll-dqn.fleet_paper")
    (metric,) = [m for m in cell.per_layer if m.name == "graph_share.fleet"]
    assert (metric.unit, metric.better, metric.source) == ("%", "higher", "program_span")
    assert metric.moves == "fleet_steps_per_s"


@pytest.mark.parametrize(
    "profiled,want",
    [
        (False, 100.0 * (4 + 3) / (2 + 1 + 4 + 3)),  # the whole window
        (True, 100.0 * 4 / (2 + 1 + 4)),  # to the boundary at 8.5 s
    ],
)
def test_graph_share_reads_the_replayed_steps(profiled, want):
    assert _read(_fake_run(FLUSHES, profiled=profiled)) == pytest.approx(want)


def test_graph_share_weighs_steps_not_flushes():
    run = _fake_run([_flush(1.0, 2.0, 1, "eager", 80), _flush(3.0, 4.0, 1, "replay", 20)])
    assert _read(run) == pytest.approx(20.0)


def test_graph_share_reads_nothing_without_the_argument():
    # the program before graphs: flush spans with no ``graph``
    old = [_flush(e["t0"], e["t1"], e["args"]["jobs"]) for e in FLUSHES]
    assert _read(_fake_run(old)) is None
    assert _read(_fake_run(FLUSHES, dropped=1)) is None
    assert _read(_fake_run([])) is None
    untraced = SimpleNamespace(telemetry=None, window={"tel_t0": None}, profile=None)
    assert _read(untraced) is None


def test_graph_share_reads_zero_on_a_traced_cpu_engine():
    """A real engine's spans, all eager on the CPU: the reader finds the
    argument and reads 0."""
    system = build(_spec(2), device="cpu")
    tel = system.engine.telemetry = Telemetry()
    system.run()
    wall = [e for e in tel.tracer.events if e["kind"] == "span" and "id" in e]
    end = max(e["t1"] for e in wall)
    run = SimpleNamespace(
        telemetry=tel,
        window={"tel_t0": 0.0, "unprofiled_s": end + 1.0, "units": 1},
        profile=None,
    )
    assert _read(run) == 0.0
