"""The fleet in a closed loop: ``ADFLLSystem`` trains as fast as it can.

Set-up builds the system of the configuration (its agents, hubs and
speeds; rounds unbounded) on the card, hands every agent the weights
the benchmark drew from the seed (the target nets the same), and runs
the system's scheduler until ``warmup_flushes`` flushes of the fleet
engine have trained: every shape of the window is then warm.  The first
flush trains every agent from those weights; its first three stacked
steps are what the check compares.

The window runs the same scheduler on (``ADFLLSystem.run`` is this
scheduler's loop and a retiring flush at the end) and stops at the
first flush boundary after ``--seconds``, so the window holds whole
flushes and no extra flush: its flushes are those of one unsliced run.
A unit is one agent step (one TD update of ``batch_size`` rows for one
agent), counted by the engine at each flush.

The traffic's seed draws the weights and the patients whose volumes the
rounds collect on; the schedule (round lengths, tasks, exploration) is
the system's own, from the traffic file's ``system_seed``, so every seed
runs the same rounds.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from perfbench.harness import compare
from perfbench.harness.weights import make_leaves, nest

STEPS_CHECKED = 3
FAULTS = ("unchanged", "half_batch", "altered")


def _tuples(d: dict) -> dict:
    return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}


def dqn_leaf_specs(dqn: dict, n: int) -> list:
    """(path, shape, scale, dtype) of ``n`` stacked agents' leaves, the
    scales fan-in ** -0.5 (biases 0.01)."""
    f32 = torch.float32
    specs = []
    cin = 1
    for i, cout in enumerate(dqn["conv_features"]):
        specs.append(((f"conv{i}", "w"), (n, cout, cin, 3, 3, 3), (cin * 27) ** -0.5, f32))
        specs.append(((f"conv{i}", "b"), (n, cout), 0.01, f32))
        cin = cout
    dims = list(dqn["box_size"])
    for _ in dqn["conv_features"]:
        dims = [-(-d // 2) for d in dims]
    d = dims[0] * dims[1] * dims[2] * cin + 16
    specs.append((("loc", "w"), (n, 3, 16), 3**-0.5, f32))
    specs.append((("loc", "b"), (n, 16), 0.01, f32))
    for i, h in enumerate([*dqn["hidden"], dqn["n_actions"]]):
        specs.append(((f"fc{i}", "w"), (n, d, h), d**-0.5, f32))
        specs.append(((f"fc{i}", "b"), (n, h), 0.01, f32))
        d = h
    return specs


class Driver:
    check_needs_window = False

    def __init__(self, run):
        self.run = run
        self.cfg = run.cell.config
        self.traffic = run.cell.traffic
        self.ref = run.cell.reference()
        self.capture: dict | None = None
        self._n_captured = 0

    # -- set-up ---------------------------------------------------------------
    def setup(self) -> None:
        from repro_torch.configs.adfll_dqn import ADFLLConfig, DQNConfig
        from repro_torch.core.erb import TaskTag
        from repro_torch.core.federated import ADFLLSystem
        from repro_torch.telemetry import Telemetry

        run, cfg, tr = self.run, self.cfg, self.traffic
        dqn = DQNConfig(**_tuples(cfg["dqn"]))
        sys_cfg = ADFLLConfig(
            **_tuples(cfg["system"]), rounds=10**9, seed=int(tr["system_seed"])
        )
        tasks = [TaskTag(*t) for t in cfg["tasks"]]
        rng = np.random.default_rng(run.seed)
        patients = rng.choice(
            int(tr["patient_id_range"]), int(tr["n_train_patients"]), replace=False
        )
        self.system = ADFLLSystem(
            sys_cfg, dqn, tasks, [int(p) for p in patients], device=run.device
        )
        engine = self.engine = self.system.engine
        if run.trace:
            run.telemetry = engine.telemetry = Telemetry()
        n = len(self.system.agents)
        init = make_leaves(dqn_leaf_specs(cfg["dqn"], n), run.seed, run.device)
        self.init = {k: v.cpu() for k, v in init.items()}
        stacked = nest(init)
        for agent in self.system.agents.values():
            s = agent.slot
            one = {k: {m: t[s] for m, t in v.items()} for k, v in stacked.items()}
            engine.set_params(agent.slot, one)
            engine.set_target(agent.slot, one)
        run.note("system built, weights set")
        self._plant_fault()
        self._install_capture()
        warm = int(tr["warmup_flushes"])
        self.system.sched.run(stop=lambda: engine.n_flushes >= warm)
        if self._n_captured < STEPS_CHECKED:
            raise RuntimeError("set-up ended before the first flush's steps were read")
        if run.device.type == "cuda":
            torch.cuda.synchronize(run.device)

    def _plant_fault(self) -> None:
        fault = self.run.fault
        if fault is None:
            return
        if fault not in FAULTS:
            raise ValueError(f"unknown fault {fault!r}; have {FAULTS}")
        steps = self.engine.steps
        orig = steps.step
        col_a = steps.td_cols[0]
        n_act = self.cfg["dqn"]["n_actions"]

        def broken(state, rows):
            if fault == "unchanged":
                return state, orig(state, rows)[1]
            if fault == "half_batch":
                return orig(state, rows[:, : rows.shape[1] // 2].contiguous())
            rows = rows.clone()
            rows[0, 0, col_a] = (rows[0, 0, col_a] + 1) % n_act
            return orig(state, rows)

        steps.step = broken

    def _install_capture(self) -> None:
        """Reads the first flush's jobs (slots, the ERB rows each step
        picks) and the program's state after its steps 1 and 3; the
        wrappers come off once they have read it."""
        engine, steps = self.engine, self.engine.steps
        flush_group, step = engine._flush_group, steps.step

        def first_flush(jobs):
            engine._flush_group = flush_group
            self.capture = {
                "slots": [j.slot for j in jobs],
                "rows": [
                    [
                        self.ref.rows_from_erbs(
                            [j.erbs[e].data for e in j.eidx[k]], j.rows[k]
                        )
                        for j in jobs
                    ]
                    for k in range(STEPS_CHECKED)
                ],
                "losses": [],
            }
            steps.step = watched
            return flush_group(jobs)

        def watched(state, rows):
            new, losses = step(state, rows)
            cap = self.capture
            self._n_captured += 1
            cap["losses"].append(losses.detach().cpu().tolist())
            if self._n_captured == 1:
                cap["m1"] = {
                    (k, n): t.detach().cpu().clone()
                    for k, v in new.opt["m"].items()
                    for n, t in v.items()
                }
            if self._n_captured == STEPS_CHECKED:
                cap["p3"] = {
                    (k, n): t.detach().cpu().clone()
                    for k, v in new.params.items()
                    for n, t in v.items()
                }
                steps.step = step
            return new, losses

        engine._flush_group = first_flush

    # -- the window -------------------------------------------------------------
    def _erb_rows(self) -> int:
        return sum(e.size for a in self.system.agents.values() for e in a.personal_erbs)

    def window(self, seconds: float) -> None:
        run, engine, system = self.run, self.engine, self.system
        n0, h0 = engine.n_steps_trained, len(system.history)
        r0 = self._erb_rows()
        log = []  # (perf_counter, agent steps, ERB rows, new flush sizes)
        seen = [engine.n_flushes]
        t0 = run.start_window()
        deadline = t0 + seconds

        def stop() -> bool:
            if engine.n_flushes == seen[0]:
                return False
            sizes = engine.flush_sizes[seen[0] - engine.n_flushes :]
            seen[0] = engine.n_flushes
            units = engine.n_steps_trained - n0
            now = time.perf_counter()
            log.append((now, units, self._erb_rows() - r0, sizes))
            run.tick(units)
            return now >= deadline

        system.sched.run(stop=stop)
        t1 = time.perf_counter()
        units = engine.n_steps_trained - n0
        unprofiled_s = run.end_window(units)
        k = int(self.cfg["system"]["train_steps_per_round"])
        records = system.history[h0:]
        run.attempted = units
        run.failed = k * sum(1 for r in records if not np.isfinite(r.loss))
        tel = run.telemetry
        run.window = {
            "seconds": t1 - t0,
            "units": units,
            "unprofiled_s": unprofiled_s,
            "t0": t0,
            "log": log,
            "k_steps": k,
            "tel_t0": None if tel is None else tel.to_wall(t0),
        }

    # -- the check --------------------------------------------------------------
    def check(self, mode: str) -> dict:
        """Steps 1-3 of the first flush, against the reference from the
        same weights and the same replay rows.  ``mode="control"``: the
        reference with TF32 on, against the reference."""
        cap = self.capture
        self.system = self.engine = None
        dev = self.run.device
        dqn, opt = self.cfg["dqn"], self.cfg["optimizer"]
        slots = cap["slots"]
        names = sorted({kn for kn in self.init})
        ref_losses, ref_g, ref_p3, ctl = [], {}, {}, ([], {}, {})
        bad = 0
        # the flush's state holds its jobs' rows in job order
        for pos, slot in enumerate(slots):
            p0 = {}
            for k, n in names:
                p0.setdefault(k, {})[n] = self.init[(k, n)][slot].to(dev)
            rows = [torch.as_tensor(cap["rows"][s][pos], device=dev) for s in range(STEPS_CHECKED)]
            bad += sum(int(self.ref.invalid_rows(dqn, r)) for r in rows)
            self.ref.precision(False)
            losses, g1, after = self.ref.train(dqn, opt, p0, rows)
            ref_losses.append(losses)
            for k, n in names:
                ref_g[(slot, k, n)] = g1[(k, n)].cpu()
                ref_p3[(slot, k, n)] = (after[-1][k][n] - p0[k][n]).cpu()
            if mode == "control":
                self.ref.precision(True)
                closs, cg1, cafter = self.ref.train(dqn, opt, p0, rows)
                self.ref.precision(False)
                ctl[0].append(closs)
                for k, n in names:
                    ctl[1][(slot, k, n)] = cg1[(k, n)].cpu()
                    ctl[2][(slot, k, n)] = (cafter[-1][k][n] - p0[k][n]).cpu()
        ref_g, ref_p3 = compare.norms(ref_g), compare.norms(ref_p3)
        keep = compare.kept_leaves(ref_g)
        if mode == "control":
            got_losses, got_g, got_p3 = ctl
        else:
            b1 = opt["b1"]
            got_losses = [
                [cap["losses"][s][pos] for s in range(STEPS_CHECKED)]
                for pos in range(len(slots))
            ]
            got_g, got_p3 = {}, {}
            for pos, slot in enumerate(slots):
                for k, n in names:
                    got_g[(slot, k, n)] = cap["m1"][(k, n)][pos] / (1 - b1)
                    p3 = cap["p3"][(k, n)][pos]
                    got_p3[(slot, k, n)] = p3 - self.init[(k, n)][slot]
        flat = lambda rows: [x for r in rows for x in r]  # noqa: E731
        grad_gap, self.worst_grad = compare.worst_leaf(compare.norms(got_g), ref_g, keep)
        change_gap, self.worst_change = compare.worst_leaf(compare.norms(got_p3), ref_p3, keep)
        return {
            "loss_gap": compare.rel_gap(flat(got_losses), flat(ref_losses)),
            "grad_gap": grad_gap,
            "change_gap": change_gap,
            "bad_rows": bad,
        }


# -- what the metric readers take from a window --------------------------------
def profiled_flushes(run) -> list[int] | None:
    """The job counts of the flushes that ran while the profiler was on."""
    p = run.profile
    if p is None:
        return None
    return [n for t, _, _, sizes in run.window["log"] if p.t0 < t <= p.t1 for n in sizes]


def before_profile(run) -> tuple[float, int, int] | None:
    """(seconds, agent steps, collected rows) from the window's start to
    the boundary where the profiler started."""
    p, w = run.profile, run.window
    if p is None:
        return None
    done = [e for e in w["log"] if e[0] <= p.t0]
    if not done:
        return None
    t, steps, rows, _ = done[-1]
    return t - w["t0"], steps, rows
