"""A language model trains: ``Model.train_step`` (``models/model.py::
make_train_step``) on batches of ``batch`` x ``seq`` token ids drawn from
the seed, with the optimizer settings ``launch/train.py`` uses
(``launch/specs.py::opt_cfg_for``) and the port's default sharding
policy (rematerialisation on).

Set-up builds the model, hands it the weights the benchmark drew from
the seed and zero moments, and trains its first three steps, which the
check compares (they warm up every shape the window uses).  The window
trains the same state on, one step after another, until ``--seconds``
have passed, then waits for the card: a unit is a token trained.
"""

from __future__ import annotations

import time

import torch

from perfbench.drivers import lm_common
from perfbench.harness import compare

STEPS_CHECKED = 3
FAULTS = ("unchanged", "half_batch", "altered")


class Driver:
    check_needs_window = False

    def __init__(self, run):
        self.run = run
        self.c = run.cell.config
        self.tr = run.cell.traffic
        self.ref = run.cell.reference()

    def _batch(self) -> dict:
        t = self.stream(self.b, self.s + 1)
        return {"tokens": t[:, :-1].contiguous(), "labels": t[:, 1:].contiguous()}

    def setup(self) -> None:
        from repro_torch.launch.specs import opt_cfg_for
        from repro_torch.models.model import Model
        from repro_torch.optim.adamw import tree_adamw_init

        run, c = self.run, self.c
        self.b, self.s = int(self.tr["batch"]), int(self.tr["seq"])
        cfg = self.cfg = lm_common.port_config(c)
        self.opt_cfg = opt_cfg_for(cfg)
        for key, value in c["optimizer"].items():
            have = getattr(self.opt_cfg, "opt_dtype" if key == "moments" else key)
            if have != value:
                raise ValueError(f"the port's optimizer has {key}={have!r}, the file {value!r}")
        self.model = Model(cfg, run.device, opt_cfg=self.opt_cfg)
        params = lm_common.draw_params(cfg, run.seed, run.device)
        self.p0 = {k: t.to("cpu", copy=True) for k, t in lm_common.leaf_slices(params)}
        self.state = {"params": params, "opt": tree_adamw_init(self.opt_cfg, params)}
        run.note("model, weights and moments built")
        self.stream = lm_common.TokenStream(run.seed, cfg.vocab_size, run.device)
        self._plant_fault()
        self.batches, self.losses = [], []
        b1 = self.opt_cfg.b1
        for i in range(STEPS_CHECKED):
            batch = self._batch()
            self.batches.append({k: v.cpu() for k, v in batch.items()})
            self.state, metrics = self.step(self.state, batch)
            self.losses.append(float(metrics["total"]))
            if i == 0:
                # the first gradient as AdamW took it, from its first
                # moment: each leaf's norm, and the leaf itself on the host
                m1 = dict(lm_common.leaf_slices(self.state["opt"]["m"]))
                self.g1 = {k: float(t.double().norm()) / (1 - b1) for k, t in m1.items()}
                self.g1_host = {k: t.to("cpu", copy=True) for k, t in m1.items()}
                del m1
        self.change = {}
        with torch.no_grad():
            for k, t in lm_common.leaf_slices(self.state["params"]):
                d = t.float() - self.p0[k].to(run.device).float()
                self.change[k] = float(d.double().norm())
        if run.device.type == "cuda":
            torch.cuda.synchronize(run.device)

    def _plant_fault(self) -> None:
        step, fault = self.model.train_step, self.run.fault
        if fault is None:
            self.step = step
            return
        if fault not in FAULTS:
            raise ValueError(f"unknown fault {fault!r}; have {FAULTS}")

        def broken(state, batch):
            if fault == "half_batch":
                half = max(1, batch["tokens"].shape[0] // 2)
                return step(state, {k: v[:half] for k, v in batch.items()})
            if fault == "altered":
                labels = batch["labels"].clone()
                labels[0] = labels[0].roll(1)
                return step(state, dict(batch, labels=labels))
            params = {k: v for k, v in lm_common.leaf_slices(state["params"])}
            saved = {k: v.clone() for k, v in params.items()}
            new, metrics = step(state, batch)
            for k, v in lm_common.leaf_slices(new["params"]):
                v.copy_(saved[k])
            return new, metrics

        self.step = broken

    def window(self, seconds: float) -> None:
        run = self.run
        tokens_per_step = self.b * self.s
        totals, gnorms = [], []
        steps = 0
        t0 = run.start_window()
        deadline = t0 + seconds
        while True:
            self.state, metrics = self.step(self.state, self._batch())
            totals.append(metrics["total"])
            gnorms.append(metrics["grad_norm"])
            steps += 1
            run.tick(steps * tokens_per_step)
            if time.perf_counter() >= deadline:
                break
        if run.device.type == "cuda":
            torch.cuda.synchronize(run.device)
        t1 = time.perf_counter()
        units = steps * tokens_per_step
        unprofiled_s = run.end_window(units)
        finite = torch.isfinite(torch.stack(totals)) & torch.isfinite(torch.stack(gnorms))
        run.attempted = steps
        run.failed = int((~finite).sum())
        prof = run.profiler
        run.window = {
            "seconds": t1 - t0,
            "units": units,
            "steps": steps,
            "unprofiled_s": unprofiled_s,
            "tokens_per_step": tokens_per_step,
            "profiled_from": None if prof is None else prof.started_at,
        }
        run.window["model"] = {"cfg": self.cfg, "batch": self.b, "seq": self.s}

    def check(self, mode: str) -> dict:
        """Steps 1-3 against the reference from the same weights and
        batches: each step's loss, each leaf's first gradient (the
        program's from its first moment) and its change over the three.
        ``mode="control"``: the reference in float8 against the
        reference."""
        dev = self.run.device
        self.state = self.model = None
        from perfbench.harness.runner import free_device

        free_device()
        c, opt = self.c, self.c["optimizer"]
        batches = [(b["tokens"].to(dev), b["labels"].to(dev)) for b in self.batches]

        b1 = self.opt_cfg.b1
        if mode == "control":
            low: dict = {}

            def keep_low(key, g):
                low[key] = g.to("cpu", copy=True)

            self.ref.precision("fp8")
            got = self._reference_run(c, opt, batches, dev, keep_low)
            against = low.__getitem__
        else:
            got = (self.losses, self.g1, self.change)

            def against(key):
                return self.g1_host[key] / (1 - b1)

        diff: dict = {}

        def on_first(key, g):
            # each leaf's relative norm of the difference of the two
            # sides' first gradients
            other = against(key).to(dev).float()
            diff[key] = float((other - g).double().norm()) / max(float(g.double().norm()), 1e-30)

        self.ref.precision("fp32")
        ref = self._reference_run(c, opt, batches, dev, on_first)
        keep = compare.kept_leaves(ref[1])
        grad_gap, self.worst_grad = compare.worst_leaf(got[1], ref[1], keep)
        change_gap, self.worst_change = compare.worst_leaf(got[2], ref[2], keep)
        return {
            "loss_gap": compare.rel_gap(got[0], ref[0]),
            "grad_gap": grad_gap,
            "change_gap": change_gap,
            "grad_gap_median": compare.median_gap(got[1], ref[1], keep),
            "change_gap_median": compare.median_gap(got[2], ref[2], keep),
            "grad_diff_median": compare.median_of(diff, keep),
        }

    def _reference_run(self, c, opt, batches, dev, on_first):
        """The reference's readings at the precision set (the control's),
        its first gradient handed to ``on_first``."""
        from perfbench.harness.runner import free_device

        params = self._params_from_p0(dev)
        losses, g1 = self.ref.train(c, opt, params, batches, on_first)
        change = {}
        with torch.no_grad():
            for k, t in lm_common.leaf_slices(params):
                change[k] = float((t.float() - self.p0[k].to(dev).float()).double().norm())
        del params
        free_device()
        self.ref.precision("fp32")
        return losses, g1, change

    def _params_from_p0(self, dev) -> dict:
        """The weights set-up drew, as the program's tree, on ``dev``."""
        tree: dict = {}
        stacked: dict = {}
        for (path, g), t in self.p0.items():
            if g is None:
                node = tree
                for k in path[:-1]:
                    node = node.setdefault(k, {})
                node[path[-1]] = t.to(dev, copy=True)
            else:
                stacked.setdefault(path, {})[g] = t
        for path, parts in stacked.items():
            node = tree
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = torch.stack([parts[g] for g in sorted(parts)]).to(dev)
        return tree
