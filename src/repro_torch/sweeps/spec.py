"""Frozen sweep descriptions and their deterministic grid expansion.

A :class:`SweepSpec` is scenario × seed-list × parameter overrides: each
:class:`SweepVariant` names a registered
:class:`~repro_torch.experiments.spec.ScenarioSpec` plus dotted-path overrides
(``"sys.rounds"``, ``"dqn.batch_size"``, ``"n_patients"``), and
:meth:`SweepSpec.expand` derives one fully resolved ``ScenarioSpec`` per
(variant, seed) cell via ``replace``/``with_seed``/``fast``.

Every cell carries a content-addressed key — a stable hash of the fully
derived spec plus the seed and the device type it runs on (``cuda`` or
``cpu``: a CPU run's rows are never served as the card's) — so the on-disk
:class:`~repro_torch.sweeps.store.ReportStore` can skip completed cells across
interrupted runs and across processes.  The hash walks the dataclass
tree into canonical JSON (floats via ``repr``, mappings sorted), so it
does not depend on ``PYTHONHASHSEED`` or field declaration accidents.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from dataclasses import dataclass, replace
from typing import Any

from repro_torch.device import device_type
from repro_torch.experiments.registry import get_scenario
from repro_torch.experiments.spec import ScenarioSpec

#: metrics aggregated per variant (all are costs: lower is better)
DEFAULT_METRICS = (
    "mean_dist_err",
    "forgetting",
    "sim_makespan",
    "comm_time",
    "total_bytes",
)


def _canon(x: Any) -> Any:
    """Canonical JSON-able form of a (nested) dataclass value."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        d = {f.name: _canon(getattr(x, f.name)) for f in dataclasses.fields(x)}
        d["__type__"] = type(x).__name__
        return d
    if isinstance(x, (list, tuple)):
        return [_canon(v) for v in x]
    if isinstance(x, dict):
        return {str(k): _canon(v) for k, v in sorted(x.items())}
    if isinstance(x, float):
        return repr(x)  # stable for inf/nan and round-trippable precision
    return x


def spec_hash(spec: ScenarioSpec) -> str:
    """Content hash of a fully derived scenario spec."""
    payload = json.dumps(_canon(spec), sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(payload.encode()).hexdigest()


def apply_overrides(
    spec: ScenarioSpec, overrides: tuple[tuple[str, Any], ...]
) -> ScenarioSpec:
    """Apply dotted-path field overrides to a frozen spec.

    ``("sys.rounds", 2)`` replaces a field of the nested ``ADFLLConfig``;
    ``("n_patients", 8)`` a top-level spec field.  Unknown paths raise —
    a sweep must not silently no-op a typo."""
    for path, value in overrides:
        head, _, rest = path.partition(".")
        if not hasattr(spec, head):
            raise ValueError(f"override path {path!r}: no field {head!r}")
        if rest:
            inner = getattr(spec, head)
            if not hasattr(inner, rest):
                raise ValueError(f"override path {path!r}: no field {rest!r}")
            value = replace(inner, **{rest: value})
        if isinstance(value, list):
            value = tuple(value)
        spec = replace(spec, **{head: value})
    return spec


@dataclass(frozen=True)
class SweepVariant:
    """One row of the sweep grid: a scenario plus overrides."""

    label: str
    scenario: str  # registered ScenarioSpec name
    overrides: tuple[tuple[str, Any], ...] = ()

    def derive(self, seed: int, *, fast: bool = False) -> ScenarioSpec:
        """The fully resolved ScenarioSpec for one cell."""
        spec = apply_overrides(get_scenario(self.scenario), self.overrides)
        spec = spec.with_seed(seed)
        return spec.fast() if fast else spec


@dataclass(frozen=True)
class SweepCell:
    """One executable grid cell: (variant, seed) with its derived spec, on
    one device type."""

    sweep: str
    label: str
    scenario: str
    seed: int
    spec: ScenarioSpec
    device: str  # "cuda" or "cpu"
    key: str  # "<label>:<seed>:<device>:<spec_hash>" — the ReportStore key

    @staticmethod
    def make(
        sweep: str, variant: SweepVariant, seed: int, *, fast: bool, device: str
    ):
        spec = variant.derive(seed, fast=fast)
        key = f"{variant.label}:{seed}:{device}:{spec_hash(spec)}"
        return SweepCell(
            sweep, variant.label, variant.scenario, seed, spec, device, key
        )


@dataclass(frozen=True)
class SweepSpec:
    """One named multi-seed sweep grid."""

    name: str
    description: str = ""
    variants: tuple[SweepVariant, ...] = ()
    seeds: tuple[int, ...] = (0, 1, 2, 3, 4)
    # paired significance anchors on this variant label (None = no pairs)
    baseline: str | None = None
    metrics: tuple[str, ...] = DEFAULT_METRICS
    # wall-clock budget per cell in seconds (None = unlimited); the
    # executor marks over-budget cells failed, which fails the sweep
    cell_budget_s: float | None = None

    def __post_init__(self):
        if not self.variants:
            raise ValueError(f"sweep {self.name!r} has no variants")
        labels = [v.label for v in self.variants]
        if len(set(labels)) != len(labels):
            raise ValueError(f"sweep {self.name!r} has duplicate variant labels")
        if not self.seeds or len(set(self.seeds)) != len(self.seeds):
            raise ValueError(f"sweep {self.name!r} needs a non-empty unique seed list")
        if self.baseline is not None and self.baseline not in labels:
            raise ValueError(
                f"sweep {self.name!r}: baseline {self.baseline!r} is not a variant"
            )

    def with_seeds(self, seeds: tuple[int, ...]) -> "SweepSpec":
        return dataclasses.replace(self, seeds=tuple(seeds))

    def expand(
        self, *, fast: bool = False, device: str | None = None
    ) -> tuple[SweepCell, ...]:
        """The deterministic grid on ``device`` (``None`` = the CUDA
        card): variants outer, seeds inner.

        Expansion is pure derivation from frozen specs — two expansions
        (in this process or any other) yield bit-identical keys."""
        dev = device_type(device)
        return tuple(
            SweepCell.make(self.name, v, s, fast=fast, device=dev)
            for v in self.variants
            for s in self.seeds
        )

    def grid_index(
        self, *, fast: bool = False, device: str | None = None
    ) -> dict[str, SweepCell]:
        return {c.key: c for c in self.expand(fast=fast, device=device)}


__all__ = [
    "DEFAULT_METRICS",
    "SweepCell",
    "SweepSpec",
    "SweepVariant",
    "apply_overrides",
    "spec_hash",
]
