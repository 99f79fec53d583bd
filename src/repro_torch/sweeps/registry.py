"""Named sweep registry: the paper's statistical claims as sweeps.

* ``paper_table1_sweep`` — ADFLL vs. the Table 1 agents (X all-knowing,
  Y partial, M sequential lifelong) across 5 seeds, paired significance
  against ADFLL: the reproduction of the paper's headline p = 0.01
  claim (7.81 vs. 15.17 mean distance error).

The reference's ``paper_table2_hub_failure`` (hub failures) and
``ci_smoke`` (gossip) sweeps come with the slices that bring those
features.  Like scenarios, adding a sweep means registering a frozen
spec.
"""

from __future__ import annotations

from repro_torch.sweeps.spec import SweepSpec, SweepVariant

_REGISTRY: dict[str, SweepSpec] = {}


def register_sweep(sweep: SweepSpec) -> SweepSpec:
    """Add a sweep (rejects silent overwrites)."""
    if sweep.name in _REGISTRY:
        raise ValueError(f"sweep already registered: {sweep.name!r}")
    _REGISTRY[sweep.name] = sweep
    return sweep


def get_sweep(name: str) -> SweepSpec:
    try:
        return _REGISTRY[name]
    except KeyError:
        known = ", ".join(sorted(_REGISTRY))
        raise KeyError(f"unknown sweep {name!r}; registered: {known}") from None


def list_sweeps() -> list[SweepSpec]:
    return [_REGISTRY[k] for k in sorted(_REGISTRY)]


# ---------------------------------------------------------------------------
# built-in sweeps
# ---------------------------------------------------------------------------

register_sweep(
    SweepSpec(
        name="paper_table1_sweep",
        description="Table 1 significance: ADFLL vs Agent X (all-knowing) / "
        "Y (partial) / M (sequential LL) across 5 seeds, paired p-values "
        "against ADFLL (the paper's p=0.01 headline claim)",
        variants=(
            SweepVariant("adfll", "paper_fig2"),
            SweepVariant("agent_x_all_knowing", "baseline_all_knowing"),
            SweepVariant("agent_y_partial", "baseline_partial"),
            SweepVariant("agent_m_sequential", "baseline_sequential"),
        ),
        seeds=(0, 1, 2, 3, 4),
        baseline="adfll",
        cell_budget_s=1800.0,
    )
)


__all__ = ["get_sweep", "list_sweeps", "register_sweep"]
