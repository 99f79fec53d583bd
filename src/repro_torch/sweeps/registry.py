"""Named sweep registry: the paper's statistical claims as sweeps.

* ``paper_table1_sweep`` — ADFLL vs. the Table 1 agents (X all-knowing,
  Y partial, M sequential lifelong) across 5 seeds, paired significance
  against ADFLL: the reproduction of the paper's headline p = 0.01
  claim (7.81 vs. 15.17 mean distance error).
* ``paper_table2_hub_failure`` — the Table 2 robustness comparison: a
  no-failure control against hub death mid-training, total hub death
  and hybrid gossip failover, across 5 seeds.
* ``ci_smoke`` — a 2-seed, override-shrunk grid (hub ERB plane vs
  gossip) under per-cell wall-time budgets; CI's sweep-smoke step runs
  it ``--fast``.

Like scenarios, adding a sweep means registering a frozen spec.
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

register_sweep(
    SweepSpec(
        name="paper_table2_hub_failure",
        description="Table 2 robustness: no-failure control vs hub death "
        "mid-training (re-homed), total hub death (pure hub, sharing "
        "lost) and hybrid gossip failover",
        variants=(
            SweepVariant("control", "paper_fig2"),
            SweepVariant("hub_failure", "paper_table2_hub_failure"),
            SweepVariant("total_failure", "paper_table2_total_failure"),
            SweepVariant("hybrid_failover", "paper_table2_hybrid_failover"),
        ),
        seeds=(0, 1, 2, 3, 4),
        baseline="control",
        cell_budget_s=1800.0,
    )
)

# CI-sized smoke: override-shrunk scenarios, tight wall-time budgets.
_SMOKE_OVERRIDES = (
    ("n_tasks", 2),
    ("eval_patients", 2),
    ("eval_episodes", 2),
    ("sys.rounds", 2),  # >= 2 so shared records actually flow
)

register_sweep(
    SweepSpec(
        name="ci_smoke",
        description="2-seed smoke grid (hub ERB plane vs gossip) with "
        "per-cell wall-time budgets — the CI sweep-smoke step",
        variants=(
            SweepVariant("erb_hub", "plane_erb_only", _SMOKE_OVERRIDES),
            SweepVariant("gossip", "topo_gossip", _SMOKE_OVERRIDES),
        ),
        seeds=(0, 1),
        baseline="erb_hub",
        cell_budget_s=300.0,
    )
)


__all__ = ["get_sweep", "list_sweeps", "register_sweep"]
