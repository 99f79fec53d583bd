"""The numbers a training cell's check compares, taken by the worst
leaf: the gap between the program's norm of a leaf and the reference's,
over the reference's norm of that leaf or of the median leaf, whichever
is larger.  Leaves whose reference gradient is under a thousandth of the
median leaf's (round-off under Adam moves them) are left out of both."""

from __future__ import annotations

import statistics

NEGLIGIBLE = 1e-3  # of the median leaf's gradient norm


def norms(tree: dict) -> dict:
    """``{leaf: tensor}`` -> ``{leaf: its norm}``."""
    return {k: float(t.double().norm()) for k, t in tree.items()}


def kept_leaves(ref_grad_norms: dict) -> set:
    """The leaves compared: those whose reference gradient norm is at
    least :data:`NEGLIGIBLE` of the median leaf's."""
    med = statistics.median(ref_grad_norms.values())
    return {k for k, v in ref_grad_norms.items() if v >= NEGLIGIBLE * med}


def worst_leaf(prog: dict, ref: dict, keep: set) -> tuple[float, object]:
    """(the worst gap, its leaf) of two ``{leaf: norm}`` maps."""
    med = statistics.median(ref[k] for k in keep)
    return max((abs(prog[k] - ref[k]) / max(ref[k], med), k) for k in keep)


def median_gap(prog: dict, ref: dict, keep: set) -> float:
    """The median over the kept leaves of the same per-leaf gap: steady
    where the worst leaf is one whose gradient hangs on the experts each
    token is routed to (a router), which rounding flips."""
    med = statistics.median(ref[k] for k in keep)
    return statistics.median(abs(prog[k] - ref[k]) / max(ref[k], med) for k in keep)


def median_of(per_leaf: dict, keep: set) -> float:
    """The median over the kept leaves of a per-leaf reading."""
    return statistics.median(per_leaf[k] for k in keep)


def rel_gap(prog: list[float], ref: list[float]) -> float:
    """The largest relative gap of paired scalars (losses)."""
    return max(abs(p - r) / max(abs(r), 1e-12) for p, r in zip(prog, ref, strict=True))
