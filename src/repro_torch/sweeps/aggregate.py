"""Significance-aware aggregation of per-seed reports.

Folds the per-cell rows a sweep produced into one summary document:

* per variant, per metric — mean ± 95% CI (t-based, scipy-free), std,
  n, and the per-seed values (kept so two summaries can later be
  *paired* by seed);
* per (baseline, variant) pair — paired t-test and paired sign-flip
  permutation p-values on each metric, seeds paired positionally by
  value (the grid guarantees every variant ran the same seed list);
* the cell ledger — status, elapsed wall time, cached-or-executed —
  so a summary is also an execution audit.

:func:`compare` diffs two summary documents (the ``--compare`` CLI
mode): a per-metric delta table with p-values, flagging *significant
regressions* (worse mean on a gated metric with p below alpha).
"""

from __future__ import annotations

import math
from collections.abc import Sequence
from typing import Any

from repro_torch.sweeps.spec import SweepSpec
from repro_torch.sweeps.stats import (
    bootstrap_ci,
    cohens_d,
    holm_bonferroni,
    mean_ci,
    paired_permutation_test,
    paired_ttest,
)
from repro_torch.sweeps.store import STATUS_OK, Row

#: metrics whose significant increase fails a comparison gate
GATE_METRICS = ("mean_dist_err", "forgetting")


def _finite(x: Any) -> float | None:
    """float(x) if it is a finite number, else None (JSON-safe)."""
    if x is None:
        return None
    try:
        v = float(x)
    except (TypeError, ValueError):
        return None
    return v if math.isfinite(v) else None


def forgetting_of(summary: dict[str, Any]) -> float | None:
    """Error increase from the best probe to the final evaluation.

    ``max(0, final - min_over_curve)`` over the report's eval curve: 0
    when the final evaluation is the best seen (nothing forgotten), the
    recovery gap otherwise.  Scenarios without probes have a one-point
    curve and therefore forgetting 0."""
    curve = summary.get("eval_curve") or []
    errs = [_finite(p.get("mean_err")) for p in curve]
    errs = [e for e in errs if e is not None]
    if not errs:
        return None
    return max(0.0, errs[-1] - min(errs))


def _metric_values(rows: Sequence[Row], metric: str) -> dict[str, float]:
    """seed (as str, JSON-stable) -> finite metric value."""
    out: dict[str, float] = {}
    for r in rows:
        v = _finite((r.get("summary") or {}).get(metric))
        if v is not None:
            out[str(r["seed"])] = v
    return out


def _pair(
    a: dict[str, float], b: dict[str, float]
) -> tuple[list[float], list[float], list[str]]:
    seeds = sorted(set(a) & set(b), key=lambda s: (len(s), s))
    return [a[s] for s in seeds], [b[s] for s in seeds], seeds


def _stats_entry(values: dict[str, float]) -> dict[str, Any]:
    xs = [values[s] for s in sorted(values, key=lambda s: (len(s), s))]
    mean, half = mean_ci(xs)
    std = None
    if len(xs) >= 2:
        m = sum(xs) / len(xs)
        std = math.sqrt(sum((x - m) ** 2 for x in xs) / (len(xs) - 1))
    return {
        "mean": _finite(mean),
        "ci95": _finite(half),
        "std": _finite(std),
        "n": len(xs),
        "values": values,
    }


def summarize(
    sweep: SweepSpec,
    rows: Sequence[Row],
    *,
    fast: bool = False,
    device: str | None = None,
) -> dict[str, Any]:
    """The sweep summary document (what ``--json`` writes); ``device`` is
    the device type the cells ran on."""
    by_label: dict[str, list[Row]] = {v.label: [] for v in sweep.variants}
    for r in rows:
        if r.get("label") in by_label and r.get("status") == STATUS_OK:
            by_label[r["label"]].append(r)
    for vrows in by_label.values():
        vrows.sort(key=lambda r: int(r["seed"]))

    variants: dict[str, Any] = {}
    for v in sweep.variants:
        vrows = by_label[v.label]
        variants[v.label] = {
            "scenario": v.scenario,
            "overrides": [list(o) for o in v.overrides],
            "n_ok": len(vrows),
            "metrics": {
                m: _stats_entry(_metric_values(vrows, m)) for m in sweep.metrics
            },
        }

    comparisons: list[dict[str, Any]] = []
    if sweep.baseline is not None:
        base_rows = by_label[sweep.baseline]
        for v in sweep.variants:
            if v.label == sweep.baseline:
                continue
            for m in sweep.metrics:
                a, b, seeds = _pair(
                    _metric_values(base_rows, m),
                    _metric_values(by_label[v.label], m),
                )
                if not seeds:
                    continue
                t, p_t = paired_ttest(b, a)
                deltas = [y - x for x, y in zip(a, b, strict=True)]
                ci_lo, ci_hi = bootstrap_ci(deltas)
                comparisons.append(
                    {
                        "baseline": sweep.baseline,
                        "variant": v.label,
                        "metric": m,
                        "n": len(seeds),
                        "mean_baseline": _finite(sum(a) / len(a)),
                        "mean_variant": _finite(sum(b) / len(b)),
                        "delta": _finite(sum(b) / len(b) - sum(a) / len(a)),
                        "delta_ci95": [_finite(ci_lo), _finite(ci_hi)],
                        "cohens_d": _finite(cohens_d(b, a)),
                        "t": _finite(t),
                        "p_ttest": _finite(p_t),
                        "p_permutation": _finite(paired_permutation_test(b, a)),
                    }
                )
        # Holm–Bonferroni across the whole comparison family: every
        # (variant, metric) pair tested against the baseline is one
        # hypothesis, so gate-worthy significance must survive the
        # step-down adjustment, not just the raw paired t.
        adj = holm_bonferroni([c["p_ttest"] for c in comparisons])
        for c, p_adj in zip(comparisons, adj, strict=True):
            c["p_ttest_adj"] = _finite(p_adj)

    cells = [
        {
            "key": r["key"],
            "label": r.get("label"),
            "scenario": r.get("scenario"),
            "seed": r.get("seed"),
            "device": r.get("device"),
            "status": r.get("status"),
            "elapsed_s": _finite(r.get("elapsed_s")),
            "cached": bool(r.get("cached", False)),
            "error": r.get("error"),
        }
        for r in rows
    ]
    return {
        "benchmark": "sweeps",
        "sweep": sweep.name,
        "fast": bool(fast),
        "device": device,
        "seeds": list(sweep.seeds),
        "baseline": sweep.baseline,
        "cell_budget_s": sweep.cell_budget_s,
        "variants": variants,
        "comparisons": comparisons,
        "cells": cells,
    }


def compare(
    a: dict[str, Any],
    b: dict[str, Any],
    *,
    alpha: float = 0.05,
    gate_metrics: Sequence[str] = GATE_METRICS,
) -> tuple[list[dict[str, Any]], list[dict[str, Any]]]:
    """Diff two sweep summaries; returns (delta rows, regressions).

    Rows pair per-seed values variant-by-variant and metric-by-metric.
    A *regression* is a gated metric that got significantly worse
    (higher mean, Holm-adjusted paired-t p < alpha across the whole
    comparison family); callers exit nonzero when the regression list
    is non-empty."""
    rows: list[dict[str, Any]] = []
    va, vb = a.get("variants", {}), b.get("variants", {})
    for label in sorted(set(va) & set(vb)):
        ma, mb = va[label].get("metrics", {}), vb[label].get("metrics", {})
        for metric in [m for m in ma if m in mb]:
            xs, ys, seeds = _pair(
                ma[metric].get("values", {}), mb[metric].get("values", {})
            )
            if not seeds:
                continue
            mean_a, mean_b = sum(xs) / len(xs), sum(ys) / len(ys)
            t, p_t = paired_ttest(ys, xs)
            p_perm = paired_permutation_test(ys, xs)
            deltas = [y - x for x, y in zip(xs, ys, strict=True)]
            ci_lo, ci_hi = bootstrap_ci(deltas)
            rows.append(
                {
                    "variant": label,
                    "metric": metric,
                    "n": len(seeds),
                    "mean_a": _finite(mean_a),
                    "mean_b": _finite(mean_b),
                    "delta": _finite(mean_b - mean_a),
                    "delta_ci95": [_finite(ci_lo), _finite(ci_hi)],
                    "cohens_d": _finite(cohens_d(ys, xs)),
                    "pct": _finite(
                        100.0 * (mean_b - mean_a) / abs(mean_a) if mean_a else None
                    ),
                    "t": _finite(t),
                    "p_ttest": _finite(p_t),
                    "p_permutation": _finite(p_perm),
                }
            )
    # Significance is decided on the Holm-adjusted p across the whole
    # table — a 20-row diff should not flag a regression because one
    # raw p dipped below alpha by multiplicity alone.
    adj = holm_bonferroni([r["p_ttest"] for r in rows])
    for r, p_adj in zip(rows, adj, strict=True):
        r["p_ttest_adj"] = _finite(p_adj)
        significant = r["p_ttest_adj"] is not None and r["p_ttest_adj"] < alpha
        r["significant"] = significant
        r["regression"] = bool(
            significant
            and r["metric"] in gate_metrics
            and r["mean_b"] is not None
            and r["mean_a"] is not None
            and r["mean_b"] > r["mean_a"]
        )
    return rows, [r for r in rows if r["regression"]]


__all__ = ["GATE_METRICS", "compare", "forgetting_of", "summarize"]
