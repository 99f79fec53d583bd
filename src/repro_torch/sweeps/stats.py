"""Scipy-free significance tests and confidence intervals for sweeps.

Promoted from ``benchmarks/stats.py`` (which now re-exports from here):
the regularized incomplete beta gives the Student-t tail, on top of
which sit the paired t-test, a t-based mean confidence interval, and a
paired sign-flip permutation test (exact over all ``2^n`` sign patterns
for small n, seeded Monte Carlo beyond that).  Effect-size companions:
paired Cohen's ``d_z`` and a seeded percentile-bootstrap interval for
the mean of the paired deltas.

Edge cases are explicit and tested: n < 2 yields ``(nan, nan)`` /
``nan`` half-widths / p = 1.0 (no evidence either way), and
zero-variance differences yield ``t = 0, p = 1.0``.
"""

from __future__ import annotations

import itertools
import math
from collections.abc import Sequence

import numpy as np


def _betacf(a, b, x, max_iter=200, eps=3e-12):
    qab, qap, qam = a + b, a + 1.0, a - 1.0
    c, d = 1.0, 1.0 - qab * x / qap
    if abs(d) < 1e-30:
        d = 1e-30
    d = 1.0 / d
    h = d
    for m in range(1, max_iter + 1):
        m2 = 2 * m
        aa = m * (b - m) * x / ((qam + m2) * (a + m2))
        d = 1.0 + aa * d
        if abs(d) < 1e-30:
            d = 1e-30
        c = 1.0 + aa / c
        if abs(c) < 1e-30:
            c = 1e-30
        d = 1.0 / d
        h *= d * c
        aa = -(a + m) * (qab + m) * x / ((a + m2) * (qap + m2))
        d = 1.0 + aa * d
        if abs(d) < 1e-30:
            d = 1e-30
        c = 1.0 + aa / c
        if abs(c) < 1e-30:
            c = 1e-30
        d = 1.0 / d
        delta = d * c
        h *= delta
        if abs(delta - 1.0) < eps:
            break
    return h


def _betainc(a, b, x):
    if x <= 0.0:
        return 0.0
    if x >= 1.0:
        return 1.0
    ln_beta = (
        math.lgamma(a + b)
        - math.lgamma(a)
        - math.lgamma(b)
        + a * math.log(x)
        + b * math.log(1.0 - x)
    )
    front = math.exp(ln_beta)
    if x < (a + 1.0) / (a + b + 2.0):
        return front * _betacf(a, b, x) / a
    return 1.0 - front * _betacf(b, a, 1.0 - x) / b


def t_sf(t, df):
    """Two-sided p-value for a t statistic."""
    x = df / (df + t * t)
    return _betainc(df / 2.0, 0.5, x)


def t_crit(alpha: float, df: int) -> float:
    """The two-sided critical value: ``t_sf(t_crit, df) == alpha``.

    Bisection on the monotone tail — no scipy inverse needed."""
    if df < 1:
        return float("nan")
    lo, hi = 0.0, 1e3
    while t_sf(hi, df) > alpha:  # pathological alpha: widen
        hi *= 10.0
        if hi > 1e12:
            return float("inf")
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        if t_sf(mid, df) > alpha:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


def paired_ttest(a, b) -> tuple[float, float]:
    """Returns (t, two-sided p). a, b: paired samples.

    n < 2 has no t distribution: returns ``(nan, nan)``.  Zero-variance
    differences return ``(0.0, 1.0)`` (identical trajectories are not
    evidence of a difference)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    d = a - b
    n = len(d)
    if n < 2:
        return float("nan"), float("nan")
    sd = d.std(ddof=1)
    if sd == 0:
        return 0.0, 1.0
    t = d.mean() / (sd / math.sqrt(n))
    return float(t), float(t_sf(abs(t), n - 1))


def paired_permutation_test(
    a, b, *, n_resamples: int = 10_000, seed: int = 0
) -> float:
    """Two-sided p for ``mean(a - b) != 0`` under paired sign-flips.

    The null distribution flips the sign of each paired difference
    independently.  All ``2^n`` patterns are enumerated exactly while
    ``2^n <= n_resamples``; beyond that a seeded Monte Carlo sample is
    drawn and the add-one estimator keeps p > 0.  n < 2 returns 1.0
    (a single pair cannot reach significance), as do all-zero
    differences."""
    d = np.asarray(a, np.float64) - np.asarray(b, np.float64)
    n = len(d)
    if n < 2 or not np.any(d):
        return 1.0
    obs = abs(float(d.mean()))
    tol = 1e-12 * max(1.0, obs)
    if 2**n <= n_resamples:
        hits = 0
        for signs in itertools.product((1.0, -1.0), repeat=n):
            if abs(float(np.dot(signs, d)) / n) >= obs - tol:
                hits += 1
        return hits / 2**n
    rng = np.random.default_rng(seed)
    signs = rng.choice((-1.0, 1.0), size=(n_resamples, n))
    means = np.abs(signs @ d) / n
    hits = int(np.sum(means >= obs - tol))
    return float((hits + 1) / (n_resamples + 1))


def cohens_d(a, b) -> float:
    """Paired effect size ``d_z = mean(a - b) / sd(a - b)``.

    The standardized size of a paired delta — p-values say whether an
    effect exists, ``d_z`` says whether it is big enough to care about
    (|d| ~ 0.2 small / 0.5 medium / 0.8 large, Cohen's conventions).

    n < 2 returns nan (no spread to standardize by).  Zero-variance
    differences return signed inf for a nonzero mean shift (every pair
    moved by exactly the same amount) and 0.0 when the trajectories are
    identical."""
    d = np.asarray(a, np.float64) - np.asarray(b, np.float64)
    n = len(d)
    if n < 2:
        return float("nan")
    sd = float(d.std(ddof=1))
    mean = float(d.mean())
    if sd == 0.0:
        return 0.0 if mean == 0.0 else math.copysign(float("inf"), mean)
    return mean / sd


def bootstrap_ci(
    values: Sequence[float],
    *,
    confidence: float = 0.95,
    n_resamples: int = 10_000,
    seed: int = 0,
) -> tuple[float, float]:
    """Seeded percentile-bootstrap interval ``(lo, hi)`` for the mean.

    Distribution-free companion to the t-based :func:`mean_ci` — with
    the handful of seeds a sweep runs, paired deltas are often visibly
    non-normal (one outlier seed) and the t interval under- or
    over-covers.  n == 0 returns ``(nan, nan)``; n == 1 returns
    ``(x, x)`` (resampling one value only ever yields itself)."""
    x = np.asarray(list(values), np.float64)
    n = len(x)
    if n == 0:
        return float("nan"), float("nan")
    if n == 1:
        return float(x[0]), float(x[0])
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, n, size=(n_resamples, n))
    means = x[idx].mean(axis=1)
    tail = 100.0 * (1.0 - confidence) / 2.0
    lo, hi = np.percentile(means, [tail, 100.0 - tail])
    return float(lo), float(hi)


def holm_bonferroni(pvalues: Sequence[float | None]) -> list[float | None]:
    """Holm's step-down adjusted p-values for a family of comparisons.

    The sweep summary tests every (variant, metric) pair against the
    baseline — m hypotheses, so the chance of at least one spurious
    p < alpha grows with m.  Holm's procedure controls the family-wise
    error rate uniformly better than plain Bonferroni: sort the valid
    p-values ascending, multiply the k-th smallest by ``m - k`` (1-based:
    ``m, m-1, ...``), enforce monotonicity with a running max, and clip
    to 1.  Gating on the adjusted p keeps a 20-comparison table from
    flagging one of them at raw p = 0.03 by luck alone.

    ``None`` and NaN entries (n < 2 pairs) are passed through unchanged
    in their original positions and do not count toward the family size
    m."""
    valid: dict[int, float] = {}
    for i, p in enumerate(pvalues):
        if p is None:
            continue
        v = float(p)
        if v == v:  # drop NaN
            valid[i] = v
    m = len(valid)
    out: list[float | None] = list(pvalues)
    if m == 0:
        return out
    running = 0.0
    for k, i in enumerate(sorted(valid, key=valid.__getitem__)):
        running = max(running, (m - k) * valid[i])
        out[i] = min(1.0, running)
    return out


def mean_ci(
    values: Sequence[float], *, confidence: float = 0.95
) -> tuple[float, float]:
    """(mean, half-width) of the t-based confidence interval.

    n == 0 returns ``(nan, nan)``; n == 1 returns ``(x, nan)`` (a single
    run has no spread to bound); zero variance returns half-width 0."""
    x = np.asarray(list(values), np.float64)
    n = len(x)
    if n == 0:
        return float("nan"), float("nan")
    mean = float(x.mean())
    if n < 2:
        return mean, float("nan")
    sd = float(x.std(ddof=1))
    if sd == 0.0:
        return mean, 0.0
    half = t_crit(1.0 - confidence, n - 1) * sd / math.sqrt(n)
    return mean, float(half)


__all__ = [
    "bootstrap_ci",
    "cohens_d",
    "holm_bonferroni",
    "mean_ci",
    "paired_permutation_test",
    "paired_ttest",
    "t_crit",
    "t_sf",
]
