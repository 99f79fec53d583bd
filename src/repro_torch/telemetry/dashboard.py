"""Self-contained HTML dashboard rendered from telemetry traces.

:func:`render_dashboard` turns one ``load_trace``-shaped document
(``{"events": [...], "metrics": [...]}``) into a single HTML string
with every asset inline — pure stdlib, inline SVG charts, a few lines
of inline JS for panel collapsing, zero external requests — so the file
works as a CI artifact opened from disk.

Panels (each silently omitted when its data is absent):

* **Learning dynamics** — per-agent loss timelines from ``agent.loss``
  counter events (one polyline per agent track).
* **Staleness heatmap** — per-agent ``mix.staleness`` histogram series
  as a bucket-shaded grid.
* **Knowledge propagation** — ERB creation->consumption and gossip
  delivery latency CDFs from the ``propagation.*_latency_s``
  histograms (epidemic coverage curves).
* **Health** — status banner + incident table from ``health.*``
  instants and the ``health.incidents`` counters.
* **Span aggregates** — top tracing spans by total duration (the
  flame-graph's table form).
* **Metrics** — counter / gauge series dump.
* **Sweep comparison** (optional ``sweep_summary``) — the
  ``repro_torch.sweeps`` summary's comparison rows, Holm-adjusted p included.

Entry points: ``--dashboard PATH`` on ``python -m repro_torch.experiments``
(live run), or
``python -m repro_torch.telemetry dashboard trace.jsonl -o out.html`` (saved
trace).
"""

from __future__ import annotations

import html
import json
from pathlib import Path
from typing import Any

PALETTE = (
    "#4c78a8",
    "#f58518",
    "#54a24b",
    "#e45756",
    "#72b7b2",
    "#b279a2",
    "#ff9da6",
    "#9d755d",
    "#eeca3b",
    "#bab0ac",
)

_CSS = """
body { font: 14px/1.5 system-ui, sans-serif; margin: 0; background: #f6f7f9;
       color: #1b1f24; }
header { background: #1b2a41; color: #fff; padding: 14px 24px; }
header h1 { margin: 0; font-size: 19px; }
header .sub { color: #9fb3c8; font-size: 12px; margin-top: 2px; }
section { background: #fff; margin: 14px 24px; padding: 12px 18px;
          border: 1px solid #dde3ea; border-radius: 6px; }
section h2 { font-size: 15px; margin: 0; cursor: pointer; user-select: none; }
section h2::before { content: "\\25BE "; color: #7a8799; }
section.closed h2::before { content: "\\25B8 "; }
section.closed > *:not(h2) { display: none; }
table { border-collapse: collapse; margin-top: 8px; font-size: 13px; }
th, td { border: 1px solid #dde3ea; padding: 3px 9px; text-align: right; }
th { background: #eef1f5; }
td.l, th.l { text-align: left; }
.ok { color: #1a7f37; font-weight: 600; }
.warn { color: #9a6700; font-weight: 600; }
.alert { color: #cf222e; font-weight: 600; }
.legend span { display: inline-block; margin-right: 14px; font-size: 12px; }
.legend i { display: inline-block; width: 10px; height: 10px;
            margin-right: 4px; border-radius: 2px; }
.cell { width: 26px; height: 18px; }
.muted { color: #7a8799; font-size: 12px; }
"""

_JS = """
for (const h of document.querySelectorAll("section h2"))
  h.addEventListener("click", () => h.parentElement.classList.toggle("closed"));
"""


def _esc(v: Any) -> str:
    return html.escape(str(v), quote=True)


def _fmt(v: Any) -> str:
    if isinstance(v, bool) or not isinstance(v, int | float):
        return _esc(v if v is not None else "-")
    if isinstance(v, int):
        return str(v)
    return f"{v:.4g}"


def _table(headers: list[str], rows: list[list[Any]], left: int = 1) -> str:
    """Plain HTML table; the first ``left`` columns are left-aligned."""
    th = "".join(
        f'<th class="l">{_esc(h)}</th>' if i < left else f"<th>{_esc(h)}</th>"
        for i, h in enumerate(headers)
    )
    body = []
    for row in rows:
        tds = "".join(
            f'<td class="l">{_fmt(c)}</td>' if i < left else f"<td>{_fmt(c)}</td>"
            for i, c in enumerate(row)
        )
        body.append(f"<tr>{tds}</tr>")
    return f"<table><tr>{th}</tr>{''.join(body)}</table>"


def _line_chart(
    series: list[tuple[str, list[tuple[float, float]]]],
    *,
    width: int = 680,
    height: int = 230,
    x_label: str = "",
    y_label: str = "",
) -> str:
    """Inline-SVG multi-series line chart with axes and a legend."""
    pts = [p for _, ps in series for p in ps]
    if not pts:
        return '<p class="muted">no data</p>'
    xs = [p[0] for p in pts]
    ys = [p[1] for p in pts]
    x0, x1 = min(xs), max(xs)
    y0, y1 = min(ys), max(ys)
    if x1 <= x0:
        x1 = x0 + 1.0
    if y1 <= y0:
        y1 = y0 + 1.0
    ml, mr, mt, mb = 58, 12, 8, 30  # margins
    pw, ph = width - ml - mr, height - mt - mb

    def sx(x: float) -> float:
        return ml + (x - x0) / (x1 - x0) * pw

    def sy(y: float) -> float:
        return mt + ph - (y - y0) / (y1 - y0) * ph

    parts = [
        f'<svg viewBox="0 0 {width} {height}" width="{width}" height="{height}"'
        ' xmlns="http://www.w3.org/2000/svg">'
    ]
    # axes + gridlines with tick labels
    for k in range(5):
        gy = mt + ph * k / 4
        val = y1 - (y1 - y0) * k / 4
        parts.append(
            f'<line x1="{ml}" y1="{gy:.1f}" x2="{width - mr}" y2="{gy:.1f}"'
            ' stroke="#e3e8ee"/>'
            f'<text x="{ml - 6}" y="{gy + 4:.1f}" text-anchor="end"'
            f' font-size="10" fill="#7a8799">{val:.3g}</text>'
        )
    for k in range(5):
        gx = ml + pw * k / 4
        val = x0 + (x1 - x0) * k / 4
        parts.append(
            f'<text x="{gx:.1f}" y="{height - 10}" text-anchor="middle"'
            f' font-size="10" fill="#7a8799">{val:.3g}</text>'
        )
    parts.append(
        f'<rect x="{ml}" y="{mt}" width="{pw}" height="{ph}" fill="none"'
        ' stroke="#b9c2cc"/>'
    )
    if x_label:
        parts.append(
            f'<text x="{ml + pw / 2:.0f}" y="{height - 1}" text-anchor="middle"'
            f' font-size="10" fill="#7a8799">{_esc(x_label)}</text>'
        )
    if y_label:
        parts.append(
            f'<text x="12" y="{mt + ph / 2:.0f}" font-size="10" fill="#7a8799"'
            f' transform="rotate(-90 12 {mt + ph / 2:.0f})"'
            f' text-anchor="middle">{_esc(y_label)}</text>'
        )
    legend = []
    for i, (label, ps) in enumerate(series):
        if not ps:
            continue
        color = PALETTE[i % len(PALETTE)]
        path = " ".join(f"{sx(x):.1f},{sy(y):.1f}" for x, y in sorted(ps))
        parts.append(
            f'<polyline points="{path}" fill="none" stroke="{color}"'
            f' stroke-width="1.6"><title>{_esc(label)}</title></polyline>'
        )
        legend.append(
            f'<span><i style="background:{color}"></i>{_esc(label)}</span>'
        )
    parts.append("</svg>")
    return "".join(parts) + f'<div class="legend">{"".join(legend)}</div>'


# -- trace readers -----------------------------------------------------------
def _hist_series(metrics: list[dict], name: str) -> list[dict]:
    return [m for m in metrics if m.get("kind") == "histogram" and m["name"] == name]


def _bucket_cdf(hist_value: dict) -> list[tuple[float, float]]:
    """Histogram buckets -> cumulative-fraction step points (inf bucket
    dropped: a CDF point at infinity renders nothing useful)."""
    buckets = hist_value.get("buckets") or {}
    n = hist_value.get("count") or 0
    if not n:
        return []
    finite = sorted(
        (float(b), c) for b, c in buckets.items() if b not in ("inf", "+inf")
    )
    out, cum = [], 0
    for bound, c in finite:
        cum += c
        out.append((bound, cum / n))
    return out


def _learning_panel(events: list[dict]) -> str | None:
    by_agent: dict[str, list[tuple[float, float]]] = {}
    for e in events:
        if e.get("kind") == "counter" and e.get("name") == "agent.loss":
            by_agent.setdefault(e.get("track", "?"), []).append(
                (float(e["t0"]), float(e["args"]["value"]))
            )
    if not by_agent:
        return None
    series = [(track, pts) for track, pts in sorted(by_agent.items())]
    chart = _line_chart(
        series, x_label="sim time (s)", y_label="chunk mean TD loss"
    )
    return f"<section><h2>Learning dynamics</h2>{chart}</section>"


def _staleness_panel(metrics: list[dict]) -> str | None:
    hists = _hist_series(metrics, "mix.staleness")
    if not hists:
        return None
    bounds: list[str] = []
    rows = []
    for h in sorted(hists, key=lambda m: m.get("labels", {}).get("agent", "")):
        for b in h["value"].get("buckets", {}):
            if b not in bounds:
                bounds.append(b)
    bounds.sort(key=lambda b: float("inf") if b == "inf" else float(b))
    peak = max(
        (c for h in hists for c in h["value"].get("buckets", {}).values()),
        default=1,
    )
    for h in sorted(hists, key=lambda m: m.get("labels", {}).get("agent", "")):
        agent = h.get("labels", {}).get("agent", "?")
        buckets = h["value"].get("buckets", {})
        cells = []
        for b in bounds:
            c = buckets.get(b, 0)
            alpha = (c / peak) if peak else 0.0
            cells.append(
                f'<td class="cell" style="background:rgba(76,120,168,'
                f'{alpha:.2f})"><title>{c}</title></td>'
            )
        rows.append(
            f'<tr><td class="l">agent {_esc(agent)}</td>{"".join(cells)}'
            f"<td>{h['value'].get('count', 0)}</td></tr>"
        )
    head = "".join(f"<th>&le;{_esc(b)}</th>" for b in bounds)
    table = (
        f'<table><tr><th class="l">mixes by staleness bucket</th>{head}'
        f"<th>n</th></tr>{''.join(rows)}</table>"
    )
    return f"<section><h2>Staleness heatmap</h2>{table}</section>"


def _propagation_panel(metrics: list[dict]) -> str | None:
    series = []
    for name, label in (
        ("propagation.erb_latency_s", "ERB create->remote consume"),
        ("propagation.gossip_latency_s", "gossip delivery (birth-relative)"),
    ):
        for h in _hist_series(metrics, name):
            pts = _bucket_cdf(h["value"])
            if pts:
                series.append((label, pts))
    if not series:
        return None
    chart = _line_chart(
        series, x_label="latency (sim s)", y_label="fraction covered"
    )
    return (
        "<section><h2>Knowledge propagation</h2>"
        '<p class="muted">Epidemic coverage: fraction of tracked records'
        " reaching consumers within t seconds of creation.</p>"
        f"{chart}</section>"
    )


def _health_panel(events: list[dict], metrics: list[dict]) -> str:
    incidents = [
        e
        for e in events
        if e.get("kind") == "instant" and str(e.get("name", "")).startswith("health.")
    ]
    counts = {
        m["labels"].get("kind", "?"): m["value"]
        for m in metrics
        if m.get("kind") == "counter" and m["name"] == "health.incidents"
    }
    kinds = set(counts) | {str(e["name"])[len("health.") :] for e in incidents}
    if any(k.startswith("nonfinite") for k in kinds):
        status, cls = "ALERT", "alert"
    elif kinds:
        status, cls = "WARN", "warn"
    else:
        status, cls = "OK", "ok"
    rows = [
        [
            f"{e['t0']:.4g}",
            str(e["name"])[len("health.") :],
            e.get("track", ""),
            json.dumps(e.get("args", {})),
        ]
        for e in incidents[:100]
    ]
    body = f'<p>fleet status: <span class="{cls}">{status}</span></p>'
    if counts:
        body += _table(
            ["incident kind", "count"], sorted(counts.items()), left=1
        )
    if rows:
        body += _table(["sim time", "kind", "track", "detail"], rows, left=4)
    return f"<section><h2>Health</h2>{body}</section>"


def _spans_panel(events: list[dict]) -> str | None:
    agg: dict[tuple[str, str], list[float]] = {}
    for e in events:
        if e.get("kind") != "span":
            continue
        key = (str(e.get("name", "?")), str(e.get("clock", "sim")))
        agg.setdefault(key, []).append(float(e["t1"]) - float(e["t0"]))
    if not agg:
        return None
    rows = []
    for (name, clock), durs in sorted(
        agg.items(), key=lambda kv: -sum(kv[1])
    )[:20]:
        total = sum(durs)
        rows.append(
            [name, clock, len(durs), total, total / len(durs), max(durs)]
        )
    table = _table(
        ["span", "clock", "count", "total (s)", "mean (s)", "max (s)"],
        rows,
        left=2,
    )
    return f"<section><h2>Span aggregates</h2>{table}</section>"


def _metrics_panel(metrics: list[dict]) -> str | None:
    rows = []
    for m in metrics:
        if m.get("kind") not in ("counter", "gauge"):
            continue
        labels = ",".join(f"{k}={v}" for k, v in sorted(m["labels"].items()))
        rows.append([m["name"], m["kind"], labels, m["value"]])
    if not rows:
        return None
    rows.sort(key=lambda r: (r[0], r[2]))
    table = _table(["metric", "kind", "labels", "value"], rows[:200], left=3)
    note = (
        f'<p class="muted">showing 200 of {len(rows)} series</p>'
        if len(rows) > 200
        else ""
    )
    return f"<section class='closed'><h2>Metric series</h2>{table}{note}</section>"


def _sweep_panel(sweep_summary: dict | None) -> str | None:
    if not sweep_summary:
        return None
    comparisons = sweep_summary.get("comparisons") or []
    if not comparisons:
        return None
    headers = list(comparisons[0].keys())
    rows = [[c.get(h) for h in headers] for c in comparisons]
    table = _table(headers, rows, left=2)
    return (
        "<section><h2>Sweep comparison</h2>"
        '<p class="muted">Arm vs baseline; p(t)_adj is Holm–Bonferroni'
        " adjusted across the metric family.</p>"
        f"{table}</section>"
    )


# -- entry points ------------------------------------------------------------
def render_dashboard(
    trace: dict[str, Any],
    *,
    sweep_summary: dict[str, Any] | None = None,
    title: str = "Fleet observatory",
) -> str:
    """Render one trace document into a self-contained HTML page."""
    events = trace.get("events") or []
    metrics = trace.get("metrics") or []
    panels = [
        _learning_panel(events),
        _staleness_panel(metrics),
        _propagation_panel(metrics),
        _health_panel(events, metrics),
        _spans_panel(events),
        _sweep_panel(sweep_summary),
        _metrics_panel(metrics),
    ]
    body = "".join(p for p in panels if p)
    sub = f"{len(events)} trace events &middot; {len(metrics)} metric series"
    return (
        "<!doctype html><html><head><meta charset='utf-8'>"
        f"<title>{_esc(title)}</title><style>{_CSS}</style></head><body>"
        f"<header><h1>{_esc(title)}</h1><div class='sub'>{sub}</div></header>"
        f"{body}<script>{_JS}</script></body></html>"
    )


def dashboard_from_telemetry(
    tel,
    *,
    sweep_summary: dict[str, Any] | None = None,
    title: str = "Fleet observatory",
) -> str:
    """Render a live :class:`~repro_torch.telemetry.Telemetry` bundle."""
    trace = {
        "events": list(tel.tracer.events),
        "metrics": tel.registry.summary(),
    }
    return render_dashboard(trace, sweep_summary=sweep_summary, title=title)


def write_dashboard(
    path: str | Path,
    trace: dict[str, Any],
    *,
    sweep_summary: dict[str, Any] | None = None,
    title: str = "Fleet observatory",
) -> Path:
    """Render and write; returns the written path."""
    out = Path(path)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(
        render_dashboard(trace, sweep_summary=sweep_summary, title=title)
    )
    return out


__all__ = ["dashboard_from_telemetry", "render_dashboard", "write_dashboard"]
