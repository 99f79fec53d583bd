"""Telemetry CLI: summarize, convert, and diff captured traces.

Usage::

    python -m repro_torch.telemetry summarize out.json
    python -m repro_torch.telemetry export run.jsonl run.perfetto.json
    python -m repro_torch.telemetry diff before.json after.json
    python -m repro_torch.telemetry dashboard run.jsonl -o dashboard.html

Long runs can capture traces with a bounded streaming writer
(``Telemetry(stream_path=...)``): events go straight to a size-capped
JSONL file (64 MiB by default) instead of accumulating in memory;
events past the cap are dropped and tallied in the ``trace.dropped``
counter, which every subcommand here reads back like any other
counter row.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Any

from .export import load_trace


def _span_stats(events: list[dict[str, Any]]) -> dict[str, dict[str, Any]]:
    """Per-name span aggregates: count, total/mean/max duration, clock."""
    stats: dict[str, dict[str, Any]] = {}
    for e in events:
        if e["kind"] != "span":
            continue
        dur = e["t1"] - e["t0"]
        s = stats.setdefault(
            e["name"], {"count": 0, "total": 0.0, "max": 0.0, "clock": e["clock"]}
        )
        s["count"] += 1
        s["total"] += dur
        s["max"] = max(s["max"], dur)
    for s in stats.values():
        s["mean"] = s["total"] / s["count"]
    return stats


def _instant_counts(events: list[dict[str, Any]]) -> dict[str, int]:
    out: dict[str, int] = {}
    for e in events:
        if e["kind"] == "instant":
            out[e["name"]] = out.get(e["name"], 0) + 1
    return out


def _fmt_s(x: float) -> str:
    return f"{x * 1e3:.3f}ms" if x < 1.0 else f"{x:.3f}s"


def _cmd_summarize(args: argparse.Namespace) -> int:
    trace = load_trace(args.trace)
    events = trace["events"]
    tracks = sorted({e["track"] for e in events})
    print(f"{args.trace}: {len(events)} events on {len(tracks)} tracks")
    if tracks:
        print(f"  tracks: {', '.join(tracks)}")

    stats = _span_stats(events)
    if stats:
        print(f"  {'span':<24} {'n':>6} {'total':>12} {'mean':>12} {'max':>12}  clock")
        for name in sorted(stats, key=lambda n: -stats[n]["total"]):
            s = stats[name]
            print(
                f"  {name:<24} {s['count']:>6} {_fmt_s(s['total']):>12}"
                f" {_fmt_s(s['mean']):>12} {_fmt_s(s['max']):>12}  {s['clock']}"
            )
    instants = _instant_counts(events)
    if instants:
        line = ", ".join(f"{k}={v}" for k, v in sorted(instants.items()))
        print(f"  instants: {line}")
    counters = [m for m in trace["metrics"] if m.get("kind") == "counter"]
    if counters:
        print("  counters:")

        def _key(m):
            return (m["name"], sorted(m["labels"].items()))

        for m in sorted(counters, key=_key):
            labels = ",".join(f"{k}={v}" for k, v in sorted(m["labels"].items()))
            suffix = f"{{{labels}}}" if labels else ""
            print(f"    {m['name']}{suffix} = {m['value']:g}")
    return 0


def _cmd_export(args: argparse.Namespace) -> int:
    # Re-render a loaded trace as Perfetto JSON via a throwaway bundle.
    from .export import write_trace
    from .trace import Telemetry

    trace = load_trace(args.trace)
    tel = Telemetry(enabled=True, max_events=len(trace["events"]) + 1)
    for e in trace["events"]:
        tel.tracer._emit(dict(e))
    for m in trace["metrics"]:
        if m.get("kind") == "counter":
            tel.registry.count(m["name"], m["value"], **m.get("labels", {}))
        elif m.get("kind") == "gauge":
            tel.registry.gauge(m["name"], m["value"], **m.get("labels", {}))
    out = write_trace(tel, args.out)
    print(f"wrote {out}")
    return 0


def _cmd_dashboard(args: argparse.Namespace) -> int:
    from .dashboard import write_dashboard

    trace = load_trace(args.trace)
    sweep = None
    if args.sweep is not None:
        sweep = json.loads(Path(args.sweep).read_text())
    out = write_dashboard(
        args.out, trace, sweep_summary=sweep, title=args.title
    )
    print(f"wrote {out}")
    return 0


def _cmd_diff(args: argparse.Namespace) -> int:
    a = _span_stats(load_trace(args.a)["events"])
    b = _span_stats(load_trace(args.b)["events"])
    names = sorted(set(a) | set(b))
    if not names:
        print("no spans in either trace")
        return 0
    print(
        f"{'span':<24} {'n(a)':>6} {'n(b)':>6} "
        f"{'total(a)':>12} {'total(b)':>12} {'delta':>9}"
    )
    for name in names:
        sa, sb = a.get(name), b.get(name)
        na = sa["count"] if sa else 0
        nb = sb["count"] if sb else 0
        ta = sa["total"] if sa else 0.0
        tb = sb["total"] if sb else 0.0
        delta = f"{(tb - ta) / ta * 100:+.1f}%" if ta else "new" if tb else "-"
        print(
            f"{name:<24} {na:>6} {nb:>6} {_fmt_s(ta):>12} {_fmt_s(tb):>12} {delta:>9}"
        )
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.telemetry",
        description="Summarize, convert, and diff repro telemetry traces.",
    )
    sub = p.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("summarize", help="print span/instant/counter aggregates")
    s.add_argument("trace", type=Path)
    s.set_defaults(fn=_cmd_summarize)

    e = sub.add_parser("export", help="convert a trace (e.g. JSONL -> Perfetto JSON)")
    e.add_argument("trace", type=Path)
    e.add_argument("out", type=Path)
    e.set_defaults(fn=_cmd_export)

    h = sub.add_parser(
        "dashboard", help="render a saved trace into a self-contained HTML page"
    )
    h.add_argument("trace", type=Path)
    h.add_argument("-o", "--out", type=Path, default=Path("dashboard.html"))
    h.add_argument(
        "--sweep", type=Path, default=None, help="sweep summary JSON to embed"
    )
    h.add_argument("--title", default="Fleet observatory")
    h.set_defaults(fn=_cmd_dashboard)

    d = sub.add_parser("diff", help="compare span aggregates of two traces")
    d.add_argument("a", type=Path)
    d.add_argument("b", type=Path)
    d.set_defaults(fn=_cmd_diff)
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    try:
        return args.fn(args)
    except FileNotFoundError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    except json.JSONDecodeError as e:
        print(f"error: not a valid trace file: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    raise SystemExit(main())
