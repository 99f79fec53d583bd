"""Unified observability: metrics registry + span tracing + exporters.

One :class:`Telemetry` bundle per run, threaded through the scheduler,
federated rounds, gossip, fleet engine and serve plane.  Telemetry off
(the ``NULL`` bundle) is the default everywhere and touches no run
state, so runs are bit-identical with it.  Telemetry on is observe-only
too — it never mutates run numerics.  A framework-free copy of the
reference's ``telemetry`` package: both write the same trace formats
(``repro.telemetry/v1`` JSONL, Perfetto ``trace_event`` JSON), so
either side's tools read the other's traces.

Capture a trace from the CLI with ``--trace PATH`` on
``python -m repro_torch.experiments``; inspect it with
``python -m repro_torch.telemetry summarize PATH`` or load the JSON in
the Perfetto UI.
"""

from __future__ import annotations

from .dashboard import dashboard_from_telemetry, render_dashboard, write_dashboard
from .export import load_trace, to_perfetto, write_jsonl, write_perfetto, write_trace
from .registry import MetricsRegistry, NullRegistry
from .trace import NO_SPAN, NULL, JsonlTraceSink, NullTracer, Telemetry, Tracer

__all__ = [
    "NO_SPAN",
    "NULL",
    "JsonlTraceSink",
    "MetricsRegistry",
    "NullRegistry",
    "NullTracer",
    "Telemetry",
    "Tracer",
    "dashboard_from_telemetry",
    "load_trace",
    "render_dashboard",
    "to_perfetto",
    "write_dashboard",
    "write_jsonl",
    "write_perfetto",
    "write_trace",
]
