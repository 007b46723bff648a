"""The port's solver observability plane: per-LP counters, span tracing,
reports (the counterpart of ``repro.obs``).

* ``obs.telemetry``: ``TelemetryState``, the per-LP counter lanes that ride
  through the engine states, the compaction scheduler's gathers, the
  chunked driver and the CUDA segment kernels when ``telemetry=True``.
* ``obs.trace``: ``SpanTracer``, nested host-side wall-clock spans with a
  JSONL event stream and a Chrome/Perfetto trace-event exporter.
* ``obs.report``: ``SolveReport``, the per-solve aggregate attached as
  ``LPResult.stats``.

``obs.work`` holds the tableau-element work accounting of a lockstep
solve.
"""
from .report import SolveReport, report_from_counters
from .telemetry import (ALL_LANES, F32_LANES, INT_LANES, TelemetryState,
                        init_telemetry, tel_to_numpy)
from .trace import Span, SpanTracer, spans_to_perfetto
from .work import element_updates_lockstep, lockstep_steps

__all__ = [
    "SolveReport", "report_from_counters",
    "TelemetryState", "init_telemetry", "tel_to_numpy",
    "ALL_LANES", "INT_LANES", "F32_LANES",
    "Span", "SpanTracer", "spans_to_perfetto",
    "element_updates_lockstep", "lockstep_steps",
]
