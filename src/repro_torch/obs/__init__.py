"""Unified telemetry: metrics registry, CUDA-aware tracing, JSONL events.

A copy of ``repro/obs`` (spans end on a wait for the value's CUDA
stream).  The
entry points (``launch/serve.py`` in the port so far) construct one
:class:`Obs` bundle from their ``--metrics-out`` / ``--trace-out`` flags
and talk only to it:

* ``obs.registry`` — counters/gauges/histograms (obs/metrics.py).
  Counters are ALWAYS maintained (they are a few dict ops and feed the
  checkpoint resume stamp); histograms/gauges/spans only when a flag
  enabled them.
* ``obs.tracer`` — spans ending on a wait for the value's stream when armed
  (obs/trace.py); Chrome-trace JSON at ``--trace-out``.
* ``obs.emit(kind, **fields)`` — schema-validated events, one JSON line
  per event at ``--metrics-out`` (obs/events.py).

``obs.finalize()`` appends the registry snapshot as a final
``metrics_snapshot`` event and writes the trace file.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.obs.events import (KINDS, SCHEMA_VERSION, EventSink,
                                    read_events, validate_event)
from repro_torch.obs.metrics import (DEFAULT_BOUNDS, Counter, Gauge,
                                     Histogram, Registry, merge_snapshots,
                                     series_key, snapshot_summaries)
from repro_torch.obs.trace import NULL_SPAN, Span, Tracer

__all__ = [
    "Obs", "Registry", "Counter", "Gauge", "Histogram", "Tracer", "Span",
    "EventSink", "merge_snapshots", "snapshot_summaries", "series_key",
    "read_events", "validate_event", "KINDS", "SCHEMA_VERSION",
    "DEFAULT_BOUNDS", "NULL_SPAN",
]


class Obs:
    """The per-run telemetry bundle (see module docstring)."""

    def __init__(self, metrics_out: str = "", trace_out: str = "",
                 pid: int = 0, process_name: Optional[str] = None):
        self.metrics_path = metrics_out or None
        self.trace_path = trace_out or None
        # metrics-only runs still time spans (histograms need dur_s)
        # but retain no trace buffer
        self.enabled = bool(metrics_out or trace_out)
        self.registry = Registry()
        self.tracer = Tracer(enabled=self.enabled,
                             collect=bool(trace_out), pid=pid,
                             process_name=process_name)
        self.sink = EventSink(self.metrics_path)

    def emit(self, kind: str, **fields) -> dict:
        return self.sink.emit(kind, **fields)

    def span(self, name: str, cat: str = "", **attrs):
        return self.tracer.span(name, cat=cat, **attrs)

    def finalize(self) -> None:
        if self.metrics_path:
            self.sink.emit("metrics_snapshot",
                           snapshot=self.registry.snapshot())
        self.sink.close()
        if self.trace_path:
            self.tracer.save(self.trace_path)
