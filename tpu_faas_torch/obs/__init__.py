"""Unified telemetry: metrics registry, Prometheus exposition, task tracing.

The reference system has no observability beyond commented-out prints
(SURVEY §5.5); before this package, our replacements were ad hoc — each
dispatcher hand-rolled a ``stats()`` dict, the gateway exposed a disjoint
JSON ``/metrics``, and ``TickTracer`` percentiles lived in an in-memory
ring nobody could scrape. Three pillars replace that:

- :mod:`tpu_faas.obs.metrics` — process-wide ``Counter``/``Gauge``/
  ``Histogram`` primitives with label support, lock-cheap hot-path
  recording (fixed-bucket histograms, no per-sample storage), and a
  Prometheus text-exposition renderer. Every number in the system has one
  name, one type, one scrape path.
- :mod:`tpu_faas.obs.trace` — per-task lifecycle timelines: nine
  monotonic-anchored event stamps from submit to finish, aggregated into
  per-stage latency histograms and kept in a bounded ring for
  slowest-task inspection (``/trace/<task_id>`` on the dispatcher).
- :mod:`tpu_faas_torch.obs.profile` — device-tick profiling hooks:
  signature counters (a new tick shape per count), tick-shape gauges, and
  an opt-in ``torch.profiler`` capture gated by
  ``TPU_FAAS_TORCH_PROFILE_DIR``.

:mod:`tpu_faas.obs.expofmt` is the strict exposition-format parser the
conformance tests and the bench smoke scrape share.
"""

from __future__ import annotations

from tpu_faas_torch.obs.metrics import (
    CONTENT_TYPE,
    LATENCY_BUCKETS,
    REGISTRY,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    render,
)
from tpu_faas_torch.obs.slo import Objective, SLOTracker
from tpu_faas_torch.obs.trace import EVENTS, STAGES, TaskTraceBook, anchored_now
from tpu_faas_torch.obs.tracectx import (
    SpanSink,
    assemble_timeline,
    new_trace_id,
    valid_trace_id,
)

__all__ = [
    "CONTENT_TYPE",
    "Counter",
    "EVENTS",
    "Gauge",
    "Histogram",
    "LATENCY_BUCKETS",
    "MetricsRegistry",
    "Objective",
    "REGISTRY",
    "SLOTracker",
    "STAGES",
    "SpanSink",
    "TaskTraceBook",
    "anchored_now",
    "assemble_timeline",
    "new_trace_id",
    "render",
    "valid_trace_id",
]
