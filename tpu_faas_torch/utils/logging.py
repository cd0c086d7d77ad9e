"""Structured logging + lightweight tracing.

The reference has no observability beyond commented-out prints (SURVEY §5.5).
Here every component logs through stdlib logging with a shared format, and hot
loops can record per-tick timings through :class:`TickTracer` — a bounded
in-memory ring of (name, duration) spans with percentile summaries, cheap
enough to leave on in production loops. A tracer given a ``mirror``
histogram (tpu_faas/obs/metrics.py) feeds the SAME ``record()`` call into
the scrapeable registry, so ``/stats`` percentiles and ``/metrics``
histograms cannot disagree about what was measured.

Log format: human-readable lines by default; ``TPU_FAAS_LOG_FORMAT=json``
switches every ``tpu_faas.*`` logger to one JSON object per line with
``task_id``/``worker_id`` correlation fields when the log site supplies
them (``logger.info(msg, extra=log_ctx(task_id=...))``) — so structured
logs join the task timelines of tpu_faas/obs/trace.py on task id.
"""

from __future__ import annotations

import json
import logging
import math
import os
import threading
import time
from collections import deque
from contextlib import contextmanager

_FORMAT = "%(asctime)s %(levelname)s %(name)s: %(message)s"

LOG_FORMAT_ENV = "TPU_FAAS_LOG_FORMAT"

#: record attributes copied into JSON log lines when a log site set them
#: via ``extra=`` (see :func:`log_ctx`)
_CONTEXT_FIELDS = ("task_id", "worker_id", "dispatcher_id", "trace_id")


def log_ctx(**fields: object) -> dict:
    """``extra=`` dict carrying correlation fields, None values dropped:
    ``log.info("dispatched", extra=log_ctx(task_id=tid, worker_id=wid))``.
    The text formatter ignores them; the JSON formatter emits them."""
    return {k: v for k, v in fields.items() if v is not None}


class JsonFormatter(logging.Formatter):
    """One JSON object per line: ts/level/logger/msg + correlation fields."""

    def format(self, record: logging.LogRecord) -> str:
        out: dict[str, object] = {
            "ts": round(record.created, 6),
            "level": record.levelname,
            "logger": record.name,
            "msg": record.getMessage(),
        }
        for field in _CONTEXT_FIELDS:
            value = getattr(record, field, None)
            if value is not None:
                out[field] = value if isinstance(value, (int, float)) else str(value)
        if record.exc_info:
            out["exc"] = self.formatException(record.exc_info)
        return json.dumps(out, separators=(",", ":"))


def _make_formatter() -> logging.Formatter:
    if os.environ.get(LOG_FORMAT_ENV, "").strip().lower() == "json":
        return JsonFormatter()
    return logging.Formatter(_FORMAT)


def get_logger(name: str, level: int = logging.INFO) -> logging.Logger:
    logger = logging.getLogger(f"tpu_faas.{name}")
    if not logging.getLogger("tpu_faas").handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(_make_formatter())
        root = logging.getLogger("tpu_faas")
        root.addHandler(handler)
        root.setLevel(level)
        root.propagate = False
    return logger


def percentile(data: list[float], q: float) -> float:
    """Nearest-rank percentile over SORTED data (the standard definition:
    the smallest value with at least ``ceil(q*n)`` observations at or below
    it). The previous inline ``data[min(n-1, int(n*0.99))]`` was off by one
    — at n=100 it returned the maximum instead of the 99th value."""
    n = len(data)
    if n == 0:
        raise ValueError("percentile of empty data")
    rank = max(1, math.ceil(q * n))
    return data[min(n, rank) - 1]


class TickTracer:
    """Bounded ring of timed spans for hot-loop instrumentation.

    ``mirror`` (optional): a single-label Histogram — every
    ``record(name, s)`` also lands as ``mirror.labels(name).observe(s)``,
    making the ring (exact recent percentiles, /stats) and the registry
    (cumulative fixed-bucket histogram, /metrics) two views of one
    measurement."""

    def __init__(self, capacity: int = 4096, mirror=None) -> None:
        self._spans: dict[str, deque[float]] = {}
        self._capacity = capacity
        self._mirror = mirror
        # summary() may be called from a stats/metrics thread while the hot
        # loop records; unlocked dict/deque iteration would intermittently
        # raise "mutated during iteration"
        self._lock = threading.Lock()

    @contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.record(name, time.perf_counter() - t0)

    def record(self, name: str, seconds: float) -> None:
        with self._lock:
            self._spans.setdefault(
                name, deque(maxlen=self._capacity)
            ).append(seconds)
        if self._mirror is not None:
            self._mirror.labels(name).observe(seconds)

    def summary(self) -> dict[str, dict[str, float]]:
        with self._lock:
            snapshot = {name: list(xs) for name, xs in self._spans.items()}
        out: dict[str, dict[str, float]] = {}
        for name, xs in snapshot.items():
            if not xs:
                continue
            data = sorted(xs)
            n = len(data)
            out[name] = {
                "count": float(n),
                "mean": sum(data) / n,
                "p50": percentile(data, 0.5),
                "p99": percentile(data, 0.99),
                "max": data[-1],
            }
        return out
