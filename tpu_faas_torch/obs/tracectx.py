"""Distributed trace context + the store-backed span plane.

The 9-event timelines of :mod:`tpu_faas.obs.trace` are assembled inside ONE
dispatcher process; this module is the cross-process half, Dapper-style:

- **Context**: every traced task carries a ``trace_id`` (lowercase hex,
  minted by the SDK, or by the gateway for legacy clients) plus an optional
  parent span id. The id rides the task record (``FIELD_TRACE_ID``), the
  TASK/RESULT worker frames (capability-gated — reference-era workers never
  see the field), and ``log_ctx`` so JSON logs correlate fleet-wide.
- **Span records**: each process emits ``(process, stage, t_start, t_end,
  attrs)`` records into the store under ``trace:<trace_id>`` hashes, one
  field per span named ``<process>:<stage>``. Writes are FIRST-WRITE-WINS
  (``hsetnx_many``): a replayed announce after a store failover, a zombie's
  duplicate RESULT, or a repeated /result poll can re-emit a span, and the
  first stamp must stand — duplicates are counted into
  ``tpu_faas_trace_duplicate_events_total`` instead of corrupting deltas.
- **Assembly**: :func:`assemble_timeline` reads the task record plus its
  trace hash and produces the ordered cross-process timeline — SDK submit
  → gateway admit → store create → dispatcher intake/queue/dispatch →
  worker exec → dispatcher finalize → client observe — including the
  poll-gap segment (``gateway:observe``) the dispatcher-local view
  structurally cannot see.

Span timestamps are epoch seconds: gateway and worker stamps are
``time.time()``-family, dispatcher stamps are monotonic-anchored
(:func:`tpu_faas.obs.trace.anchored_now`), so cross-process spans compare
up to host clock sync — same contract as the 9-event timeline.

The span namespace is bounded on both ends: each :class:`SpanSink` buffer
is capped (overflow drops the OLDEST records and counts them), the span
catalog per trace is a fixed small set of fields, and the gateway's
result-TTL sweeper ages ``trace:`` hashes out by their ``t0`` stamp
exactly like terminal task records — with no sweeper configured, spans
accumulate like task records do (the reference's grow-until-FLUSHDB
contract, unchanged).
"""

from __future__ import annotations

import json
import re
import threading
import time
import uuid
from dataclasses import dataclass, field

#: Store namespace of the span plane: one hash per trace id.
TRACE_PREFIX = "trace:"
#: Epoch stamp of the trace hash's first span write — the TTL sweeper's
#: aging field (trace hashes have no status; without this they would be
#: invisible to every sweep and leak forever).
TRACE_AT_FIELD = "t0"
#: Task id the trace belongs to, written beside the stamp: the sweeper
#: uses it to SKIP aged hashes whose task is still live — a task queued
#: or running past the result TTL must not lose its early spans
#: mid-flight. Hashes without it (older producers) age by stamp alone.
TRACE_TASK_FIELD = "task"

#: Wire/body field names shared by the SDKs and the gateway.
TRACE_ID_KEY = "trace_id"
PARENT_SPAN_KEY = "parent_span"

_TRACE_ID_RE = re.compile(r"^[0-9a-f]{8,64}$")


def new_trace_id() -> str:
    return uuid.uuid4().hex


def new_span_id() -> str:
    return uuid.uuid4().hex[:16]


def valid_trace_id(value: object) -> bool:
    """Client-supplied trace ids are untrusted input that becomes a store
    KEY: lowercase hex only, bounded length — anything else is rejected at
    the gateway (400) instead of letting a caller mint arbitrary keys."""
    return isinstance(value, str) and bool(_TRACE_ID_RE.match(value))


def trace_key(trace_id: str) -> str:
    return TRACE_PREFIX + trace_id


def span_field(process: str, stage: str) -> str:
    return f"{process}:{stage}"


def encode_span(t_start: float, t_end: float, attrs: dict | None) -> str:
    """Compact JSON value of one span field: ``[t_start, t_end, attrs]``."""
    return json.dumps(
        [round(float(t_start), 6), round(float(t_end), 6), attrs or {}],
        separators=(",", ":"),
    )


def decode_span(
    process_stage: str, raw: str
) -> tuple[str, str, float, float, dict] | None:
    """(process, stage, t_start, t_end, attrs), or None for anything
    unparseable — a foreign producer's field must not 500 the assembly."""
    if ":" not in process_stage:
        return None
    process, stage = process_stage.split(":", 1)
    try:
        t_start, t_end, attrs = json.loads(raw)
        t_start, t_end = float(t_start), float(t_end)
    except (ValueError, TypeError):
        return None
    if not isinstance(attrs, dict):
        attrs = {}
    return process, stage, t_start, t_end, attrs


@dataclass
class _PendingSpan:
    trace_id: str
    field: str
    value: str
    stamp: str
    task_id: str | None = None


@dataclass
class SpanSink:
    """Buffered, first-write-wins span writer for one process.

    ``emit`` is hot-path cheap (list append under a lock); ``flush`` pays
    the store round trip — serve loops call it periodically, the gateway
    runs it from a background task. A flush that hits a store outage keeps
    the buffer (bounded) and retries on the next call: spans are telemetry,
    they degrade, they never wedge dispatch."""

    store: object
    process: str
    registry: object | None = None
    max_buffer: int = 4096
    _lock: threading.Lock = field(default_factory=threading.Lock)
    _buf: list[_PendingSpan] = field(default_factory=list)

    def __post_init__(self) -> None:
        self.n_written = 0
        self.n_duplicates = 0
        self.n_dropped = 0
        #: TTL stamps (field dicts: t0 + optional task id) whose write
        #: failed AFTER their spans landed — retried on the next flush (an
        #: unstamped trace hash would be invisible to the sweeper forever;
        #: re-queueing the SPANS instead would fabricate duplicate counts
        #: on retry)
        self._pending_stamps: dict[str, dict[str, str]] = {}
        self._m_dup = self._m_drop = None
        if self.registry is not None:
            self._m_dup = self.registry.counter(
                "tpu_faas_trace_duplicate_events_total",
                "Trace event/span stamps suppressed by first-write-wins "
                "recording, by event — replay storms (announce replay "
                "after failover, zombie duplicate RESULTs) surface here "
                "instead of silently corrupting stage deltas",
                ("event",),
            )
            self._m_drop = self.registry.counter(
                "tpu_faas_trace_spans_dropped_total",
                "Span records dropped because the sink buffer overflowed "
                "(sustained store outage or a span burst beyond the "
                "flush cadence)",
            )

    def emit(
        self,
        trace_id: str,
        stage: str,
        t_start: float,
        t_end: float,
        task_id: str | None = None,
        **attrs: object,
    ) -> None:
        """Buffer one span of this sink's process. Never blocks on the
        store; overflow drops the OLDEST buffered spans (counted).
        ``task_id`` (when the caller knows it) rides into the trace
        hash's ``task`` field so the sweeper can check task liveness."""
        self.emit_as(
            self.process,
            trace_id,
            stage,
            t_start,
            t_end,
            task_id=task_id,
            **attrs,
        )

    def emit_as(
        self,
        process: str,
        trace_id: str,
        stage: str,
        t_start: float,
        t_end: float,
        task_id: str | None = None,
        **attrs: object,
    ) -> None:
        """``emit`` under an explicit process name — for spans this
        process persists ON BEHALF of another (the dispatcher writes the
        worker's exec window: the stamps are worker-measured, but workers
        have no store access)."""
        span = _PendingSpan(
            trace_id,
            span_field(process, stage),
            encode_span(t_start, t_end, attrs),
            repr(t_start),
            task_id,
        )
        with self._lock:
            self._buf.append(span)
            overflow = len(self._buf) - self.max_buffer
            if overflow > 0:
                del self._buf[:overflow]
                self.n_dropped += overflow
                if self._m_drop is not None:
                    self._m_drop.inc(overflow)

    def __len__(self) -> int:
        return len(self._buf)

    @property
    def dirty(self) -> bool:
        """True while a flush would do work: buffered spans OR TTL stamps
        whose write failed after their spans landed. Flush-gating on the
        buffer alone would strand those stamps whenever traffic stops —
        and an unstamped trace hash is invisible to the sweeper forever."""
        return bool(self._buf or self._pending_stamps)

    def flush(self) -> int:
        """Write every buffered span in one pipelined first-write-wins
        round (+ one stamp round). Returns spans written; on ANY store
        failure the batch is restored (bounded) and the error swallowed —
        the next flush retries."""
        with self._lock:
            batch, self._buf = self._buf, []
            stamps = self._pending_stamps
            self._pending_stamps = {}
        if not batch and not stamps:
            return 0
        try:
            created = self.store.hsetnx_many(
                [(trace_key(s.trace_id), s.field, s.value) for s in batch]
            )
        except Exception:
            # the spans never landed: restore them (bounded) AND the
            # carried-over stamps, retry on the next flush
            with self._lock:
                self._buf = batch + self._buf
                overflow = len(self._buf) - self.max_buffer
                if overflow > 0:
                    del self._buf[:overflow]
                    self.n_dropped += overflow
                    if self._m_drop is not None:
                        self._m_drop.inc(overflow)
                self._pending_stamps = {**stamps, **self._pending_stamps}
            return 0
        n = 0
        for s, won in zip(batch, created):
            if won:
                n += 1
            else:
                self.n_duplicates += 1
                if self._m_dup is not None:
                    self._m_dup.labels(event=s.field).inc()
        self.n_written += n
        # TTL stamp (+ task id when known), last-write-wins (hset):
        # refreshed per flush so an active trace never ages out under its
        # own spans. The spans above ALREADY landed — a failure here must
        # NOT restore them (the retry would re-HSETNX them all and
        # fabricate a batch-sized duplicate-count spike), so only the
        # stamps carry over to the next flush.
        for s in batch:
            entry = stamps.setdefault(trace_key(s.trace_id), {})
            entry[TRACE_AT_FIELD] = s.stamp
            if s.task_id:
                entry.setdefault(TRACE_TASK_FIELD, s.task_id)
        try:
            self.store.hset_many(list(stamps.items()))
        except Exception:
            with self._lock:
                self._pending_stamps = {**stamps, **self._pending_stamps}
                # bounded like the span buffer: drop the OLDEST stamps
                while len(self._pending_stamps) > self.max_buffer:
                    self._pending_stamps.pop(
                        next(iter(self._pending_stamps))
                    )
        return n


def assemble_timeline(store, task_id: str) -> dict | None:
    """The full cross-process timeline of one task, assembled from its
    record + its ``trace:<trace_id>`` span hash. None when the task is
    unknown. Tasks without a trace id (legacy producers, tracing off)
    assemble to their record status with zero spans — the endpoint stays
    truthful instead of 404ing a real task."""
    from tpu_faas_torch.core.task import (
        FIELD_STATUS,
        FIELD_SUBMITTED_AT,
        FIELD_TRACE_ID,
        FIELD_TRACE_PARENT,
    )

    fields = store.hgetall(task_id)
    if not fields or FIELD_STATUS not in fields:
        return None
    trace_id = fields.get(FIELD_TRACE_ID)
    spans: list[dict] = []
    if trace_id:
        raw = store.hgetall(trace_key(trace_id))
        for name, value in raw.items():
            if name in (TRACE_AT_FIELD, TRACE_TASK_FIELD):
                continue
            parsed = decode_span(name, value)
            if parsed is None:
                continue
            process, stage, t_start, t_end, attrs = parsed
            spans.append(
                {
                    "process": process,
                    "stage": stage,
                    "t_start": round(t_start, 6),
                    "t_end": round(t_end, 6),
                    "duration_s": round(max(0.0, t_end - t_start), 6),
                    "attrs": attrs,
                }
            )
    spans.sort(key=lambda s: (s["t_start"], s["t_end"]))
    processes: list[str] = []
    for s in spans:
        if s["process"] not in processes:
            processes.append(s["process"])
    out: dict = {
        "task_id": task_id,
        "trace_id": trace_id,
        "parent_span": fields.get(FIELD_TRACE_PARENT),
        "status": fields.get(FIELD_STATUS),
        "submitted_at": fields.get(FIELD_SUBMITTED_AT),
        "processes": processes,
        "n_stages": len(spans),
        "spans": spans,
    }
    if spans:
        t0 = min(s["t_start"] for s in spans)
        t1 = max(s["t_end"] for s in spans)
        out["t_start"] = round(t0, 6)
        out["total_s"] = round(max(0.0, t1 - t0), 6)
        # the poll gap and any other uncovered wall time between spans:
        # sorted sweep over the merged intervals
        covered = 0.0
        cursor = t0
        for s in spans:
            if s["t_end"] <= cursor:
                continue
            covered += s["t_end"] - max(s["t_start"], cursor)
            cursor = s["t_end"]
        out["uncovered_s"] = round(max(0.0, (t1 - t0) - covered), 6)
    return out


def sweep_stale_traces(
    store, all_keys: list[str], ttl: float, now: float | None = None
) -> list[str]:
    """Trace hashes whose ``t0`` stamp aged past ``ttl`` — the gateway's
    result-TTL sweeper deletes them alongside terminal task records (the
    span plane must not outlive the records it describes by more than one
    TTL). Unparseable or missing stamps are never collected, and an aged
    hash whose ``task`` field points at a still-live (non-terminal) task
    record is SKIPPED: the stamp only refreshes when new spans flush, so
    a task queued or running past the TTL would otherwise lose its early
    spans mid-flight. Hashes without a task field (older producers) age
    by stamp alone."""
    from tpu_faas_torch.core.task import FIELD_STATUS, TaskStatus

    now_f = now if now is not None else time.time()
    keys = [k for k in all_keys if k.startswith(TRACE_PREFIX)]
    if not keys:
        return []
    aged: list[str] = []
    for key, stamp in zip(keys, store.hget_many(keys, TRACE_AT_FIELD)):
        if not isinstance(stamp, str):
            continue
        try:
            if now_f - float(stamp) > ttl:
                aged.append(key)
        except ValueError:
            continue
    if not aged:
        return []
    task_ids = store.hget_many(aged, TRACE_TASK_FIELD)
    with_task = [
        (k, t) for k, t in zip(aged, task_ids) if isinstance(t, str) and t
    ]
    live: set[str] = set()
    if with_task:
        statuses = store.hget_many([t for _, t in with_task], FIELD_STATUS)
        for (key, _), status in zip(with_task, statuses):
            # a record that exists with a non-terminal status is live;
            # missing records (already swept) and terminal ones collect
            if status is not None and not TaskStatus.terminal_str(
                status, unknown=True
            ):
                live.add(key)
    return [k for k in aged if k not in live]
