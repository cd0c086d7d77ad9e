"""Per-task lifecycle tracing: where did this task's latency go?

Every task record accumulates up to nine event stamps on its way through
the system::

    submitted -> announced -> intake -> scheduled -> sent
        -> exec_start -> exec_end -> result_received -> finished

``submitted`` is stamped by the gateway onto the task hash
(``FIELD_SUBMITTED_AT``); ``exec_start``/``exec_end`` are measured in the
worker's pool child and ride the RESULT message (``started_at`` +
``elapsed``); everything else is stamped by the dispatcher as the task
passes each boundary. Dispatcher-side stamps are *monotonic-anchored*:
:func:`anchored_now` returns ``time.monotonic()`` shifted by a
process-start anchor onto the epoch, so intra-process deltas are immune to
wall-clock steps while cross-process stamps (gateway, worker — raw
``time.time()``) remain comparable up to host clock sync.

On ``finished`` the timeline is closed: per-stage deltas are observed into
the ``tpu_faas_task_stage_seconds{stage=...,terminal=...}`` histogram of
the owning registry (the scrapeable aggregate; ``terminal`` carries the
closing outcome so shed/cancelled populations don't pollute the COMPLETED
latency distribution), and the full timeline moves into a bounded ring of
recent completions plus a bounded slowest-task list — the raw material
behind the dispatcher's ``/trace/<task_id>`` and ``/trace`` debug
endpoints. No per-task storage survives beyond those rings; an optional
``on_close`` callback hands each closed record to the cross-process span
plane (obs/tracectx.py).

Recording is FIRST-WRITE-WINS: a duplicate stamp of an already-present
event (replayed announce after a store failover, a re-dispatch, a
zombie's late RESULT) keeps the original and is counted into
``tpu_faas_trace_duplicate_events_total{event}`` — replay storms become
visible instead of silently corrupting stage deltas.
"""

from __future__ import annotations

import heapq
import itertools
import threading
import time
from collections import deque

from tpu_faas_torch.obs.attribution import (
    DEFAULT_CLASS,
    SLO_CLASSES,
    class_label_enabled,
    latency_buckets,
)
from tpu_faas_torch.obs.metrics import LATENCY_BUCKETS

#: Canonical event order (also the order ``timeline()`` reports).
EVENTS = (
    "submitted",
    "announced",
    "intake",
    "scheduled",
    "sent",
    "exec_start",
    "exec_end",
    "result_received",
    "finished",
)

#: stage -> (from_event, to_event). Stages whose endpoints are both present
#: on a closing timeline are observed into the stage histogram.
STAGES = {
    # gateway write + announce-bus latency
    "submit_to_announce": ("submitted", "announced"),
    # graph children only: WAITING stretch from create to the promotion
    # plane's WAITING -> QUEUED flip ("promoted" is stamped at intake of
    # the promoted record, or at the frontier's in-tick readiness) — both
    # endpoints absent on flat tasks, so the stage never observes there
    "dep_wait": ("submitted", "promoted"),
    # waiting in the pending structures for a placement decision
    "queue_wait": ("announced", "scheduled"),
    # device-schedule latency: placement decision -> task on the wire
    "device_schedule": ("scheduled", "sent"),
    # wire + worker pool queueing before the child picks it up
    "dispatch_to_start": ("sent", "exec_start"),
    # the user function itself (measured in the pool child)
    "execution": ("exec_start", "exec_end"),
    # result's trip back over the wire into the dispatcher drain
    "result_return": ("exec_end", "result_received"),
    # terminal store write landing after the result arrived
    "finalize": ("result_received", "finished"),
    # speculation plane (tpu_faas/spec): hedge replica launched for a
    # straggling execution -> first result resolved the race. Both
    # endpoints absent on unhedged tasks, so the stage never observes
    # there — the hedged population's detection-to-resolution window.
    "hedge_window": ("hedge_launched", "hedge_resolved"),
    # end to end
    "total": ("submitted", "finished"),
}

_ANCHOR = time.time() - time.monotonic()


def anchored_now() -> float:
    """Epoch seconds sampled via the monotonic clock: comparable across
    processes on one host, immune to wall-clock steps within a process."""
    return _ANCHOR + time.monotonic()


class TaskTraceBook:
    """Bounded event-timeline store + stage-histogram aggregation.

    Thread-safety: one lock around the dicts/rings — ``note`` is a dict
    probe plus an insert, cheap enough for the dispatcher's drain loops,
    and the stats thread snapshots under the same lock.
    """

    def __init__(
        self,
        registry,
        active_cap: int = 65536,
        recent_cap: int = 256,
        slowest_cap: int = 32,
        class_enabled: bool | None = None,
    ) -> None:
        self._lock = threading.Lock()
        self._active: dict[str, dict[str, float]] = {}
        #: task_id -> trace id (distributed trace context), carried beside
        #: the float-valued event dicts and popped with them — the closed
        #: record hands it to ``on_close`` so the span plane can key its
        #: cross-process writes
        self._trace_ids: dict[str, str] = {}
        #: TPU_FAAS_OBS_CLASS: the stage histogram grows a ``class`` label
        #: (obs/attribution.py vocabulary). Off (default) keeps labelnames,
        #: child set and exposition byte-identical to the two-label form.
        self.class_enabled = (
            class_label_enabled() if class_enabled is None else class_enabled
        )
        #: task_id -> SLO class, same lifecycle as ``_trace_ids`` (popped
        #: at finish/discard/eviction); only ever populated when the class
        #: label is on
        self._classes: dict[str, str] = {}
        self._recent: deque[dict] = deque(maxlen=recent_cap)
        self._completed: dict[str, dict] = {}
        self._active_cap = active_cap
        self._slowest_cap = slowest_cap
        #: (total_seconds, seq, timeline) min-heap of the slowest closures
        self._slowest: list[tuple[float, int, dict]] = []
        self._seq = itertools.count()
        self.n_completed = 0
        #: optional callback(record) invoked OUTSIDE the book lock for
        #: every closed timeline — the dispatcher wires the cross-process
        #: span emission here; exceptions are the caller's problem to
        #: avoid (span sinks never raise)
        self.on_close = None
        self._hist = registry.histogram(
            "tpu_faas_task_stage_seconds",
            "Per-stage task lifecycle latency (seconds), aggregated from "
            "the nine-event task timelines; 'terminal' is the closing "
            "outcome (COMPLETED/FAILED/CANCELLED/EXPIRED and the "
            "dispatcher-side drop reasons), so shed populations don't "
            "pollute the completed-latency distribution",
            ("stage", "terminal", "class")
            if self.class_enabled
            else ("stage", "terminal"),
            buckets=latency_buckets(LATENCY_BUCKETS),
        )
        self._m_dup = registry.counter(
            "tpu_faas_trace_duplicate_events_total",
            "Trace event/span stamps suppressed by first-write-wins "
            "recording, by event — replay storms (announce replay "
            "after failover, zombie duplicate RESULTs) surface here "
            "instead of silently corrupting stage deltas",
            ("event",),
        )
        # pre-create every stage child (for the common outcome): the scrape
        # shows the full stage catalog (at zero) before the first task
        # completes. With the class label on, the catalog spans the closed
        # class vocabulary too — explicit zeros per class.
        for stage in STAGES:
            if self.class_enabled:
                for cls in SLO_CLASSES:
                    self._hist.labels(stage, "COMPLETED", cls)
            else:
                self._hist.labels(stage=stage, terminal="COMPLETED")

    def stage_snapshot(
        self,
        stage: str,
        terminal: str | None = "COMPLETED",
        cls: str | None = None,
    ) -> tuple[tuple[float, ...], list[int]] | None:
        """(bucket uppers, per-bucket counts) for one stage — the SLO
        tracker's data source. COMPLETED outcomes only by default: shed
        (EXPIRED) and cancelled populations must not burn the latency
        error budget — shedding under overload is intended behavior, and
        counting quick cancels as "good" would dilute real violations.
        ``terminal=None`` sums across every outcome. None for an unknown
        stage with no series yet.

        ``cls`` restricts to one SLO class. With the class label OFF a
        class-restricted read returns None — ``sum_counts`` matches
        positionally against however many labels a child carries, so a
        three-element match against two-label children would silently
        match EVERY class; None keeps per-class objectives honestly
        reporting source-absent instead of lying with aggregate counts.
        """
        if cls is not None:
            if not self.class_enabled:
                return None
            return self._hist.sum_counts((stage, terminal, cls))
        return self._hist.sum_counts((stage, terminal))

    # -- recording ---------------------------------------------------------
    def note(
        self,
        task_id: str,
        event: str,
        ts: float | None = None,
        open_new: bool = True,
        count_dup: bool = True,
    ) -> None:
        """Stamp ``event`` on the task's timeline (first stamp wins: a
        re-dispatched task keeps its original ``sent``, and the retry is
        visible as ``retries`` on the closed record instead).

        ``open_new=False`` stamps ONLY an already-open timeline: events
        that can arrive after a task finished — a zombie worker's late
        second RESULT — must not resurrect the closed trace as a fresh
        (then duplicate-completed) one.

        ``count_dup=False`` suppresses the duplicate-counter tick for a
        re-stamp the CALLER knows is routine — the scheduled/sent stamps
        of a reclaimed task's redispatch are normal at-least-once
        operation (already visible as ``retries``), and counting them
        would page operators reading the counter as the replay-storm
        signal it is documented to be."""
        if ts is None:
            ts = anchored_now()
        with self._lock:
            events = self._active.get(task_id)
            if events is None:
                if not open_new:
                    return
                if len(self._active) >= self._active_cap:
                    # drop the oldest open timeline (dict preserves insert
                    # order): an abandoned trace must never grow memory
                    evicted = next(iter(self._active))
                    self._active.pop(evicted)
                    self._trace_ids.pop(evicted, None)
                    self._classes.pop(evicted, None)
                events = self._active[task_id] = {}
            duplicate = event in events
            events.setdefault(event, ts)
        if duplicate and count_dup:
            # first write wins; the suppressed stamp is counted so replay
            # storms (failover announce replay re-entering intake) are
            # operator-visible instead of silent
            self._m_dup.labels(event=event).inc()

    def note_trace(self, task_id: str, trace_id: str | None) -> None:
        """Attach the distributed trace id to an open (or about-to-open)
        timeline; first write wins, same as event stamps."""
        if not trace_id:
            return
        with self._lock:
            if task_id in self._active:
                self._trace_ids.setdefault(task_id, trace_id)

    def note_class(self, task_id: str, cls: str | None) -> None:
        """Attach the task's SLO class to an open timeline (first write
        wins). A no-op when the class label is off or the value is
        outside the closed vocabulary — off-vocabulary garbage must never
        become a label value."""
        if not self.class_enabled or cls not in SLO_CLASSES:
            return
        with self._lock:
            if task_id in self._active:
                self._classes.setdefault(task_id, cls)

    def note_retry(self, task_id: str) -> None:
        with self._lock:
            events = self._active.get(task_id)
            if events is not None:
                events["retries"] = events.get("retries", 0.0) + 1.0

    def finish(
        self, task_id: str, outcome: str, ts: float | None = None
    ) -> None:
        """Close the timeline: stamp ``finished``, observe stage deltas,
        move the record to the recent/slowest rings. Unknown task ids are
        ignored (a foreign producer's task finishing through this
        dispatcher has no open timeline)."""
        if ts is None:
            ts = anchored_now()
        with self._lock:
            events = self._active.pop(task_id, None)
            trace_id = self._trace_ids.pop(task_id, None)
            cls = self._classes.pop(task_id, DEFAULT_CLASS)
            if events is None:
                return
            already_closed = task_id in self._completed
        if already_closed:
            # FIRST COMPLETION WINS: a replayed announce (store-failover
            # re-arm) or a zombie's duplicate RESULT opened a stub
            # timeline for a task whose rich closed record still sits in
            # the ring — discard the stub instead of clobbering the
            # record, double-counting the completion, and polluting the
            # recent ring. Counted like any other suppressed replay.
            self._m_dup.labels(event="finished").inc()
            return
        with self._lock:
            events.setdefault("finished", ts)
            retries = int(events.pop("retries", 0))
            stages: dict[str, float] = {}
            for stage, (a, b) in STAGES.items():
                if a in events and b in events:
                    delta = events[b] - events[a]
                    if delta >= 0:
                        stages[stage] = delta
        # histogram observes OUTSIDE the book lock (the child has its own)
        for stage, delta in stages.items():
            if self.class_enabled:
                child = self._hist.labels(stage, str(outcome), cls)
            else:
                child = self._hist.labels(stage=stage, terminal=str(outcome))
            child.observe(delta)
        record = {
            "task_id": task_id,
            "trace_id": trace_id,
            "outcome": outcome,
            "retries": retries,
            "events": dict(sorted(events.items(), key=lambda kv: kv[1])),
            "stages": {k: round(v, 6) for k, v in stages.items()},
            "complete": all(e in events for e in EVENTS),
        }
        if self.class_enabled:
            record["slo_class"] = cls
        with self._lock:
            self.n_completed += 1
            if len(self._recent) == self._recent.maxlen:
                evicted = self._recent[0]
                self._completed.pop(evicted["task_id"], None)
            self._recent.append(record)
            self._completed[record["task_id"]] = record
            total = stages.get("total", stages.get("execution", 0.0))
            entry = (total, next(self._seq), record)
            if len(self._slowest) < self._slowest_cap:
                heapq.heappush(self._slowest, entry)
            elif total > self._slowest[0][0]:
                heapq.heapreplace(self._slowest, entry)
        on_close = self.on_close
        if on_close is not None:
            on_close(record)

    def discard(self, task_id: str) -> None:
        """Forget an open timeline without closing it (task claimed by a
        sibling dispatcher — its lifecycle belongs to them)."""
        with self._lock:
            self._active.pop(task_id, None)
            self._trace_ids.pop(task_id, None)
            self._classes.pop(task_id, None)

    # -- inspection --------------------------------------------------------
    def timeline(self, task_id: str) -> dict | None:
        """The task's timeline: the closed record if it finished recently,
        else a snapshot of the open (partial) one."""
        with self._lock:
            done = self._completed.get(task_id)
            if done is not None:
                return done
            events = self._active.get(task_id)
            if events is None:
                return None
            snap = {k: v for k, v in events.items() if k != "retries"}
            return {
                "task_id": task_id,
                "trace_id": self._trace_ids.get(task_id),
                "outcome": None,
                "retries": int(events.get("retries", 0)),
                "events": dict(sorted(snap.items(), key=lambda kv: kv[1])),
                "stages": {},
                "complete": False,
            }

    def recent(self, n: int = 32) -> list[dict]:
        with self._lock:
            return list(self._recent)[-n:]

    def slowest(self) -> list[dict]:
        with self._lock:
            entries = sorted(self._slowest, reverse=True)
        return [rec for _, _, rec in entries]

    def stats(self) -> dict:
        with self._lock:
            return {
                "active": len(self._active),
                "completed": self.n_completed,
            }
