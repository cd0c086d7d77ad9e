"""Dispatcher base: store connection, announce subscription, task intake.

Equivalent role to the reference's TaskDispatcher base class (reference
task_dispatcher.py:27-52): owns the store client plus a subscription to the
announce channel, and turns one announce message into a (task_id, fn_payload,
param_payload) triple.

Differences from the reference, by design:

- the store is injected by URL, not hard-coded (reference hard-codes Redis
  localhost:6379 db=1 at task_dispatcher.py:32 despite config keys);
- `poll_tasks` batch-drains up to ``max_n`` announcements per tick and
  fetches all their records in ONE pipelined store round — the reference
  reads at most one message per loop iteration and pays one store round
  trip per task (task_dispatcher.py:75,170,299), which caps dispatch
  throughput at one task per tick; batching is what lets the TPU backend
  schedule thousands of pending tasks in one device step;
- a clean ``stop()`` for tests (the reference loops forever).
"""

from __future__ import annotations

import itertools
import math
import threading
import time
import uuid
from collections import Counter, deque
from dataclasses import dataclass

from tpu_faas_torch.admission.signal import CapacitySnapshot, publish_snapshot
from tpu_faas_torch.core.columns import RowTask, TaskColumns
from tpu_faas_torch.core.payload import (
    RESULT_BLOB_MIN_BYTES,
    PayloadLRU,
)
from tpu_faas_torch.core.serialize import serialize
from tpu_faas_torch.core.task import (
    FIELD_CHILDREN,
    FIELD_COST,
    FIELD_DEADLINE,
    FIELD_DEPS,
    FIELD_FN,
    FIELD_FN_DIGEST,
    FIELD_LEASE_AT,
    FIELD_PARAMS,
    FIELD_PRIORITY,
    FIELD_RECLAIMS,
    FIELD_SLO_CLASS,
    FIELD_SPECULATIVE,
    FIELD_STATUS,
    FIELD_SUBMITTED_AT,
    FIELD_TENANT,
    FIELD_TIMEOUT,
    FIELD_TRACE_ID,
    TaskStatus,
    claim_field_for,
)
from tpu_faas_torch.obs import (
    REGISTRY,
    MetricsRegistry,
    SLOTracker,
    SpanSink,
    TaskTraceBook,
)
from tpu_faas_torch.obs import metrics as obs_metrics
from tpu_faas_torch.obs.attribution import AttributionBook, class_of
from tpu_faas_torch.obs.flightrec import FlightRecorder
from tpu_faas_torch.obs.slo import (
    DEFAULT_DISPATCHER_OBJECTIVES,
    objectives_from_env,
)
from tpu_faas_torch.store.base import (
    BLOBREQ_ANNOUNCE_PREFIX,
    CANCEL_ANNOUNCE_PREFIX,
    DISPATCHERS_KEY,
    KILL_ANNOUNCE_PREFIX,
    LEASE_CONF_KEY,
    TASKS_CHANNEL,
    TaskStore,
)
from tpu_faas_torch.store.launch import make_store
from tpu_faas_torch.utils.logging import get_logger, log_ctx
from tpu_faas_torch.worker import messages as _wm

#: Exceptions treated as a transient store outage (restart, network blip).
#: Deliberately NOT plain OSError: zmq.ZMQError subclasses OSError, and a
#: broken worker socket must stay fatal rather than be retried as an outage.
STORE_OUTAGE_ERRORS = (ConnectionError, TimeoutError)

#: What a dead-worker reclaim needs to rebuild a PendingTask — everything
#: BUT the result (see TaskDispatcher.fetch_reclaim).
RECLAIM_FIELDS = [
    FIELD_FN,
    FIELD_FN_DIGEST,
    FIELD_PARAMS,
    FIELD_PRIORITY,
    FIELD_COST,
    FIELD_TIMEOUT,
    FIELD_TRACE_ID,
    # graph parents must keep promoting their children after a reclaim:
    # the dep-completion gate (graph_parents) is rebuilt from this field
    FIELD_CHILDREN,
    # a reclaimed task keeps its tenant accounting (tpu_faas/tenancy): the
    # re-dispatch must charge the same share bucket as the original
    FIELD_TENANT,
    # a reclaimed task keeps its hedge eligibility (tpu_faas/spec): the
    # client's idempotency declaration survives re-dispatch
    FIELD_SPECULATIVE,
    # a reclaimed task keeps its SLO class (obs/attribution.py): its
    # re-dispatch must attribute to the same latency class
    FIELD_SLO_CLASS,
]


def _has_payloads(fields: dict[str, str]) -> bool:
    """A record is dispatchable when it carries params AND a function in
    EITHER form — the inline body (legacy/reference producers) or the
    payload plane's content digest (body lives once under blob:<digest>)."""
    if FIELD_PARAMS not in fields:
        return False
    return FIELD_FN in fields or FIELD_FN_DIGEST in fields


def _flat_control(flat: list) -> tuple[set, str | None]:
    """Intake control signals straight off a flat ``[field, value, ...]``
    record (the shape ``hgetall_many_raw`` returns, elements bytes or
    str): the set of field names present plus the status value. The
    columnar lane routes every announce on these two without building the
    record dict — ``_has_payloads``/``note_graph_parent`` only probe
    membership, which a set answers."""
    names: set = set()
    status: str | None = None
    for i in range(0, len(flat) - 1, 2):
        f = flat[i]
        if isinstance(f, bytes):
            f = f.decode("utf-8")
        names.add(f)
        if f == FIELD_STATUS:
            v = flat[i + 1]
            status = v.decode("utf-8") if isinstance(v, bytes) else v
    return names, status


def _flat_dict(flat: list) -> dict[str, str]:
    """Materialize a flat record into the classic str->str field dict —
    the columnar lane's escape hatch for the rare branches that genuinely
    need one (WAITING graph nodes, arena-full fallback)."""
    out: dict[str, str] = {}
    for i in range(0, len(flat) - 1, 2):
        f, v = flat[i], flat[i + 1]
        if isinstance(f, bytes):
            f = f.decode("utf-8")
        out[f] = v.decode("utf-8") if isinstance(v, bytes) else v
    return out


def _parse_positive_finite(raw: str | None) -> float | None:
    """Defensive hint parse: a malformed, non-finite, or non-positive value
    from the store degrades to None (no hint) rather than wedging the
    dispatch loop on one bad task."""
    if raw is None:
        return None
    try:
        value = float(raw)
    except ValueError:
        return None
    return value if math.isfinite(value) and value > 0.0 else None


@dataclass
class PendingTask:
    task_id: str
    fn_payload: str
    param_payload: str
    #: content address of the serialized function (payload plane): a
    #: digest-carrying task may arrive with an EMPTY fn_payload — the body
    #: lives once in the store's blob namespace, and the dispatcher
    #: materializes it (TaskDispatcher.ensure_inline_payload) only for
    #: hops that can't resolve digests themselves (legacy workers, local
    #: execution). Blob-capable workers get the digest alone.
    fn_digest: str | None = None
    #: how many times this task has been reclaimed from a dead worker and
    #: re-queued (poison-task guard: a task that keeps killing its workers is
    #: FAILED after ``max_task_retries`` reclaims instead of cycling forever)
    retries: int = 0
    #: client-supplied scheduling hints (gateway 'priority'/'cost' fields);
    #: priority orders admission under overload, cost refines the pairing
    priority: int = 0
    cost: float | None = None
    #: execution time budget (gateway 'timeout' field), enforced in the pool
    #: child (core/executor.py) so a runaway task can't eat a slot forever
    timeout: float | None = None
    #: dispatcher-learned size estimate (sched/estimator.py EWMA over
    #: observed runtimes), stamped at batch-build time; an explicit client
    #: cost hint still wins — the operator knows things the EWMA can't
    learned: float | None = None
    #: gateway submit stamp (FIELD_SUBMITTED_AT, epoch seconds), parsed at
    #: intake and fed to the task timeline; None for reference-style
    #: producers that never stamp it
    submitted_at: float | None = None
    #: queue deadline (FIELD_DEADLINE, ABSOLUTE epoch seconds): a task
    #: still undispatched past this instant is shed to EXPIRED instead of
    #: sent (TaskDispatcher.shed_if_expired). None = no deadline. Not
    #: fetched on the reclaim path (RECLAIM_FIELDS): a reclaimed task
    #: already ran once — its record is RUNNING and shedding is
    #: QUEUED-only by protocol.
    deadline_at: float | None = None
    #: distributed trace id (FIELD_TRACE_ID): keys the task's cross-process
    #: span records and rides TASK frames to trace-capable workers. None
    #: for reference-style producers and trace-disabled gateways — the
    #: whole trace plane is a no-op for such tasks.
    trace_id: str | None = None
    #: tenant name (FIELD_TENANT, tpu_faas/tenancy): which principal this
    #: task's placement is accounted to. None (legacy producers, tenancy-
    #: oblivious gateways) reads as the default tenant everywhere.
    tenant: str | None = None
    #: client declared this task idempotent and hedge-eligible
    #: (FIELD_SPECULATIVE, tpu_faas/spec); False for every legacy producer
    speculative: bool = False
    #: declared SLO class (FIELD_SLO_CLASS, obs/attribution.py); None
    #: (legacy producers, undeclared submits) derives from the priority
    #: sign at attribution time — see ``effective_class``
    slo_class: str | None = None
    #: this PendingTask IS a hedge replica of an already-running original
    #: (host-constructed, never parsed from the store): it dispatches
    #: without an inflight-table entry and dies silently if its hedge
    #: entry resolved meanwhile
    is_hedge: bool = False
    #: anti-affinity row a hedge carries (the original's worker); -1 none
    avoid_row: int = -1

    def task_message_kwargs(self, blob: bool = False, trace: bool = False) -> dict:
        """The TASK wire message's payload fields (timeout rides along so
        the WORKER can enforce it; priority/cost are dispatcher-side only).

        ``blob=True`` (the worker negotiated CAP_BLOB and the task carries
        a digest): ship the digest INSTEAD of the body — the worker
        resolves it from its payload cache or asks with BLOB_MISS. On the
        inline path the digest still rides along when known, keying the
        worker's child-side decode cache; legacy workers ignore the
        unknown field. Inline callers must have materialized
        ``fn_payload`` first (ensure_inline_payload).

        ``trace=True`` (the worker negotiated CAP_TRACE): the trace id
        rides along so the worker's logs correlate and its RESULT echoes
        it — reference-era workers never see the field."""
        out = {  # faas: allow(eventloop.hot-loop-dict-churn) the TASK frame's wire payload: this dict IS the worker message contract, materialized once per dispatch at the legacy boundary
            "task_id": self.task_id,
            "param_payload": self.param_payload,
        }
        if blob and self.fn_digest:
            out["fn_digest"] = self.fn_digest
        else:
            out["fn_payload"] = self.fn_payload
            if self.fn_digest:
                out["fn_digest"] = self.fn_digest
        if self.timeout is not None:
            out["timeout"] = self.timeout
        if trace and self.trace_id:
            out["trace_id"] = self.trace_id
        return out

    @property
    def effective_class(self) -> str:
        """The SLO class this task's latency is judged under: the
        declared class, else the priority sign (obs/attribution.py)."""
        return class_of(self.slo_class, self.priority)

    @property
    def size_estimate(self) -> float:
        """Task-cost signal for the scheduler, by trust order: the client's
        explicit cost hint; else the dispatcher-learned runtime estimate
        (stamped by the estimator at batch build); else payload bytes
        (serialized params dominate for data-heavy tasks — and with no
        learning data at all, bytes are at least a consistent scale across
        the whole batch)."""
        if self.cost is not None:
            return self.cost
        if self.learned is not None:
            return self.learned
        return float(len(self.fn_payload) + len(self.param_payload))

    @classmethod
    def from_fields(
        cls, task_id: str, fields: dict[str, str], retries: int = 0
    ) -> "PendingTask":
        """Build from a task's store hash (intake + stranded-rescan + reclaim
        paths share this parse); malformed hint fields degrade to defaults
        rather than wedging the dispatch loop on one bad task."""
        try:
            priority = int(fields.get(FIELD_PRIORITY, 0))
        except ValueError:
            priority = 0
        # clamp into the device kernel's safe range (int32 with negation
        # headroom): the gateway rejects out-of-range values, but the store
        # is writable by other producers and one huge value must not
        # OverflowError the dispatch loop's int32 batch build
        priority = max(-(2**30), min(2**30, priority))
        # finite positive only: cost=inf from a rogue producer would poison
        # the float32 sizes batch and pin the task to the fastest slot
        # forever; a non-finite timeout would wedge setitimer
        cost = _parse_positive_finite(fields.get(FIELD_COST))
        timeout = _parse_positive_finite(fields.get(FIELD_TIMEOUT))
        submitted_at = _parse_positive_finite(fields.get(FIELD_SUBMITTED_AT))
        deadline_at = _parse_positive_finite(fields.get(FIELD_DEADLINE))
        return cls(
            task_id,
            fields.get(FIELD_FN, ""),
            fields.get(FIELD_PARAMS, ""),
            fn_digest=fields.get(FIELD_FN_DIGEST) or None,
            retries=retries,
            priority=priority,
            cost=cost,
            timeout=timeout,
            submitted_at=submitted_at,
            deadline_at=deadline_at,
            trace_id=fields.get(FIELD_TRACE_ID) or None,
            tenant=fields.get(FIELD_TENANT) or None,
            speculative=fields.get(FIELD_SPECULATIVE) == "1",
            slo_class=fields.get(FIELD_SLO_CLASS) or None,
        )


class PendingQueue:
    """Deque of PendingTask with an O(1) task-id membership index.

    Intake dedup (and the stranded-task rescan's known-set) used to rebuild
    a ``seen`` set from the whole pending deque every tick — an O(pending)
    walk per tick at the headline shape. The index is maintained on every
    enqueue/dequeue instead, so ``task_id in queue`` is a dict probe. A
    Counter (multiset), not a set: a double-append of the same id — which
    the dedup layers should prevent — must not corrupt membership when one
    copy is popped."""

    __slots__ = ("_q", "_ids")

    def __init__(self, items=()) -> None:
        self._q: deque[PendingTask] = deque()
        self._ids: Counter[str] = Counter()
        self.extend(items)

    def append(self, task: PendingTask) -> None:
        self._q.append(task)
        self._ids[task.task_id] += 1

    def appendleft(self, task: PendingTask) -> None:
        self._q.appendleft(task)
        self._ids[task.task_id] += 1

    def extend(self, items) -> None:
        for task in items:
            self.append(task)

    def popleft(self) -> PendingTask:
        task = self._q.popleft()
        self._discard(task.task_id)
        return task

    def _discard(self, task_id: str) -> None:
        n = self._ids[task_id] - 1
        if n > 0:
            self._ids[task_id] = n
        else:
            del self._ids[task_id]

    def __contains__(self, task_id: str) -> bool:
        return task_id in self._ids

    def task_ids(self) -> set[str]:
        """Snapshot of the distinct task ids currently queued (the
        rescan's known-set, without walking the deque)."""
        return set(self._ids)

    def __len__(self) -> int:
        return len(self._q)

    def __iter__(self):
        return iter(self._q)

    def __getitem__(self, index: int) -> PendingTask:
        return self._q[index]


class TaskDispatcher:
    """Base: store + announce subscription + intake. Subclasses add a loop."""

    def __init__(
        self,
        store_url: str = "memory://",
        channel: str = TASKS_CHANNEL,
        store: TaskStore | None = None,
        shared: bool = False,
        store_binbatch: bool = False,
    ) -> None:
        self.store = (
            store
            if store is not None
            else make_store(store_url, binbatch=store_binbatch)
        )
        self.channel = channel
        self.subscriber = self.store.subscribe(channel)
        self.log = get_logger(type(self).__name__)
        #: PRIVATE metrics registry (tpu_faas/obs): tests build dispatchers
        #: by the dozen in one process, so instance-scoped series live here
        #: and /metrics renders this registry concatenated with the
        #: process-global one (store round trips, worker-pool counters)
        self.metrics = MetricsRegistry()
        self.m_dispatched = self.metrics.counter(
            "tpu_faas_dispatcher_tasks_dispatched_total",
            "Tasks sent to workers (re-dispatches included)",
        )
        self.m_results = self.metrics.counter(
            "tpu_faas_dispatcher_results_total",
            "Terminal result writes issued, by status (a zombie's late "
            "duplicate counts again even though first_wins freezes it "
            "store-side)",
            ("status",),
        )
        self.m_purged = self.metrics.counter(
            "tpu_faas_dispatcher_workers_purged_total",
            "Workers purged after heartbeat/liveness silence",
        )
        self.m_cancelled_dropped = self.metrics.counter(
            "tpu_faas_dispatcher_cancelled_dropped_total",
            "Cancelled tasks dropped before dispatch (store-verified)",
        )
        self.m_expired = self.metrics.counter(
            "tpu_faas_dispatcher_tasks_expired_total",
            "Tasks shed to EXPIRED because their queue deadline lapsed "
            "while QUEUED (never dispatched)",
        )
        self.m_reclaimed = self.metrics.counter(
            "tpu_faas_dispatcher_tasks_reclaimed_total",
            "In-flight tasks reclaimed from dead workers and re-queued",
        )
        self.m_failover_rearms = self.metrics.counter(
            "tpu_faas_dispatcher_failover_rearms_total",
            "Store failovers this dispatcher detected and re-armed for "
            "(announce-replay round + immediate stranded-task rescan)",
        )
        # -- payload plane (content-addressed function bodies) ------------
        self.m_blob_hits = self.metrics.counter(
            "tpu_faas_dispatcher_blob_cache_hits_total",
            "Digest resolutions served from the dispatcher's blob cache",
        )
        self.m_blob_misses = self.metrics.counter(
            "tpu_faas_dispatcher_blob_cache_misses_total",
            "Digest resolutions that had to fetch the blob from the store",
        )
        self.m_blob_fills = self.metrics.counter(
            "tpu_faas_dispatcher_blob_fills_total",
            "BLOB_FILL messages served to workers (payload-cache misses "
            "on their side)",
        )
        self.m_payload_bytes = self.metrics.counter(
            "tpu_faas_dispatcher_payload_bytes_sent_total",
            "Payload bytes (function body + params) put on the worker "
            "wire by TASK messages; digest-shipped tasks count only their "
            "params — the spread vs tasks_dispatched_total IS the "
            "payload plane's wire saving",
        )
        # -- result-blob plane (content-addressed RESULT bodies) -----------
        #: ``--result-blobs``: workers ship large graph-consumed results
        #: as digests (body stays in the producer's result cache) and the
        #: store records the digest form — bodies materialize lazily via
        #: reverse BLOB_MISS pulls. Off (default) keeps every wire and
        #: store surface byte-identical.
        self.result_blobs = False
        #: ``--dep-results``: deliver parent result BODIES on graph
        #: children's TASK frames (fetched from the store when not blob-
        #: shipped — the store-mediated control the bench compares
        #: against). --result-blobs implies the delivery lane.
        self.dep_results_on = False
        #: minimum completed-result size (bytes) that ships digest-only
        self.result_blob_min = RESULT_BLOB_MIN_BYTES
        self.m_result_store_bytes = self.metrics.counter(
            "tpu_faas_dispatcher_result_store_bytes_total",
            "Result-body bytes exchanged with the STORE, by direction: "
            "dir=\"write\" terminal-write bodies (digest-form writes count "
            "0), dir=\"read\" parent bodies fetched for --dep-results "
            "delivery. write/results is the store-round-trip collapse the "
            "result-blob bench asserts on",
            ("dir",),
        )
        for d in ("write", "read"):
            self.m_result_store_bytes.labels(dir=d)
        self.m_rblob_pulls = self.metrics.counter(
            "tpu_faas_dispatcher_result_blob_pulls_total",
            "Reverse BLOB_MISS pulls sent to producer workers, by outcome "
            "(filled = body arrived and was materialized, missing = the "
            "producer's cache had evicted it)",
            ("outcome",),
        )
        for oc in ("filled", "missing"):
            self.m_rblob_pulls.labels(outcome=oc)
        # -- batched data plane (TASK_BATCH/RESULT_BATCH frames) -----------
        #: dispatcher-side batching knob: >= 2 groups a round's assignments
        #: into one TASK_BATCH frame per CAP_BATCH worker (push-family
        #: subclasses expose it as --batch-max); 0/1 keeps the per-task
        #: wire byte-identical everywhere
        self.batch_max = 0
        self.m_task_frames = self.metrics.counter(
            "tpu_faas_dispatcher_task_frames_total",
            "TASK/TASK_BATCH frames put on the worker wire (a K-task "
            "bundle counts 1, so frames / tasks_dispatched_total is the "
            "O(1)-frames-per-bundle proof; 1:1 with batching off)",
        )
        self.m_batch_size = self.metrics.histogram(
            "tpu_faas_dispatch_batch_size",
            "Tasks per TASK-carrying frame on the worker wire (1 = the "
            "classic per-task form; larger values are TASK_BATCH frames "
            "to batch-capable workers)",
            buckets=(1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0),
        )
        # -- columnar host data plane (core/columns.py, opt-in) ------------
        #: TaskColumns arena when --columnar intake is enabled (see
        #: enable_columnar); None keeps the dict-plane intake byte-for-byte
        self.arena: TaskColumns | None = None
        self.m_columnar_intake = self.metrics.counter(
            "tpu_faas_columnar_intake_total",
            "Tasks decoded at intake under --columnar, by lane: "
            "lane=\"arena\" went straight into a TaskColumns row (no "
            "per-task record dict anywhere on its path); lane=\"fallback\" "
            "found the arena full and degraded to the dict plane "
            "(identical semantics, classic allocation cost)",
            ("lane",),
        )
        self.m_arena_occupancy = self.metrics.gauge(
            "tpu_faas_columnar_arena_occupancy",
            "TaskColumns rows currently held (attached RowTasks); pinned "
            "at capacity = intake is degrading to the dict-plane fallback "
            "— raise --arena-capacity (rows recycle at dispatch/drop, so "
            "steady state tracks the pending depth)",
        )
        self.m_queue_depth = self.metrics.gauge(
            "tpu_faas_dispatcher_pending_tasks",
            "Tasks held in the dispatcher's pending structures",
        )
        self.m_inflight = self.metrics.gauge(
            "tpu_faas_dispatcher_inflight_tasks",
            "Tasks dispatched and awaiting a result",
        )
        self.m_workers = self.metrics.gauge(
            "tpu_faas_dispatcher_workers_registered",
            "Workers currently registered with this dispatcher",
        )
        self.m_store_down = self.metrics.gauge(
            "tpu_faas_dispatcher_store_down",
            "1 while the store is unreachable (degraded mode), else 0",
        )
        self.m_deferred = self.metrics.gauge(
            "tpu_faas_dispatcher_deferred_results",
            "Result writes buffered during a store outage, awaiting replay",
        )
        self.m_announce_backlog = self.metrics.gauge(
            "tpu_faas_dispatcher_announce_backlog",
            "Consumed announces parked by a store outage",
        )
        # a gauge, and deliberately NOT *_total: the value is a SUM of
        # worker-reported cumulative counters, which goes down when a
        # worker restarts — rate() over it would lie
        self.m_misfires = self.metrics.gauge(
            "tpu_faas_dispatcher_worker_misfires",
            "Sum of the fleet's cumulative misfire-repair counters as "
            "reported on RESULT messages (at-least-once executions); "
            "resets partially when a worker restarts",
        )
        #: span histogram the TickTracer mirrors into (device_tick, intake,
        #: act, gateway routes...) — /stats ring percentiles and /metrics
        #: buckets are two views of the same record() calls
        self.m_spans = self.metrics.histogram(
            "tpu_faas_span_seconds",
            "Hot-loop span durations mirrored from the TickTracer rings",
            ("span",),
        )
        for span in ("device_tick", "intake", "act"):
            self.m_spans.labels(span=span)
        #: per-task lifecycle timelines + stage histograms (obs/trace.py);
        #: serves /trace/<task_id> and feeds tpu_faas_task_stage_seconds
        self.traces = TaskTraceBook(self.metrics)
        #: cross-process span plane (obs/tracectx.py): every closed
        #: timeline of a TRACED task (record carried FIELD_TRACE_ID) is
        #: decomposed into (process, stage) span records and flushed into
        #: the store's trace: namespace first-write-wins. Untraced tasks
        #: never touch it — the sink's buffer stays empty and flush is a
        #: len() check, so reference-era setups run unchanged.
        self.spans = SpanSink(
            store=self.store, process="dispatcher", registry=self.metrics
        )
        self.traces.on_close = self._emit_trace_spans
        self._last_span_flush = 0.0
        #: latency-SLO layer (obs/slo.py): multi-window burn rates over the
        #: stage histograms, served as tpu_faas_slo_* gauges and /slo
        self.slo = SLOTracker(
            self.metrics,
            objectives_from_env(DEFAULT_DISPATCHER_OBJECTIVES),
            self.traces.stage_snapshot,
        )
        #: per-plane attribution counters (obs/attribution.py): which
        #: plane touched a task, keyed by its SLO class. Creates series
        #: only when TPU_FAAS_OBS_CLASS is on — default exposition is
        #: byte-identical without it.
        self.attrib = AttributionBook(self.metrics)
        #: bounded ring of structured events around the hot loop —
        #: tick records, sheds, hedge/tenancy decisions from subclasses.
        #: Always on: memory-only plus the /flightrec stats route; it
        #: adds no metric series and no wire fields.
        self.flightrec = FlightRecorder()
        #: fault-injection seam on the worker wire (tpu_faas/chaos):
        #: None when TPU_FAAS_CHAOS is unset — send_wire pays one
        #: identity check and frames stay byte-identical. The shared
        #: process plan binds this dispatcher's flight recorder so every
        #: injection (wire AND store-client) joins the event ring.
        from tpu_faas_torch import chaos as _chaos

        _plan = _chaos.from_env()
        self._chaos_wire = _plan.wire() if _plan is not None else None
        if _plan is not None:
            _plan.bind_flightrec(self.flightrec)
        self.metrics.register_collector(self.collect_metrics)
        #: express result lane (opt-in): > 0 makes every terminal write's
        #: RESULTS_CHANNEL announce carry status + result inline up to this
        #: many result bytes (store/base.py encode_result_announce), so a
        #: gateway's woken long-poll replies from the forwarded payload
        #: instead of a store re-read. 0 (default) keeps the classic
        #: id-only announce — reference-era consumers never see the form
        #: unless the operator enables it. The store write itself is
        #: unchanged (same pipelined round, announce still after the write).
        self.inline_result_max = 0
        #: shared-fleet mode: several dispatchers on one store+channel.
        #: Every dispatcher receives every announce, so intake must CLAIM
        #: each task (one pipelined setnx round per batch) before
        #: dispatching it; losers drop the task — it is some sibling's.
        #: Off by default: a single dispatcher should not pay the extra
        #: round trip per batch.
        self.shared = shared
        self.dispatcher_id = uuid.uuid4().hex[:12]
        self._stop_event = threading.Event()
        #: instance renew cadence, tightened to any rescanner's published
        #: lease_timeout/3 (LEASE_CONF_KEY) — see refresh_lease_renew_period
        self.lease_renew_period = float(self.LEASE_RENEW_PERIOD)
        #: cached (min lease_timeout, published_at) from LEASE_CONF_KEY,
        #: refreshed on every renewal round trip
        self._fleet_lease_conf: tuple[float, float] | None = None
        self.refresh_lease_renew_period()  # outage-safe; renewals retry
        if shared:
            # announce liveness IMMEDIATELY: siblings treat claims whose
            # owner has no fresh heartbeat as adoptable, and the first
            # periodic renewal is a renew-period away
            try:
                self.renew_leases([])
            except STORE_OUTAGE_ERRORS:
                pass  # the serve loop's renewals will retry
        #: result writes that hit a store outage, replayed by
        #: flush_deferred_results() once the store is back — a worker's
        #: finished result must survive a store restart, not evaporate.
        #: 4-tuples (task_id, status, result, first_wins), extended to
        #: 6-tuples with (result_digest, result_size) for digest-form
        #: writes (result-blob plane)
        self.deferred_results: deque[tuple] = deque()
        #: announcements consumed from the subscription whose payload fetch
        #: hit an outage; re-tried before reading the bus again (the bus is
        #: fire-and-forget, so dropping a consumed announce loses the task)
        self._announce_backlog: deque[str] = deque()
        #: polled tasks whose shared-mode claim round hit a store outage:
        #: their announces are spent, so they park here and the claim
        #: retries when the store returns (dispatching unclaimed could
        #: double against a sibling; dropping loses the task)
        self._unclaimed: deque[PendingTask] = deque()
        self._store_down = False
        self._last_flush_attempt = 0.0
        self._stats_server = None
        #: store-failover re-arm state (maybe_rearm_after_failover): the
        #: client generation last re-armed for, the announce-ring offset
        #: already covered, and whether the backend speaks REPLAY at all
        self._store_generation = getattr(self.store, "failover_generation", 0)
        self._announce_offset = -1
        self._replay_supported = True
        try:
            # prime the replay offset so a later failover replays only the
            # window since NOW, not the whole ring's history
            self._announce_offset, _ = self.store.replay_announces(-1)
        except STORE_OUTAGE_ERRORS:
            # whole-ring replay on the first re-arm instead: ring offsets
            # start at 1, so 0 covers everything (NOT the -1 priming
            # sentinel, which asks for the tail alone and would make the
            # first replay return nothing); duplicates are deduped at
            # intake, bounded by the ring
            self._announce_offset = 0
        except Exception:
            # backend without REPLAY (plain Redis): rescan-only re-arm
            self._replay_supported = False
        #: task_id -> note-time for cancel control messages consumed from
        #: the bus (store/base.py cancel_task). Entries are consumed when
        #: the matching task is dropped at a dispatch site; entries whose
        #: task this dispatcher never held (shared-fleet siblings) age out.
        self.cancelled: dict[str, float] = {}
        #: task_id -> note-time for FORCE-cancel control messages (kill a
        #: RUNNING task). Delivery per mode: push relays a CANCEL over the
        #: wire, pull piggy-backs ``cancel_ids`` on the next mandatory
        #: REQ/REP reply, local feeds the pool directly; notes for tasks a
        #: sibling owns (shared fleets) age out. Same bounds as the
        #: cancel notes.
        self.kill_requested: dict[str, float] = {}
        self._last_kill_relay = 0.0
        self.n_cancelled_dropped = 0
        self.n_expired = 0
        self.n_failover_rearms = 0
        #: saturation-signal publishing state (maybe_publish_capacity):
        #: last publish time, result count at that publish, and the
        #: drain-rate EWMA the snapshot carries
        self._cap_published_at: float | None = None
        self._cap_results_at_publish = 0
        self._drain_rate = 0.0
        #: digest -> payload body, byte-bounded LRU: the dispatcher's
        #: resolution cache for the payload plane. One function repeated
        #: across a burst fetches its blob from the store ONCE, however
        #: many legacy workers (or BLOB_MISS rounds) need the body inline.
        self.blob_cache = PayloadLRU(self.BLOB_CACHE_BYTES)
        #: per-sender cumulative misfire-repair counters, as reported on
        #: RESULT messages (worker/pool.py n_misfires): a misfired cancel
        #: interrupt re-executes a bystander task whose side effects may
        #: have partially run — the one at-least-once execution in the
        #: system — so the count must be operator-visible in /stats, not
        #: buried in a worker-side log line. BOUNDED by the live fleet:
        #: a purged sender's total is folded into the scalar below and its
        #: entry dropped (forget_worker_sender) — keyed-per-sender forever,
        #: the dict grew one entry per worker socket identity EVER seen,
        #: a real leak under register/purge churn (VERDICT item 4).
        self.worker_misfires: dict[object, int] = {}
        #: misfires folded from purged senders: a purged identity is never
        #: seen again, so its last cumulative total is final — the fleet
        #: sum stays monotone across purges while the dict stays bounded
        self.worker_misfires_purged = 0
        # -- task graphs (tpu_faas/graph) ----------------------------------
        #: task ids whose record carried FIELD_CHILDREN at intake/reclaim —
        #: the dep-completion gate: flat tasks never pay a dependency probe
        #: on the result path (config 9's throughput bar depends on this)
        self.graph_parents: set[str] = set()
        #: (parent_id, status) dep completions whose store round hit an
        #: outage; replayed by flush_deferred_results (the promotion walk
        #: is idempotent: per-edge claims + the resolution claim)
        self.deferred_dep_completions: deque[tuple[str, str]] = deque()
        self.m_graph_nodes = self.metrics.counter(
            "tpu_faas_graph_nodes_total",
            "Graph-node dependency resolutions this dispatcher's terminal "
            "writes triggered, by outcome: promoted (WAITING->QUEUED, "
            "announced) or poisoned (WAITING->FAILED, dep_failed, never "
            "dispatched)",
            ("outcome",),
        )
        for outcome in ("promoted", "poisoned"):
            self.m_graph_nodes.labels(outcome=outcome)

    #: blob-cache budget (bytes of cached payload bodies); class attr so
    #: tests and specialized deployments can tighten it
    BLOB_CACHE_BYTES = 256 * 1024 * 1024

    # -- payload plane -----------------------------------------------------
    def blob_lookup(self, digest: str) -> str | None:
        """Resolve a content digest to its payload body: dispatcher cache
        first, then ONE store fetch (cached for every later resolution of
        the same digest). Returns None when the blob is gone from the
        store too (GC'd, or a foreign producer wrote a dangling digest);
        raises on a store outage — callers apply their usual parking."""
        cached = self.blob_cache.get(digest)
        if cached is not None:
            self.m_blob_hits.inc()
            return cached
        self.m_blob_misses.inc()
        data = self.store.get_blob(digest)  # raises on outage
        if data is not None:
            self.blob_cache.put(digest, data)
        return data

    def ensure_inline_payload(self, task: PendingTask) -> bool:
        """Materialize ``task.fn_payload`` for a hop that needs the body
        inline (legacy worker, local pool, reference-era consumer). False
        means the blob has vanished and the task was FAILed here — there
        is nothing executable to send, and leaving it pending would park
        it forever. Raises on a store outage with the task untouched."""
        if task.fn_payload or not task.fn_digest:
            return True
        data = self.blob_lookup(task.fn_digest)
        if data is None:
            self.log.error(
                "task %s references blob %s, which is gone from the "
                "store; FAILING it",
                task.task_id,
                task.fn_digest[:16],
                extra=log_ctx(task_id=task.task_id, trace_id=task.trace_id),
            )
            self.fail_task(
                task.task_id,
                f"function blob {task.fn_digest[:16]}... missing from the "
                "store (GC'd or never written)",
            )
            return False
        task.fn_payload = data
        return True

    def note_payload_sent(self, task: PendingTask, blob: bool) -> None:
        """Count the payload bytes one TASK message put on the wire (the
        digest form ships ~64 bytes of digest instead of the body)."""
        n = len(task.param_payload)
        if not (blob and task.fn_digest):
            n += len(task.fn_payload)
        self.m_payload_bytes.inc(n)

    # -- batched data plane (push-family send path) ------------------------
    def send_wire(self, wid, payload: bytes) -> None:
        """Put one framed message on the worker wire (push-family ROUTER
        sockets; subclasses own ``self.socket``). The ONE dispatcher->
        worker send point: the chaos plane's drop/dup/delay seam lives
        here, so every frame class (TASK, CANCEL, BLOB_FILL, RECONNECT)
        is injectable without per-site hooks."""
        if self._chaos_wire is not None:
            self._chaos_wire.send(
                [wid, payload], self.socket.send_multipart
            )
            return
        self.socket.send_multipart([wid, payload])

    def flush_chaos_wire(self) -> None:
        """Release chaos-delayed frames whose hold expired (no-op unless
        a wire.delay rule is armed); serve loops call this once per
        iteration."""
        if self._chaos_wire is not None:
            self._chaos_wire.flush(self.socket.send_multipart)

    def send_task_frame(
        self, buf: dict, wid, caps, task, blob: bool, extra: dict | None = None
    ) -> None:
        """Send — or buffer for a per-worker TASK_BATCH — one assignment.

        The batching gate is capability-negotiated AND operator-opted:
        only a worker that advertised CAP_BATCH, under a dispatcher with
        ``batch_max >= 2``, ever has its frames grouped; everyone else
        gets the per-task TASK frame byte-identically to the unbatched
        build. ``buf`` maps wid -> (bin_capable, [task kwargs...]); a
        worker's buffer reaching batch_max flushes early so one frame
        never exceeds the knob. Callers MUST drain the buffer with
        flush_task_frames before the send round's bookkeeping completes
        (put it in the finally: a buffered task is already tracked
        in-flight, so its frame must reach the wire even on an abort).
        ``extra`` merges additional per-task wire fields (result-blob
        plane: rblob_min / dep_digests / dep_results); None adds nothing,
        keeping the frame byte-identical."""
        kw = task.task_message_kwargs(
            blob=blob, trace=_wm.CAP_TRACE in caps
        )
        if extra:
            kw.update(extra)
        if self.batch_max >= 2 and _wm.CAP_BATCH in caps:
            ent = buf.get(wid)
            if ent is None:
                # third element: per-item SLO classes for the batch
                # plane's attribution at flush time (None = label off)
                ent = buf[wid] = (_wm.CAP_BIN in caps, [], [])
            ent[1].append(kw)
            ent[2].append(
                task.effective_class if self.attrib.enabled else None
            )
            if len(ent[1]) >= self.batch_max:
                buf.pop(wid)
                self._flush_batch_frame(wid, ent[0], ent[1], ent[2])
        else:
            self.send_wire(
                wid, _wm.encode_for(_wm.CAP_BIN in caps, _wm.TASK, **kw)
            )
            self.m_task_frames.inc()
            self.m_batch_size.observe(1.0)
            if self.attrib.enabled:
                self.attrib.note("batch", "solo", task.effective_class)

    def _flush_batch_frame(
        self, wid, bin_cap: bool, items: list, classes: list | None = None
    ) -> None:
        """One buffered worker's frame: a singleton stays a plain TASK
        (identical wire to the unbatched path), K > 1 ship as TASK_BATCH."""
        if classes:
            outcome = "solo" if len(items) == 1 else "bundle_rode"
            for cls in classes:
                if cls is not None:
                    self.attrib.note("batch", outcome, cls)
        if len(items) == 1:
            self.send_wire(
                wid, _wm.encode_for(bin_cap, _wm.TASK, **items[0])
            )
        else:
            self.send_wire(
                wid, _wm.encode_for(bin_cap, _wm.TASK_BATCH, tasks=items)
            )
        self.m_task_frames.inc()
        self.m_batch_size.observe(float(len(items)))

    def flush_task_frames(self, buf: dict) -> None:
        """Drain every buffered per-worker batch onto the wire; safe to
        call twice (the buffer empties as it flushes). Per-worker
        isolation: one worker's send raising (socket torn down mid-stop)
        must not strand the OTHER workers' buffered frames — their tasks
        are already tracked in-flight and would hang until a purge. The
        failing worker's own tasks recover exactly like any lost frame:
        heartbeat purge + reclaim."""
        first_err: BaseException | None = None
        while buf:
            wid, (bin_cap, items, classes) = buf.popitem()
            try:
                self._flush_batch_frame(wid, bin_cap, items, classes)
            except Exception as exc:
                if first_err is None:
                    first_err = exc
                self.log.error(
                    "TASK frame flush to %r failed (%d tasks ride the "
                    "purge/reclaim recovery): %s", wid, len(items), exc,
                )
        if first_err is not None:
            raise first_err

    #: max worker messages decoded per serve-loop round (push-family
    #: ROUTER drains): a worker flooding messages faster than they
    #: dill-decode — the reference worker's unthrottled-heartbeat bug
    #: sends one per busy-loop iteration (push_worker.py:60-62) — must
    #: not starve the purge/dispatch/tick steps; ZMQ buffers the excess
    #: and the level-triggered poller re-fires immediately next round
    _DRAIN_CAP = 2048

    def drain_worker_messages(self, socket, handle) -> int:
        """Bounded ROUTER drain shared by the push-family serve loops:
        recv + decode up to ``_DRAIN_CAP`` worker messages, feeding each
        to ``handle(wid, msg_type, data)``. Returns messages handled."""
        import zmq

        from tpu_faas_torch.worker import messages as m

        n = 0
        for _ in range(self._DRAIN_CAP):
            try:
                wid, raw = socket.recv_multipart(flags=zmq.NOBLOCK)
            except zmq.Again:
                break
            msg_type, data = m.decode(raw)
            handle(wid, msg_type, data)
            n += 1
        return n

    #: cancel notes older than this are discarded by the cap sweep below
    #: (correctness never rides on a note — drop sites verify against the
    #: store — so the TTL only bounds memory, and only needs to fire when
    #: the dict is actually large)
    CANCEL_NOTE_TTL = 900.0
    _CANCEL_NOTE_CAP = 200_000

    # -- cancellation ------------------------------------------------------
    def _note(self, notes: dict[str, float], task_id: str) -> dict:
        """Record a control-message note with the shared bounds: TTL-pruned
        opportunistically, hard-capped against a rogue publisher flooding
        the channel. Returns the (possibly rebuilt) dict."""
        now = time.monotonic()
        notes[task_id] = now
        if len(notes) > self._CANCEL_NOTE_CAP:
            cutoff = now - self.CANCEL_NOTE_TTL
            notes = {t: ts for t, ts in notes.items() if ts > cutoff}
            # evict to a LOW watermark (oldest-first; dicts iterate in
            # insertion order), not just below the cap: trimming one entry
            # would make a sustained flood pay the full O(cap) rebuild on
            # every subsequent message
            while len(notes) > self._CANCEL_NOTE_CAP // 2:
                notes.pop(next(iter(notes)))
        return notes

    def note_cancelled(self, task_id: str) -> None:
        """A cancel control message arrived: remember it so dispatch sites
        can drop the task if it is sitting in a pending structure."""
        self.cancelled = self._note(self.cancelled, task_id)

    def note_kill(self, task_id: str) -> None:
        """A force-cancel control message arrived: remember it so the
        serve loop can relay a CANCEL to the owning worker."""
        self.kill_requested = self._note(self.kill_requested, task_id)

    def note_blobreq(self, digest: str) -> None:
        """A ``!blobreq:<digest>`` materialization request arrived (a
        reader hit a digest-form result record whose blob body is not in
        the store). Default: ignore — only the push-family dispatcher
        under ``--result-blobs`` can pull the body from a producer
        worker's cache (tpu_push overrides). The gateway's bounded poll
        then times the request out against the dead-producer failure
        mode."""

    #: drain_control_messages stops parking announces past this backlog
    #: size — further messages stay in the transport buffer (exactly where
    #: they would sit without the control drain), so a saturated fleet
    #: under a submit flood cannot grow dispatcher memory without bound
    _CONTROL_DRAIN_BACKLOG_CAP = 10_000

    def drain_control_messages(self) -> None:
        """Consume pending CONTROL messages (cancel/kill) from the bus even
        while the dispatch loop isn't pulling tasks — a saturated fleet
        stops calling poll_next_task exactly when a force-cancel matters
        most (a long task hogging the slots). Real task announces
        encountered here are parked in the announce backlog, which
        poll_next_task serves FIRST, so intake order and at-most-once
        semantics are preserved. No store reads: cannot hit an outage."""
        while len(self._announce_backlog) < self._CONTROL_DRAIN_BACKLOG_CAP:
            msg = self.subscriber.get_message()
            if msg is None:
                return
            if msg.startswith(CANCEL_ANNOUNCE_PREFIX):
                self.note_cancelled(msg[len(CANCEL_ANNOUNCE_PREFIX):])
            elif msg.startswith(KILL_ANNOUNCE_PREFIX):
                self.note_kill(msg[len(KILL_ANNOUNCE_PREFIX):])
            elif msg.startswith(BLOBREQ_ANNOUNCE_PREFIX):
                self.note_blobreq(msg[len(BLOBREQ_ANNOUNCE_PREFIX):])
            else:
                self._announce_backlog.append(msg)

    #: relay_kills cadence + per-round scan cap: unmatched notes (shared-
    #: fleet siblings', or a rogue '!kill:' flood) must not turn every
    #: serve-loop iteration into an O(notes x fleet) ownership scan — the
    #: cap examines notes oldest-first (dict insertion order; consumed and
    #: expired entries pop, so the window slides each round)
    _KILL_RELAY_PERIOD = 0.25
    _KILL_RELAY_SCAN_CAP = 1_000

    def relay_kills(self, find_owner, send) -> None:
        """Shared force-cancel relay loop (push-family serve loops):
        ``find_owner(task_id)`` returns an opaque worker address or None;
        ``send(addr, task_id)`` transmits the CANCEL. Matched entries are
        consumed; unmatched ones age out after CANCEL_NOTE_TTL (a
        shared-fleet sibling may own the task, or it already finished).
        Throttled + scan-capped (see above): worst-case kill latency is
        _KILL_RELAY_PERIOD plus queueing behind the cap, paid only under
        a note flood."""
        if not self.kill_requested:
            return
        now = time.monotonic()
        if now - self._last_kill_relay < self._KILL_RELAY_PERIOD:
            return
        self._last_kill_relay = now
        for task_id in list(self.kill_requested)[: self._KILL_RELAY_SCAN_CAP]:
            addr = find_owner(task_id)
            if addr is not None:
                send(addr, task_id)
                self.log.info(
                    "relayed force-cancel for task %s", task_id,
                    extra=log_ctx(task_id=task_id),
                )
                self.kill_requested.pop(task_id, None)
            elif (
                now - self.kill_requested.get(task_id, now)
                > self.CANCEL_NOTE_TTL
            ):
                self.kill_requested.pop(task_id, None)

    def drop_if_cancelled(self, task_id: str) -> bool:
        """True when ``task_id`` was cancelled — the dispatch site must
        drop the task instead of dispatching it (its record already reads
        CANCELLED; no store write is needed). Consumes the note.

        The note alone is NOT trusted: the drop is verified against the
        store, because a note can go stale while the task id stays live —
        an idempotency-keyed resubmit after DELETE reuses the SAME
        deterministic id, and dropping that fresh QUEUED task on a stale
        note would strand it forever. Notes are rare (one per cancel), so
        the verification read is off the hot path. Peek-don't-pop, same
        convention as every other store-read drop site: a store outage
        RAISES with the note intact, so a cleanly-cancelled task cannot
        slip out and execute just because the verification read landed
        mid-outage — callers keep the task pending and retry next tick."""
        if task_id not in self.cancelled:
            return False
        status = self.store.get_status(task_id)  # raises on outage
        self.cancelled.pop(task_id, None)
        if status is not None and status != str(TaskStatus.CANCELLED):
            # stale note, live record: the id was resubmitted
            # (idempotency-key reuse after a DELETE) — dispatch normally;
            # THIS pending copy is that fresh incarnation, delivered by
            # its own create announce
            return False
        # CANCELLED — or vanished entirely (cancelled then DELETEd while
        # still pending here): both mean this copy must never dispatch.
        # Running a vanished one would resurrect the deleted hash as a
        # partial record via the RUNNING mark — the exact resurrection
        # _result_frozen guards against on the result path. A resubmitted
        # incarnation is never lost by this drop: it re-enters pending via
        # its own announce.
        self.n_cancelled_dropped += 1
        self.m_cancelled_dropped.inc()
        self.traces.finish(task_id, outcome="dropped_cancelled")
        self.log.info(
            "dropped cancelled task %s before dispatch", task_id,
            extra=log_ctx(task_id=task_id),
        )
        return True

    # -- task graphs (tpu_faas/graph) --------------------------------------
    def note_waiting(self, task: PendingTask, fields: dict) -> None:
        """A WAITING graph node's announce drained. Default: skip it — the
        store's promotion plane re-announces the node QUEUED when its last
        parent completes, and intake picks that announce up like any
        submit. The tpu-push dispatcher overrides this to hold the node in
        its device frontier, so the child can be placed in the same tick
        its promotion is confirmed instead of waiting out a bus hop."""
        # the drain opened a timeline for this announce; the node's real
        # lifecycle starts at promotion — discard instead of closing, so
        # the promoted intake doesn't read as a duplicate replay
        self.traces.discard(task.task_id)
        self.log.debug(
            "waiting graph node %s; riding the promotion announce",
            task.task_id,
        )

    def note_graph_parent(self, task_id: str, fields) -> None:
        """Record that this task's store record carries dependency children
        (FIELD_CHILDREN) — the result path then (and only then) walks the
        promotion plane for it. Flat tasks never enter the set, so flat
        workloads pay ZERO dependency bookkeeping on the result path."""
        if FIELD_CHILDREN in fields:
            self.graph_parents.add(task_id)

    def complete_deps_safe(self, items) -> None:
        """Run the store promotion plane for the graph parents among these
        landed terminal writes; ``items`` is (task_id, status) pairs. A
        store outage defers the completions for flush_deferred_results —
        the walk is idempotent (per-edge claims + the resolution claim),
        so replaying a partially-applied round converges. Never raises."""
        cand: list[tuple[str, str]] = []
        for task_id, status in items:
            if task_id in self.graph_parents:
                self.graph_parents.discard(task_id)
                cand.append((task_id, str(status)))
        if not cand:
            return
        try:
            promoted, poisoned = self.store.complete_dep_many(
                cand, self.channel
            )
        except STORE_OUTAGE_ERRORS as exc:
            self.deferred_dep_completions.extend(cand)
            self.note_store_outage(exc, pause=0)
            return
        if promoted:
            self.m_graph_nodes.labels(outcome="promoted").inc(len(promoted))
        if poisoned:
            self.m_graph_nodes.labels(outcome="poisoned").inc(len(poisoned))
            # a poisoned child may itself be a registered parent (the
            # store walk already failed ITS frontier): drop the stale
            # entry so the gate set stays bounded by live graph work
            for child in poisoned:
                self.graph_parents.discard(child)
        self.note_deps_resolved(cand, promoted, poisoned)

    def note_deps_resolved(
        self,
        parents: list[tuple[str, str]],
        promoted: list[str],
        poisoned: list[str],
    ) -> None:
        """Hook: a complete_dep_many round SUCCEEDED for ``parents``. The
        tpu-push dispatcher feeds its device frontier here — confirmation
        is what makes the frontier's ready mask imply "record already
        QUEUED" (a frontier dispatch must never touch a WAITING record)."""

    # -- deadline shedding -------------------------------------------------
    def shed_if_expired(self, task: PendingTask) -> bool:
        """True when ``task`` must be dropped instead of dispatched because
        its queue deadline lapsed: the record is shed QUEUED -> EXPIRED
        (store expire_task — conditional, repair-capable), the trace
        closes, and the shed is counted. Also True when the expire probe
        finds the record already terminal or gone (not ours to dispatch
        either way). Reclaimed tasks (retries > 0) are never shed — their
        record is RUNNING, and EXPIRED is QUEUED-only by protocol.

        Raises on a store outage with no state consumed, so callers apply
        their existing parking policy and retry next round. The deadline
        compare is wall-clock BY DESIGN: FIELD_DEADLINE is a cross-process
        epoch stamp written by the gateway, same family as lease/claim
        ages."""
        if task.deadline_at is None or task.retries:
            return False
        if time.time() < task.deadline_at:
            return False
        status = self.store.expire_task(task.task_id, self.channel)
        if status == str(TaskStatus.EXPIRED):
            self.n_expired += 1
            self.m_expired.inc()
            self.attrib.note(
                "dispatch", "shed_expired", task.effective_class
            )
            self.flightrec.emit(
                "queue_shed",
                task_id=task.task_id,
                trace_id=task.trace_id,
                lateness_s=round(time.time() - task.deadline_at, 6),  # faas: allow(obs.wall-clock-latency)
            )
            self.traces.finish(task.task_id, outcome="expired")
            self.log.info(
                "shed task %s: queue deadline lapsed %.3fs ago",
                task.task_id,
                time.time() - task.deadline_at,  # faas: allow(obs.wall-clock-latency)
                extra=log_ctx(task_id=task.task_id, trace_id=task.trace_id),
            )
            return True
        # terminal some other way (cancelled / a zombie's result), or the
        # record vanished, or — pathologically — RUNNING (a duplicate copy
        # was dispatched elsewhere): in every case, dispatching THIS copy
        # would be wrong
        self.traces.finish(task.task_id, outcome="expired_drop")
        return True

    def poll_next_admitted(self) -> PendingTask | None:
        """poll_next_claimed + deadline shedding, outage-safe: a task whose
        expire write hits an outage parks in ``_unclaimed`` (its announce
        is spent; the re-poll re-claims our own claim as a no-op and
        re-tries the shed) — never dropped, never dispatched expired."""
        while True:
            t = self.poll_next_claimed()
            if t is None:
                return None
            try:
                shed = self.shed_if_expired(t)
            except STORE_OUTAGE_ERRORS:
                self._unclaimed.append(t)
                raise
            if not shed:
                return t

    # -- saturation signal -------------------------------------------------
    #: how often the dispatcher publishes its capacity snapshot to the
    #: fleet-health hash (admission/signal.py) — one tiny hash write
    CAPACITY_PUBLISH_PERIOD = 1.0
    #: drain-rate EWMA smoothing (per publish period)
    _DRAIN_ALPHA = 0.5

    def maybe_publish_capacity(
        self, pending: int, inflight: int, capacity: int, results: int
    ) -> None:
        """Publish this dispatcher's capacity snapshot (pending depth,
        inflight, fleet process slots, drain-rate EWMA) to the store's
        fleet-health hash, at most once per CAPACITY_PUBLISH_PERIOD.
        Serve loops call it every iteration; it is a cheap clock compare
        between periods. Raises on a store outage (callers' existing
        outage handling backs off and retries). The span plane's periodic
        flush piggybacks here — every serve loop already calls this each
        iteration, and the flush itself swallows outages."""
        self.maybe_flush_spans()
        now = time.monotonic()
        if (
            self._cap_published_at is not None
            and now - self._cap_published_at < self.CAPACITY_PUBLISH_PERIOD
        ):
            return
        if self._cap_published_at is not None:
            dt = now - self._cap_published_at
            inst = max(0, results - self._cap_results_at_publish) / dt
            self._drain_rate = (
                self._DRAIN_ALPHA * inst
                + (1.0 - self._DRAIN_ALPHA) * self._drain_rate
            )
        # the flight recorder's per-tick record rides the same 1 Hz gate:
        # one ring append per publish period, never per serve iteration
        self.flightrec.emit(
            "tick",
            pending=int(pending),
            inflight=int(inflight),
            capacity=int(capacity),
            results=int(results),
            drain_rate=round(self._drain_rate, 3),
            **self._flightrec_tick_extra(),
        )
        publish_snapshot(
            self.store,
            self.dispatcher_id,
            CapacitySnapshot(
                pending=int(pending),
                inflight=int(inflight),
                capacity=int(capacity),
                drain_rate=self._drain_rate,
                published_at=time.time(),
            ),
        )
        # state advances only on a successful publish: after an outage the
        # next attempt re-measures over the whole gap (rate stays honest)
        self._cap_published_at = now
        self._cap_results_at_publish = results

    def _flightrec_tick_extra(self) -> dict:
        """Extra fields for the flight recorder's per-tick record;
        subclasses enrich (tpu-push adds the device dispatch count and
        the serving tick backend)."""
        return {}

    # -- intake ------------------------------------------------------------
    def enable_columnar(self, capacity: int) -> None:
        """Switch batch intake (poll_tasks) onto the columnar lane: store
        records decode straight into a TaskColumns arena and RowTask views
        flow through the pending structures instead of PendingTasks. Wire,
        store, and dispatch semantics are unchanged — the lane is a memory-
        layout change only, property-pinned by the intake-equivalence
        tests. Size ``capacity`` to the worst-case pending depth (tpu-push
        passes 2x max_pending); overflow degrades to the dict plane per
        task, never errors."""
        self.arena = TaskColumns(capacity)
        # render both lanes at zero from the first scrape; the children are
        # kept as attributes so the intake loop skips the per-call label
        # resolution (a dict probe + lock per task at dispatch rates)
        self._m_intake_arena = self.m_columnar_intake.labels(lane="arena")
        self._m_intake_fallback = self.m_columnar_intake.labels(lane="fallback")

    def _retire_row(self, task, dispatched: bool = False) -> None:
        """Recycle ``task``'s arena row at the moment its fate is sealed.
        ``dispatched`` (the task is on the wire — the hot path, once per
        dispatch) detaches WITHOUT the field snapshot: a reclaim rebuilds
        from the store record, never from this view, so the snapshot would
        be dead work. Permanent drops keep the full snapshot — their views
        can be re-queued or parked and must keep answering. No-op for
        plain PendingTasks and already-detached views, so drop sites call
        it unconditionally. The occupancy gauge refreshes here only on the
        rare drop path; the hot path leaves it to the per-tick refresh
        (intake sets it every poll, tpu-push again at tick end)."""
        if isinstance(task, RowTask) and task.attached:
            if dispatched:
                task.discard()
            else:
                task.release()
                if self.arena is not None:
                    self.m_arena_occupancy.set(float(self.arena.occupancy))

    def poll_next_task(self) -> PendingTask | None:
        """Non-blocking: one announcement -> payload fetch (reference
        query_redis, task_dispatcher.py:38-52). Announcements whose hash has
        vanished (e.g. flushed store) are skipped, moving straight on to the
        next buffered announcement — None strictly means "bus empty"."""
        while True:
            if self._announce_backlog:
                msg, from_backlog = self._announce_backlog[0], True
            else:
                msg, from_backlog = self.subscriber.get_message(), False
                if msg is None:
                    return None
            if msg.startswith(CANCEL_ANNOUNCE_PREFIX):
                # cancel control message, not a task announce: no store
                # read, so it can't hit an outage — never parked
                self.note_cancelled(msg[len(CANCEL_ANNOUNCE_PREFIX):])
                if from_backlog:
                    self._announce_backlog.popleft()
                continue
            if msg.startswith(KILL_ANNOUNCE_PREFIX):
                self.note_kill(msg[len(KILL_ANNOUNCE_PREFIX):])
                if from_backlog:
                    self._announce_backlog.popleft()
                continue
            self.traces.note(msg, "announced")
            try:
                fields = self.store.hgetall(msg)
            except STORE_OUTAGE_ERRORS:
                # the announce is already consumed from the bus; park it so
                # the task isn't silently lost when the store comes back
                if not from_backlog:
                    self._announce_backlog.append(msg)
                raise
            if from_backlog:
                self._announce_backlog.popleft()
            if not _has_payloads(fields):
                self.log.warning("announce for unknown task %s; skipping", msg)
                continue
            if (
                fields.get(FIELD_STATUS) == str(TaskStatus.WAITING)
                and FIELD_DEPS in fields
            ):
                # a graph node announced behind its dependencies: never
                # dispatchable as-is — frontier-capable dispatchers hold
                # it (tpu-push), everyone else waits for the promotion
                # plane's QUEUED re-announce. Register its own forward
                # edges NOW: a frontier-dispatched mid-graph node may
                # never re-enter intake (its promotion announce skips as
                # stale once it is RUNNING), and its children's promotion
                # hangs off this registration
                self.note_graph_parent(msg, fields)
                self.note_waiting(PendingTask.from_fields(msg, fields), fields)
                continue
            if fields.get(FIELD_STATUS) != str(TaskStatus.QUEUED):
                # duplicate or stale announce: the task was already picked up
                # (RUNNING — e.g. adopted by a stranded-task rescan), even
                # finished, or CANCELLED before this dispatcher ever drained
                # its announce; dispatching it would run it twice (or at
                # all). Deliberately does NOT consume a cancel note here: a
                # DUPLICATE announce for a task still held in a pending
                # structure would eat the note and let the cancelled task
                # dispatch — the note is consumed only at drop sites
                # (store-verified there), and a never-matched note is
                # pruned by note_cancelled's cap sweep
                self._close_skipped_timeline(msg, fields.get(FIELD_STATUS))
                self.log.debug("announce for non-QUEUED task %s; skipping", msg)
                continue
            if msg in self.kill_requested:
                # a fresh QUEUED incarnation of this id is entering OUR
                # pending set: any kill note still held must target a
                # PREVIOUS incarnation (the task finished or was cancelled
                # in the publish->relay window, then an idempotency-keyed
                # resubmit reused the same deterministic id). Keeping the
                # note would let relay_kills/_kills_for interrupt the
                # innocent fresh run once it dispatches — for up to
                # CANCEL_NOTE_TTL. Popping here is safe for legitimate
                # kills: they target tasks ALREADY RUNNING, whose announces
                # never reach this return (non-QUEUED skip above); only the
                # narrow duplicate-QUEUED-announce x concurrent-cancel race
                # can eat a live note, degrading force-cancel to its
                # documented best effort.
                self.kill_requested.pop(msg, None)
                self.log.info(
                    "dropped stale kill note for resubmitted task %s", msg
                )
            task = PendingTask.from_fields(msg, fields)
            self.note_graph_parent(msg, fields)
            self._note_intake(task)
            if FIELD_DEPS in fields:
                # a promoted graph child: close its dep_wait span (the
                # WAITING stretch between create and promotion)
                self.traces.note(msg, "promoted")
            return task

    def _close_skipped_timeline(
        self, task_id: str, status: str | None
    ) -> None:
        """An announce for an already-TERMINAL record (cancelled before any
        dispatcher drained it, expired, finished elsewhere) opened a
        timeline at drain time that nothing downstream will ever close —
        stamp it finished NOW with the record's terminal status instead of
        letting it age out of the active ring. Non-terminal skips (a
        duplicate announce for a RUNNING task this dispatcher owns) leave
        the live timeline alone, and an already-closed timeline makes this
        a no-op."""
        if TaskStatus.terminal_str(status, unknown=False):
            # label-vocabulary normalization: shed tasks close as
            # "expired" at every dispatcher drop site (shed_if_expired),
            # and a drained announce for an already-EXPIRED record is the
            # same shed population — the raw record status would split it
            # across terminal="expired" and terminal="EXPIRED"
            outcome = str(status)
            if outcome == str(TaskStatus.EXPIRED):
                outcome = "expired"
            self.traces.finish(task_id, outcome=outcome)

    def drain_announces(self, max_n: int) -> list[str]:
        """Phase 1 of batched intake: pop up to ``max_n`` TASK announces off
        the backlog-then-bus without touching the store. Control messages
        (cancel/kill) are noted in passing — they carry no store read, so
        they can never park — and do not count toward ``max_n``. Returns
        announce payloads in drain order, duplicates included."""
        msgs: list[str] = []
        while len(msgs) < max_n:
            if self._announce_backlog:
                msg = self._announce_backlog.popleft()
            else:
                msg = self.subscriber.get_message()
                if msg is None:
                    break
            if msg.startswith(CANCEL_ANNOUNCE_PREFIX):
                self.note_cancelled(msg[len(CANCEL_ANNOUNCE_PREFIX):])
            elif msg.startswith(KILL_ANNOUNCE_PREFIX):
                self.note_kill(msg[len(KILL_ANNOUNCE_PREFIX):])
            elif msg.startswith(BLOBREQ_ANNOUNCE_PREFIX):
                self.note_blobreq(msg[len(BLOBREQ_ANNOUNCE_PREFIX):])
            else:
                self.traces.note(msg, "announced")
                msgs.append(msg)
        return msgs

    def _note_intake(self, task: PendingTask) -> None:
        """Timeline stamps as a task enters the pending structures: the
        gateway's submit stamp (when the record carries one) plus the
        intake event. Announce receipt was stamped at drain time; a
        rescan-adopted task simply starts its timeline here."""
        if task.submitted_at is not None:
            self.traces.note(task.task_id, "submitted", ts=task.submitted_at)
        self.traces.note(task.task_id, "intake")
        self.traces.note_trace(task.task_id, task.trace_id)
        if self.attrib.enabled:
            self.traces.note_class(task.task_id, task.effective_class)

    def note_dispatch(self, task: PendingTask) -> None:
        """Timeline stamp at the moment a placement decision binds ``task``
        to a worker. Attaches the trace id AFTER the event stamp: a
        rescan-adopted task never passed _note_intake, so the ``scheduled``
        note is what opens its timeline — note_trace only attaches to an
        open one, and its spans must still assemble. A reclaimed task's
        re-dispatch re-stamps ``scheduled`` as a matter of course — that
        duplicate is routine retry traffic, not a replay storm, so it must
        not tick the duplicate counter."""
        self.traces.note(
            task.task_id, "scheduled", count_dup=task.retries == 0
        )
        self.traces.note_trace(task.task_id, task.trace_id)

    #: span catalog this process contributes to the cross-process timeline:
    #: (process, stage, from_event, to_event) over the 9-event timeline.
    #: The worker's execution window is emitted here ON ITS BEHALF — the
    #: stamps are worker-measured (RESULT started_at/elapsed) but workers
    #: have no store access, so the dispatcher persists them.
    _SPAN_STAGES = (
        # graph children only: the WAITING stretch between the gateway's
        # create and the promotion plane flipping the node QUEUED (both
        # endpoints absent on flat tasks, so the span simply never emits)
        ("dispatcher", "dep_wait", "submitted", "promoted"),
        # the express-lane intake stage: gateway submit stamp -> this
        # dispatcher draining the announce off the bus. With tick-cadence
        # intake its p99 rides the tick period; event-driven intake
        # (tpu-push --express) pins it well below — the trace-visible
        # proof that a submit's intake latency stopped being tick-quantized
        ("dispatcher", "announce_wait", "submitted", "announced"),
        ("dispatcher", "intake", "announced", "intake"),
        ("dispatcher", "queue", "intake", "scheduled"),
        ("dispatcher", "dispatch", "scheduled", "sent"),
        ("dispatcher", "inflight", "sent", "result_received"),
        ("dispatcher", "finalize", "result_received", "finished"),
        ("worker", "exec", "exec_start", "exec_end"),
    )

    def _emit_trace_spans(self, record: dict) -> None:
        """TaskTraceBook close hook: decompose one closed timeline into
        span records for the store-backed span plane. No-op for untraced
        tasks; buffer-only (the periodic maybe_flush_spans pays the store
        round trip). The finalize span carries the outcome + retry count
        so the assembled timeline says how the task ended."""
        trace_id = record.get("trace_id")
        if not trace_id:
            return
        events = record["events"]
        for process, stage, a, b in self._SPAN_STAGES:
            if a not in events or b not in events:
                continue
            t0, t1 = events[a], events[b]
            if t1 < t0:
                continue
            attrs: dict = {}
            if stage == "finalize":
                attrs = {
                    "outcome": record["outcome"],
                    "retries": record["retries"],
                }
            elif stage == "exec" and "hedge_launched" in events:
                # speculation plane: a hedged task's timeline carries the
                # race WINNER's window (the loser's late stamps land on a
                # closed timeline and no-op), so tag it; the cancelled
                # leg rides its own ``exec_replica`` span (tpu_push emits
                # it at the loser-result site under a distinct field name
                # — a second write to ``worker:exec`` would silently lose
                # the span plane's first-write-wins HSETNX).
                attrs = {"hedge": "winner"}
                for leg in ("replica", "original", "promoted"):
                    if f"hedge_won_{leg}" in events:
                        attrs["winner_leg"] = leg
                        break
            self.spans.emit_as(
                process,
                trace_id,
                stage,
                t0,
                t1,
                task_id=record["task_id"],
                **attrs,
            )

    #: how often buffered spans flush to the store (one pipelined
    #: first-write-wins round per flush; internally outage-tolerant)
    SPAN_FLUSH_PERIOD = 0.25

    def maybe_flush_spans(self) -> None:
        if not self.spans.dirty:
            return
        now = time.monotonic()
        if now - self._last_span_flush < self.SPAN_FLUSH_PERIOD:
            return
        self._last_span_flush = now
        self.spans.flush()

    def poll_tasks(self, max_n: int) -> list[PendingTask]:
        """Batch intake, pipelined: drain up to ``max_n`` announces from the
        bus FIRST (cheap, store-free), then fetch every announced record in
        ONE ``hgetall_many`` round trip — the reference pattern (and
        poll_next_task) pays one round trip per announce. Per-announce
        semantics are unchanged: unknown records are skipped with a
        warning, non-QUEUED announces are skipped without consuming cancel
        notes, stale kill notes are dropped when a fresh QUEUED incarnation
        arrives, and duplicates within the drain are deduped.

        Outage contract: the batch is all-or-nothing — if the single fetch
        round fails, EVERY drained announce is parked back at the head of
        the backlog in order (their bus copies are spent; dropping them
        would lose tasks) and the outage propagates. Callers keep whatever
        they already hold and retry next tick."""
        msgs = self.drain_announces(max_n)
        if not msgs:
            return []
        # duplicate announce inside one drain: both copies still read
        # status QUEUED (the non-QUEUED skip only protects across rounds,
        # after mark_running lands), e.g. a dedup-loser's claim adoption
        # racing the winner's create. Dispatching both would run the task
        # twice — fetch and deliver each id once.
        unique = list(dict.fromkeys(msgs))
        if self.arena is not None:
            return self._poll_tasks_columnar(msgs, unique)
        try:
            records = self.store.hgetall_many(unique)
        except BaseException:
            # ANY failure parks the batch, not just the outage family: the
            # announces are spent either way, and a store error reply (one
            # WRONGTYPE key poisoning the pipelined fetch) must not lose
            # the healthy announces drained alongside it
            self._announce_backlog.extendleft(reversed(msgs))
            raise
        out: list[PendingTask] = []
        for msg, fields in zip(unique, records):
            if not _has_payloads(fields):
                self.log.warning("announce for unknown task %s; skipping", msg)
                continue
            if (
                fields.get(FIELD_STATUS) == str(TaskStatus.WAITING)
                and FIELD_DEPS in fields
            ):
                # graph node behind its dependencies (see poll_next_task);
                # forward edges registered here for the same reason
                self.note_graph_parent(msg, fields)
                self.note_waiting(PendingTask.from_fields(msg, fields), fields)
                continue
            if fields.get(FIELD_STATUS) != str(TaskStatus.QUEUED):
                # duplicate or stale announce (see poll_next_task): never
                # dispatch, and never consume a cancel note here
                self._close_skipped_timeline(msg, fields.get(FIELD_STATUS))
                self.log.debug("announce for non-QUEUED task %s; skipping", msg)
                continue
            if msg in self.kill_requested:
                # fresh QUEUED incarnation entering OUR pending set: any
                # held kill note targets a previous incarnation (full
                # rationale in poll_next_task)
                self.kill_requested.pop(msg, None)
                self.log.info(
                    "dropped stale kill note for resubmitted task %s", msg
                )
            task = PendingTask.from_fields(msg, fields)
            self.note_graph_parent(msg, fields)
            self._note_intake(task)
            if FIELD_DEPS in fields:
                # promoted graph child (see poll_next_task)
                self.traces.note(msg, "promoted")
            out.append(task)
        return out

    def _poll_tasks_columnar(
        self, msgs: list[str], unique: list[str]
    ) -> list[PendingTask]:
        """poll_tasks' columnar lane (--columnar): the ONE record fetch
        goes over ``hgetall_many_raw`` — flat [field, value, ...] lists,
        raw bytes end to end on a binbatch store connection — and each
        QUEUED announce decodes straight into the TaskColumns arena. No
        per-task record dict is built anywhere on the hot path: control
        routing reads a field-name set (+ status), and the RowTask views
        returned here duck-type PendingTask for every downstream consumer.
        Per-announce semantics, skip rules, and the all-or-nothing outage
        contract are poll_tasks' own, mirrored branch for branch (the
        intake-equivalence property test pins the two lanes to identical
        dispatch decisions); the rare branches that genuinely need a dict
        (WAITING graph nodes, arena-full fallback) materialize one."""
        try:
            records = self.store.hgetall_many_raw(unique)
        except BaseException:
            # same parking contract as the dict lane: the announces are
            # spent, so ANY fetch failure re-parks the whole drain
            self._announce_backlog.extendleft(reversed(msgs))
            raise
        arena = self.arena
        out: list[PendingTask] = []
        n_arena = n_fallback = 0
        for msg, flat in zip(unique, records):
            names, status = _flat_control(flat)
            if not _has_payloads(names):
                self.log.warning("announce for unknown task %s; skipping", msg)
                continue
            if status == str(TaskStatus.WAITING) and FIELD_DEPS in names:
                # graph node behind its dependencies (see poll_next_task):
                # held host-side as a classic PendingTask — frontier nodes
                # outlive intake and the dict is built once, off the hot
                # path
                fields = _flat_dict(flat)
                self.note_graph_parent(msg, fields)
                self.note_waiting(PendingTask.from_fields(msg, fields), fields)
                continue
            if status != str(TaskStatus.QUEUED):
                # duplicate or stale announce (see poll_next_task): never
                # dispatch, and never consume a cancel note here
                self._close_skipped_timeline(msg, status)
                self.log.debug("announce for non-QUEUED task %s; skipping", msg)
                continue
            if msg in self.kill_requested:
                # fresh QUEUED incarnation entering OUR pending set: any
                # held kill note targets a previous incarnation (full
                # rationale in poll_next_task)
                self.kill_requested.pop(msg, None)
                self.log.info(
                    "dropped stale kill note for resubmitted task %s", msg
                )
            task = arena.intake_flat(msg, flat)
            if task is None:
                # arena full: the dict plane absorbs the overflow with
                # identical semantics — degraded allocation cost, visible
                # on the lane counter and the pinned occupancy gauge
                task = PendingTask.from_fields(msg, _flat_dict(flat))
                n_fallback += 1
                self.attrib.note(
                    "columnar", "fallback", task.effective_class
                )
            else:
                n_arena += 1
                self.attrib.note("columnar", "arena", task.effective_class)
            self.note_graph_parent(msg, names)
            self._note_intake(task)
            if FIELD_DEPS in names:
                # promoted graph child (see poll_next_task)
                self.traces.note(msg, "promoted")
            out.append(task)
        # lane counters tick once per drain, not once per task — same
        # series, a fraction of the lock traffic
        if n_arena:
            self._m_intake_arena.inc(n_arena)
        if n_fallback:
            self._m_intake_fallback.inc(n_fallback)
            self.flightrec.emit(
                "arena_fallback",
                n=n_fallback,
                occupancy=int(arena.occupancy),
            )
        self.m_arena_occupancy.set(float(arena.occupancy))
        return out

    # -- shared-fleet dispatch claims --------------------------------------
    def _claim_value(self) -> str:
        return f"{self.dispatcher_id}:{time.time()}"

    @staticmethod
    def claim_age(claim: str | None, now_wall: float) -> float:
        """Seconds since a dispatch claim was written; missing/garbled =
        infinitely stale (nobody live owns it)."""
        if claim is None:
            return float("inf")
        parts = claim.rsplit(":", 1)
        try:
            return now_wall - float(parts[1])
        except (IndexError, ValueError):
            return float("inf")

    def claim_for_dispatch(
        self, tasks: list[PendingTask]
    ) -> list[PendingTask]:
        """Shared mode: keep only the tasks THIS dispatcher owns.

        One pipelined setnx round claims every task in the batch
        atomically; a loser's task belongs to a sibling dispatcher and is
        dropped here (its copy of the announce is spent — the owner has
        its own). A claim that already belongs to us (re-poll of our own
        claimed task, e.g. after an outage-aborted tick) is kept.
        In single-dispatcher mode this is the identity function."""
        if not self.shared or not tasks:
            return tasks
        value = self._claim_value()
        results = self.store.setnx_fields(
            [
                (t.task_id, value)
                for t in tasks
            ],
            claim_field_for(0),
        )
        kept = []
        for t, (created, current) in zip(tasks, results):
            if created or current.startswith(self.dispatcher_id + ":"):
                kept.append(t)
            else:
                # a sibling owns it: its lifecycle is theirs to trace
                self.traces.discard(t.task_id)
                self._retire_row(t)
        if len(kept) != len(tasks):
            self.log.debug(
                "dispatch claims: kept %d/%d (rest owned by siblings)",
                len(kept),
                len(tasks),
            )
        return kept

    def poll_next_claimed(self) -> PendingTask | None:
        """poll_next_task + the shared-mode ownership claim, outage-safe:
        a task whose claim round fails mid-outage parks in ``_unclaimed``
        (its announce is spent) and is re-tried first on the next call —
        never dropped, never dispatched unclaimed. The single-task analog
        of tpu-push's batched intake; identity behavior when not shared."""
        while self._unclaimed:
            t = self._unclaimed[0]  # peek: the claim below may raise
            if self.claim_for_dispatch([t]):
                self._unclaimed.popleft()
                return t
            self._unclaimed.popleft()  # a sibling's after all
        while True:
            t = self.poll_next_task()
            if t is None:
                return None
            try:
                kept = self.claim_for_dispatch([t])
            except STORE_OUTAGE_ERRORS:
                self._unclaimed.append(t)
                raise
            if kept:
                return t

    def claim_adoption(
        self,
        task_id: str,
        generation: int,
        stale_after: float,
        alive: set[str] | None = None,
    ) -> bool:
        """Arbitrate an ADOPTION of an orphaned task among sibling
        dispatchers: exactly one wins the write-once claim field for this
        reclaim generation. If the generation's winner ITSELF died before
        re-dispatching (its claim aged past ``stale_after`` without the
        generation counter advancing AND its owner is not in ``alive``),
        take the claim over — a bounded overwrite race between two takers
        is possible there, and the result write's first_wins freezing
        keeps delivery single even if execution doubles. A claim held by a
        LIVE owner is never taken, however old: claim fields are stamped
        once, not renewed, so age alone cannot distinguish a dead owner
        from a busy one. Single-dispatcher mode always wins."""
        if not self.shared:
            return True
        field = claim_field_for(generation)
        created, current = self.store.setnx_field(
            task_id, field, self._claim_value()
        )
        if created or current.startswith(self.dispatcher_id + ":"):
            return True
        owner = self.claim_owner(current)
        if alive is None:
            alive = self.read_live_dispatchers(stale_after)
        if owner in alive:
            return False
        if self.claim_age(current, time.time()) > stale_after:
            self.store.hset(task_id, {field: self._claim_value()})
            return True
        return False

    def read_live_dispatchers(self, stale_after: float) -> set[str]:
        """Dispatcher ids whose liveness heartbeat (DISPATCHERS_KEY) is
        fresher than ``stale_after`` seconds. Long-dead entries (every
        restart mints a fresh id, nothing else removes them) are GC'd in
        passing so the registry — read whole on every rescan — stays
        bounded by the live fleet, not by restarts-ever."""
        now_wall = time.time()
        alive: set[str] = set()
        ancient: list[str] = []
        for did, stamp in self.store.hgetall(DISPATCHERS_KEY).items():
            try:
                age = now_wall - float(stamp)
            except ValueError:
                ancient.append(did)
                continue
            if age <= stale_after:
                alive.add(did)
            elif age > 20 * max(stale_after, 1.0):
                ancient.append(did)
        if ancient:
            self.store.hdel(DISPATCHERS_KEY, *ancient)
        return alive

    @staticmethod
    def claim_owner(claim: str | None) -> str | None:
        if claim is None:
            return None
        return claim.rsplit(":", 1)[0]

    # -- store writes ------------------------------------------------------
    def mark_running(
        self, task_id: str, *, redispatch: bool = False, retries: int = 0
    ) -> None:
        """``redispatch=True`` on the recovery path (task reclaimed from a
        purged worker, re-sent to a replacement) — it declares the second
        RUNNING write through the store's protocol-checker hook so an
        attached race monitor (store/racecheck.py) can tell deliberate
        re-dispatch from double-dispatch. ``retries`` is persisted on that
        path so the poison guard survives dispatcher restarts."""
        if redispatch:
            self.store.declare_redispatch(task_id)
        # the lease stamp rides the same write: a RUNNING record whose lease
        # goes stale (worker AND dispatcher died before the result) is
        # adoptable by a later rescan instead of stranded forever
        extra = {FIELD_LEASE_AT: repr(time.time())}
        if redispatch:
            extra[FIELD_RECLAIMS] = str(retries)
        self.store.set_status(task_id, TaskStatus.RUNNING, extra_fields=extra)

    def record_result(
        self,
        task_id: str,
        status: str,
        result: str,
        first_wins: bool = False,
        result_digest: str | None = None,
        result_size: int = 0,
    ) -> None:
        """``first_wins=True`` on paths where a second result for the same
        task is possible (zombie worker of a re-dispatched task).
        ``result_digest``/``result_size`` (result-blob plane): record the
        DIGEST FORM — the record stores the digest instead of the body,
        which stays in the producing worker's cache until pulled."""
        self.store.finish_task(
            task_id, status, result,
            first_wins=first_wins, inline_max=self.inline_result_max,
            result_digest=result_digest, result_size=result_size,
        )
        self.m_result_store_bytes.labels(dir="write").inc(len(result))
        self._note_finished(task_id, status)
        self.complete_deps_safe([(task_id, status)])

    def _note_finished(self, task_id: str, status: str) -> None:
        """Terminal write landed: close the task's timeline and count the
        result. ONE place, so every write path (single, batched, deferred
        replay) agrees on what 'finished' means."""
        self.m_results.labels(status=str(status)).inc()
        self.traces.finish(task_id, outcome=str(status))

    def mark_running_safe(
        self, task_id: str, *, redispatch: bool = False, retries: int = 0
    ) -> bool:
        """mark_running that degrades on a store outage instead of raising:
        callers use it when the task is already (or imminently) on its way to
        a worker — the terminal result write, which is deferred-capable,
        supersedes a missing RUNNING mark. Returns False when skipped."""
        try:
            self.mark_running(task_id, redispatch=redispatch, retries=retries)
            return True
        except STORE_OUTAGE_ERRORS as exc:
            self.note_store_outage(exc, pause=0)
            return False

    def mark_running_many(self, task_ids) -> bool:
        """Coalesced mark_running for the act phase's common path (no
        retries, no redispatch declaration): every RUNNING transition of a
        tick flushed as ONE pipelined round, each record still carrying its
        ownership lease stamp. Same degrade-on-outage contract as
        mark_running_safe — the tasks are already on the wire, and the
        deferred-capable terminal write supersedes a missing RUNNING mark.
        Returns False when the flush was skipped on an outage."""
        if not task_ids:
            return True
        stamp = repr(time.time())
        try:
            self.store.set_status_many(
                TaskStatus.RUNNING,
                [(tid, {FIELD_LEASE_AT: stamp}) for tid in task_ids],
            )
            return True
        except STORE_OUTAGE_ERRORS as exc:
            self.note_store_outage(exc, pause=0)
            return False

    def record_results_safe(self, items) -> int:
        """Batched record_result_safe: pipeline every terminal write of a
        worker-message drain into one ``finish_task_many`` round (plus one
        status pre-read for the first_wins slice, on RESP backends). Items
        are (task_id, status, result, first_wins) — the deferred_results
        tuple shape — optionally extended to 6-tuples with
        (result_digest, result_size) for digest-form writes (result-blob
        plane). A store outage defers EVERY item, order preserved,
        for flush_deferred_results to replay. Returns items written now."""
        if not items:
            return 0
        items = list(items)
        try:
            self.store.finish_task_many(
                items, inline_max=self.inline_result_max
            )
            self.note_store_up()
            for it in items:
                self.m_result_store_bytes.labels(dir="write").inc(len(it[2]))
                self._note_finished(it[0], it[1])
            self.complete_deps_safe([(it[0], it[1]) for it in items])
            return len(items)
        except STORE_OUTAGE_ERRORS as exc:
            # a mid-pipeline loss is ambiguous (a prefix may have applied);
            # deferring the WHOLE batch is safe because the replay is
            # idempotent — finish writes land the same end state, repeated
            # RESULTS_CHANNEL publishes are tolerated spurious wakes, and
            # first_wins items re-check the frozen guard at replay time
            self.deferred_results.extend(items)
            self.note_store_outage(exc, pause=0)
            return 0

    def record_result_safe(
        self,
        task_id: str,
        status: str,
        result: str,
        first_wins: bool = False,
        result_digest: str | None = None,
        result_size: int = 0,
    ) -> bool:
        """Like record_result, but a store outage defers the write instead of
        raising: the result was already computed and received — losing it
        would leave the task RUNNING forever on a live worker (never purged,
        never re-dispatched). Returns False when deferred."""
        try:
            # record_result closes the timeline + counts the result
            self.record_result(
                task_id, status, result, first_wins=first_wins,
                result_digest=result_digest, result_size=result_size,
            )
            self.note_store_up()
            return True
        except STORE_OUTAGE_ERRORS as exc:
            # pause=0: this runs inside the worker-message drain loop, where
            # a per-message sleep would stall the fleet; backoff belongs to
            # the outer serve loop. Digest-form writes defer as 6-tuples;
            # the classic 4-tuple shape is preserved for everything else.
            if result_digest:
                self.deferred_results.append(
                    (task_id, status, result, first_wins,
                     result_digest, result_size)
                )
            else:
                self.deferred_results.append(
                    (task_id, status, result, first_wins)
                )
            self.note_store_outage(exc, pause=0)
            return False

    #: deferred-result replay batch bound: keeps one replay pipeline's
    #: buffered commands (result payloads included) from ballooning after
    #: a long outage, while still collapsing the common case to one round
    _DEFERRED_REPLAY_CHUNK = 512

    def flush_deferred_results(self) -> int:
        """Replay writes deferred during an outage in pipelined chunks
        (order preserved); stops the moment the store fails again — the
        un-replayed tail keeps its order for the next attempt, and a chunk
        whose pipeline died ambiguously is retried WHOLE (safe: the replay
        is idempotent, see record_results_safe). Call once per loop
        iteration — while the store is known down, actual attempts are
        rate-limited so a slow-to-fail connect (packet black hole) can't
        stall every tick."""
        if (
            self._store_down
            and time.monotonic() - self._last_flush_attempt < 0.5
        ):
            return 0
        self._last_flush_attempt = time.monotonic()
        n = 0
        while self.deferred_results:
            # islice, not integer indexing: deque indexing is O(i) from the
            # nearest end, which would make chunk building O(chunk^2) on
            # the post-outage recovery path
            chunk = list(
                itertools.islice(
                    self.deferred_results, self._DEFERRED_REPLAY_CHUNK
                )
            )
            try:
                self.store.finish_task_many(
                    chunk, inline_max=self.inline_result_max
                )
            except STORE_OUTAGE_ERRORS as exc:
                self.note_store_outage(exc)
                break
            for it in chunk:
                self.deferred_results.popleft()
                self._note_finished(it[0], it[1])
            self.complete_deps_safe([(it[0], it[1]) for it in chunk])
            n += len(chunk)
        if n:
            self.note_store_up()
            self.log.info("replayed %d result writes deferred during outage", n)
        # dep completions whose own store round died mid-outage: replay
        # them too (idempotent walk — see complete_deps_safe); re-parked
        # by complete_deps_safe itself if the store is still dark
        if self.deferred_dep_completions and not self.deferred_results:
            replay = list(self.deferred_dep_completions)
            self.deferred_dep_completions.clear()
            self.graph_parents.update(tid for tid, _ in replay)
            self.complete_deps_safe(replay)
        return n

    # -- store failover re-arm (store HA, store/replication.py) -------------
    def maybe_rearm_after_failover(self) -> bool:
        """Detect that the store client failed over to a different
        endpoint (a promoted replica) and re-arm dispatch: replay the
        announce ring since the last covered offset into the announce
        backlog — tasks announced on the dead primary but never drained
        re-enter intake, where the usual dedup (non-QUEUED skip,
        pending-id check) makes duplicates harmless — and report True so
        the serve loop runs an immediate adopt-by-rescan round on top.
        Cheap when nothing happened: one int compare per call.

        Outage-safe: a replay that fails mid-outage leaves the generation
        un-consumed, so the next loop iteration retries the whole re-arm;
        backends without REPLAY degrade to rescan-only re-arm."""
        gen = getattr(self.store, "failover_generation", 0)
        if gen == self._store_generation:
            return False
        replayed = 0
        if self._replay_supported:
            try:
                tail, entries = self.store.replay_announces(
                    self._announce_offset
                )
            except STORE_OUTAGE_ERRORS:
                raise  # generation stays un-consumed: retried next loop
            except Exception:
                self._replay_supported = False
            else:
                for channel, payload in entries:
                    if channel == self.channel:
                        self._announce_backlog.append(payload)
                        replayed += 1
                self._announce_offset = tail
        self._store_generation = gen
        self.n_failover_rearms += 1
        self.m_failover_rearms.inc()
        self.log.warning(
            "store failover detected (generation %d): replayed %d "
            "announces from the ring; re-arming rescan",
            gen,
            replayed,
        )
        return True

    # -- store outage tracking ----------------------------------------------
    def note_store_outage(self, exc: BaseException, pause: float = 0.2) -> None:
        """Log (once per outage, not per tick) and back off briefly so a
        down store doesn't turn the serve loop into a reconnect spin."""
        if not self._store_down:
            self._store_down = True
            self.log.warning("store unreachable (%s); degrading until it returns", exc)
        if pause > 0:
            self._stop_event.wait(pause)  # interruptible sleep

    def note_store_up(self) -> None:
        if self._store_down:
            self._store_down = False
            self.log.info("store reachable again")

    def fail_task(self, task_id: str, reason: str) -> None:
        """Terminal FAILED write with a client-deserializable exception as the
        result (same payload shape the executor's catch-all produces). Never
        overwrites a real result that arrived first."""
        self.record_result(
            task_id,
            str(TaskStatus.FAILED),
            serialize(RuntimeError(reason)),
            first_wins=True,
        )

    def stats(self) -> dict:
        """Observability snapshot (subclasses extend); cheap enough to call
        from a metrics poller."""
        return {
            "store_down": self._store_down,
            "deferred_results": len(self.deferred_results),
            "announce_backlog": len(self._announce_backlog),
            "cancelled_dropped": self.n_cancelled_dropped,
            "expired": self.n_expired,
            "failover_rearms": self.n_failover_rearms,
            "drain_rate": round(self._drain_rate, 3),
            "worker_misfires": self.total_worker_misfires(),
            "blob_cache": {
                "entries": len(self.blob_cache),
                "bytes": self.blob_cache.n_bytes,
                "hits": self.blob_cache.hits,
                "misses": self.blob_cache.misses,
            },
            "graph": {
                "parents_tracked": len(self.graph_parents),
                "deferred_dep_completions": len(
                    self.deferred_dep_completions
                ),
            },
            **self._sharding_stats(),
        }

    def _sharding_stats(self) -> dict:
        """Sharded-control-plane stats block ({} on single-store stacks):
        shard count, this dispatcher's owned slice (None = all), and the
        per-shard failover generations — which shard promoted is the
        first question of the shard-kill runbook."""
        shards = getattr(self.store, "shard_count", 0)
        if not shards or shards < 2:
            return {}
        gens_fn = getattr(self.store, "shard_failover_generations", None)
        return {
            "sharding": {
                "shards": shards,
                "owned": getattr(self.store, "owned_shards", None),
                "failover_generations": (
                    gens_fn() if gens_fn is not None else None
                ),
            }
        }

    def collect_metrics(self) -> None:
        """Refresh scrape-time gauges from live state; runs at the top of
        every /metrics render (registry collector). Subclasses extend with
        their queue/fleet gauges; everything here must be cheap and safe to
        call from the stats thread while the serve loop mutates — dict
        ITERATION over serve-loop-owned state must be resize-guarded (the
        same stats-thread convention as tpu_push._backlog_estimate_s): a
        concurrent insert raises RuntimeError, and the gauge just keeps
        its previous value for this scrape."""
        self.m_store_down.set(1.0 if self._store_down else 0.0)
        self.m_deferred.set(len(self.deferred_results))
        self.m_announce_backlog.set(len(self._announce_backlog))
        try:
            self.m_misfires.set(self.total_worker_misfires())
        except RuntimeError:  # dict resized mid-iteration: next scrape
            pass

    def note_result_message(self, task_id: str, data: dict) -> None:
        """Timeline events carried by one RESULT message: the worker's
        source-measured execution window (``started_at`` + ``elapsed``,
        absent from reference-era workers) plus the receipt stamp. Shared
        by every mode's result drain. ``open_new=False`` throughout: a
        zombie's late second RESULT for an already-finished task must not
        resurrect the closed timeline as a duplicate."""
        started = data.get("started_at")
        if isinstance(started, (int, float)):
            self.traces.note(
                task_id, "exec_start", ts=float(started), open_new=False
            )
            elapsed = data.get("elapsed")
            if isinstance(elapsed, (int, float)):
                self.traces.note(
                    task_id,
                    "exec_end",
                    ts=float(started) + float(elapsed),
                    open_new=False,
                )
        self.traces.note(task_id, "result_received", open_new=False)

    def note_worker_misfires(self, sender: object, data: dict) -> None:
        """Track the cumulative ``misfires`` counter a RESULT message
        carries (absent from reference-era workers). Keyed per sender
        because each worker reports its own monotonic total; purge paths
        MUST call forget_worker_sender so the dict stays bounded by the
        live fleet."""
        count = data.get("misfires")
        if isinstance(count, int) and count > 0:
            self.worker_misfires[sender] = count

    def forget_worker_sender(self, sender: object) -> None:
        """A worker identity was purged: fold its final cumulative misfire
        total into the scalar and drop the entry. Its socket identity is
        never seen again (zombies re-register fresh), so without this every
        register/purge/reconnect cycle leaked one dict entry forever."""
        self.worker_misfires_purged += self.worker_misfires.pop(sender, 0)

    def total_worker_misfires(self) -> int:
        """Fleet misfire total: live senders' cumulative counters plus the
        folded totals of purged ones. May raise RuntimeError if the dict
        resizes mid-iteration (stats-thread callers guard)."""
        return self.worker_misfires_purged + sum(
            self.worker_misfires.values()
        )

    def reclaim_or_fail(
        self, task_id: str, prior_retries: int, max_retries: int
    ) -> PendingTask | None:
        """Phase-1 (store I/O only) half of a dead-worker reclaim, shared by
        every mode that tracks in-flight tasks: bump the retry count, FAIL
        the task if it has now taken down more than ``max_retries`` workers
        (poison guard; first_wins makes a retried fail_task idempotent),
        else rebuild its PendingTask with hints intact. Returns None when
        there is nothing to re-queue (failed, or payloads vanished). Raises
        on a store outage — callers mutate bookkeeping only afterwards, so
        an aborted purge retries cleanly."""
        retries = prior_retries + 1
        if retries > max_retries:
            self.log.error(
                "task %s lost with its worker %d times; FAILED",
                task_id,
                retries,
                extra=log_ctx(task_id=task_id),
            )
            self.fail_task(
                task_id,
                f"task lost with its worker {retries} times "
                f"(max_task_retries={max_retries})",
            )
            return None
        pt = self.fetch_reclaim(task_id, retries)
        if pt is not None:
            self.m_reclaimed.inc()
            self.traces.note_retry(task_id)
        return pt

    #: How often a dispatcher re-stamps the lease of its in-flight tasks.
    #: Must stay well under any rescanner's lease_timeout (tpu-push default
    #: 30 s): EVERY dispatcher mode renews — a push/pull dispatcher sharing
    #: a store with a tpu-push one would otherwise see its long-running
    #: tasks adopted out from under it (stamped once at RUNNING, never
    #: renewed, stale after lease_timeout even with everyone alive).
    LEASE_RENEW_PERIOD = 10.0

    def renew_leases(self, task_ids) -> None:
        """Re-stamp the ownership lease of every given in-flight task in one
        pipelined round trip; while these writes keep landing, no rescan
        will adopt them. In shared mode the dispatcher's own liveness
        heartbeat rides the same round trip (DISPATCHERS_KEY) — siblings
        use it to tell a dead claim owner from a merely busy one; unshared
        dispatchers don't pollute the registry.

        Each call also re-reads the fleet lease config (one extra hget per
        renew period — negligible) so a rescanner that joins with a tight
        ``--lease-timeout`` AFTER this dispatcher started still tightens
        our cadence within one renew period."""
        stamp = repr(time.time())
        items = [(tid, {FIELD_LEASE_AT: stamp}) for tid in task_ids]
        if self.shared:
            items.append((DISPATCHERS_KEY, {self.dispatcher_id: stamp}))
        if items:
            self.store.hset_many(items)
        self.refresh_lease_renew_period()

    def read_fleet_lease_conf(self) -> tuple[float, float] | None:
        """The fleet's tightest published adoption horizon, as
        (lease_timeout, published_at_wall_seconds), or None if no rescanner
        ever published. Each publisher writes its horizon under a
        value-keyed field via setnx (see publish_lease_timeout), so the
        minimum over fields is exact under any concurrent interleaving —
        there is no read-modify-write to race on."""
        entries = self.store.hgetall(LEASE_CONF_KEY)
        best: tuple[float, float] | None = None
        for fld, stamp in entries.items():
            if not fld.startswith("t:"):
                continue
            try:
                value, published = float(fld[2:]), float(stamp)
            except ValueError:
                continue
            if value > 0 and (best is None or value < best[0]):
                best = (value, published)
        return best

    def refresh_lease_renew_period(self) -> None:
        """Fold the fleet's published minimum lease_timeout into this
        dispatcher's renew cadence: renew at timeout/3 when that is tighter
        than the current period, so a live owner can miss two renewals
        before any rescanner's adoption horizon. Monotonically tightening —
        a rescanner leaving the fleet never re-slackens siblings (extra
        renewals are cheap; a missed adoption window is not)."""
        try:
            conf = self.read_fleet_lease_conf()
        except STORE_OUTAGE_ERRORS:
            return  # next renewal retries
        self._fleet_lease_conf = conf
        if conf is not None:
            self.lease_renew_period = min(
                self.lease_renew_period, conf[0] / 3.0
            )

    def publish_lease_timeout(self, lease_timeout: float) -> None:
        """Announce this rescanner's adoption horizon fleet-wide. Each
        distinct value gets its own write-once field ("t:<value>" ->
        publication wall time, setnx): concurrent publishers of different
        values both land and readers take the min, so the fleet converges
        on the tightest horizon under any interleaving (a lost-update race
        on a single shared field could leave the LARGER value standing).
        The setnx also pins each value's FIRST publication time, which
        read_fleet_lease_conf exposes for the adoption grace window."""
        field = f"t:{float(lease_timeout)!r}"
        self.store.setnx_field(LEASE_CONF_KEY, field, repr(time.time()))
        self.refresh_lease_renew_period()

    def fetch_reclaim(self, task_id: str, retries: int) -> PendingTask | None:
        """Rebuild a PendingTask for a task reclaimed from a dead worker.

        hmget over exactly the rebuild fields, not hgetall: the hash may
        already hold a huge result blob (the zombie wrote it before the
        purge) that a mass-reclaim tick must not drag across the store
        wire. Returns None when the payloads vanished (store flushed) —
        nothing to re-dispatch."""
        vals = self.store.hmget(task_id, RECLAIM_FIELDS)
        fields = {f: v for f, v in zip(RECLAIM_FIELDS, vals) if v is not None}
        if not _has_payloads(fields):
            return None
        # a reclaimed graph parent must keep promoting its children when
        # its (re-run) result lands
        self.note_graph_parent(task_id, fields)
        return PendingTask.from_fields(task_id, fields, retries=retries)

    def task_is_finished(self, task_id: str) -> bool:
        """Re-dispatch guard: True when a reclaimed task must NOT be sent
        out again — its record is terminal, or GONE. Absent counts as
        finished: the only way a tracked task's record disappears is the
        client consuming its result and deleting it (DELETE /task), and
        re-dispatching then would re-run the side effects and resurrect the
        deleted record as a partial status-only hash (the same hole
        finish_task's first_wins guard closes on the write side)."""
        # unknown=True: absent counts as finished (above), and a foreign
        # status string must not crash the serve loop — not re-dispatching
        # is the safe side (an unparseable record isn't ours to run)
        return TaskStatus.terminal_str(
            self.store.get_status(task_id), unknown=True
        )

    def render_metrics(self) -> str:
        """This dispatcher's Prometheus exposition: its private registry
        (gauges refreshed by the collector) concatenated with the
        process-global one (store round trips, worker-pool counters)."""
        return obs_metrics.render([self.metrics, REGISTRY])

    def readiness(self) -> tuple[bool, str]:
        """(ready, reason) for the /readyz probe: a dispatcher is ready
        when its store is reachable AND writable — a replica or fenced
        store endpoint serves reads but every dispatch write would fail,
        so orchestration must not route to (or keep) this process as if
        it were serving. Liveness (/healthz) stays unconditional: a
        degraded dispatcher must not be killed, it is parking work.

        Blocking (one INFO round trip on HA backends) — called from the
        stats thread, never the serve loop; backends without the
        introspection (MemoryStore, plain Redis) skip the role check."""
        if self._store_down:
            return False, "store_unreachable"
        info_fn = getattr(self.store, "info", None)
        if info_fn is not None:
            try:
                role = info_fn().get("role")
            except Exception:
                return False, "store_unreachable"
            if role in ("replica", "fenced"):
                return False, f"store_role_{role}"
        return True, "ok"

    def serve_stats(self, port: int, host: str = "127.0.0.1"):
        """Serve the observability surface over HTTP from a daemon thread:

        - ``GET /stats`` — the legacy JSON snapshot (``stats()``);
        - ``GET /metrics`` — Prometheus text exposition (private registry
          + process-global registry), the scrape path;
        - ``GET /trace/<task_id>`` — that task's lifecycle timeline (open
          or recently completed), 404 when unknown;
        - ``GET /trace`` — the bounded rings: recent completions and the
          slowest tasks seen;
        - ``GET /slo`` — per-objective multi-window burn rates
          (obs/slo.py) over the stage histograms;
        - ``GET /flightrec`` — the flight-recorder ring (obs/flightrec.py)
          as JSON; ``?since=N`` polls incrementally from a prior cursor,
          ``?limit=K`` keeps only the newest K matching events;
        - ``GET /healthz`` — liveness (always 200 while serving);
        - ``GET /readyz`` — readiness (503 while the store is down or
          this dispatcher is pointed at a non-writable replica/fenced
          endpoint), for orchestration probes.

        Returns the server (port 0 picks a free one —
        ``server.server_address[1]``); ``stop()`` shuts it down and closes
        the listening socket."""
        import json
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        dispatcher = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self) -> None:  # noqa: N802 (stdlib naming)
                ctype = "application/json"
                if self.path == "/healthz":
                    body = b'{"ok": true}'
                elif self.path == "/readyz":
                    ready, reason = dispatcher.readiness()
                    body = json.dumps(
                        {"ready": ready, "reason": reason}
                    ).encode()
                    if not ready:
                        self.send_response(503)
                        self.send_header("Content-Type", ctype)
                        self.send_header("Content-Length", str(len(body)))
                        self.end_headers()
                        self.wfile.write(body)
                        return
                elif self.path == "/slo":
                    body = json.dumps(dispatcher.slo.snapshot()).encode()
                elif self.path == "/flightrec" or self.path.startswith(
                    "/flightrec?"
                ):
                    from urllib.parse import parse_qs, urlsplit

                    q = parse_qs(urlsplit(self.path).query)
                    try:
                        since = int(q.get("since", ["0"])[0])
                        limit = int(q.get("limit", ["0"])[0])
                    except ValueError:
                        self.send_error(400)
                        return
                    body = json.dumps(
                        dispatcher.flightrec.snapshot(
                            since=since, limit=limit
                        ),
                        default=str,
                    ).encode()
                elif self.path == "/stats":
                    body = json.dumps(dispatcher.stats()).encode()
                elif self.path == "/metrics":
                    body = dispatcher.render_metrics().encode()
                    ctype = obs_metrics.CONTENT_TYPE
                elif self.path == "/trace":
                    body = json.dumps(
                        {
                            **dispatcher.traces.stats(),
                            "recent": dispatcher.traces.recent(),
                            "slowest": dispatcher.traces.slowest(),
                        }
                    ).encode()
                elif self.path.startswith("/trace/"):
                    timeline = dispatcher.traces.timeline(
                        self.path[len("/trace/"):]
                    )
                    if timeline is None:
                        self.send_error(404)
                        return
                    body = json.dumps(timeline).encode()
                else:
                    self.send_error(404)
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args: object) -> None:
                pass  # stats polls must not spam the dispatcher log

        server = ThreadingHTTPServer((host, port), Handler)
        threading.Thread(
            target=server.serve_forever, name="dispatcher-stats", daemon=True
        ).start()
        self.log.info("stats endpoint on http://%s:%d/stats", host, server.server_address[1])
        self._stats_server = server
        return server

    # -- lifecycle ---------------------------------------------------------
    def stop(self) -> None:
        self._stop_event.set()
        if self._stats_server is not None:
            self._stats_server.shutdown()
            self._stats_server.server_close()  # release the bound port now
            self._stats_server = None

    @property
    def stopping(self) -> bool:
        return self._stop_event.is_set()

    def close(self) -> None:
        self.stop()
        self.spans.flush()  # best-effort final span flush (swallows outages)
        self.subscriber.close()
        self.store.close()
