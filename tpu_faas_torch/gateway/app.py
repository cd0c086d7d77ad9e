"""aiohttp REST gateway.

API surface (SURVEY §0.1, recovered from reference client usage
test_client.py:98-126, test_suit.py:39-91):

- ``POST /register_function``  {"name": str, "payload": ser_fn}
    -> {"function_id": str}
- ``POST /execute_function``   {"function_id": str, "payload": ser_params}
    -> {"task_id": str}      (404 if function_id unknown)
    optional scheduling hints: "priority" (int, higher admitted first under
    overload — ENFORCED by the admission controller below), "cost"
    (float > 0, estimated run-cost), "timeout" (float > 0, execution
    budget), "deadline" (float > 0, submit-TTL in seconds: a task still
    QUEUED this long after submit is shed to the terminal EXPIRED status
    instead of dispatched); /execute_batch takes parallel "priorities"/
    "costs"/"timeouts"/"deadlines" lists (None entries = no hint).
    Optional "idempotency_key" (non-empty str): the same (function, key)
    always maps to the same task — a duplicate submit returns {"task_id",
    "deduplicated": true} and writes nothing, so submits become safely
    retryable. The dedup window is the record's lifetime (a swept/DELETEd
    record re-runs).

Overload behavior (tpu_faas/admission): submits pass an admission
controller BEFORE any store work — per-client token-bucket quotas (keyed
on the ``X-Client-Id`` header, off unless configured), a bound on tasks in
the system (from the dispatcher-published saturation signal plus this
gateway's own accounting), and a priority-aware brownout band that sheds
the lowest-priority submits first. Rejects are 429 with a ``Retry-After``
header computed from the fleet's measured drain rate. A store circuit
breaker fast-fails EVERY store-touching endpoint with 503 +
``Retry-After`` while the store is down, instead of hanging each request
on a connect timeout.
- ``GET /status/{task_id}``    -> {"task_id", "status"}
- ``GET /result/{task_id}``    -> {"task_id", "status", "result"}
    ``?wait=N`` long-polls (capped); parked requests are woken by the
    store's terminal announce, and express-lane announces (dispatcher
    ``--express``) carry the result inline so the woken reply skips the
    store re-read entirely.
- ``POST /results/wait``       {"task_ids": [...], "wait": N} — the
    multiplexed long-poll: one parked request watching many tasks, reply
    ``{"results", "pending", "unknown"}`` as soon as anything is terminal.
- ``GET /events?task_ids=...`` — SSE stream over the same waiter plane:
    one ``result`` event per terminal task as it lands, closed by ``done``.
- ``POST /execute_graph``      {"nodes": [{"function_id", "payload",
    "depends_on": [refs], ...hints}]} -> {"task_ids", "graph"} — DAG
    submission (tpu_faas/graph): acyclicity + size cap proven before any
    write, admission charged for the whole graph, dependent nodes created
    WAITING and promoted/poisoned by the store's dependency plane (see
    execute_graph below).

Beyond the reference surface: ``POST /cancel/{task_id}`` (queued-only
best-effort cancel: QUEUED -> CANCELLED terminal, RUNNING refused with 409 —
see cancel_task below), ``DELETE /task/{task_id}`` (drop a terminal task's
record), ``GET /healthz`` (liveness), ``GET /readyz`` (readiness: 503 while
the breaker is open or the store endpoint is a replica/fenced — route
traffic on this one, restart on /healthz), ``GET /metrics`` (Prometheus
text exposition — request counts + latency histograms per route, submission
counters, store reachability, e2e latency + SLO burn rates; tpu_faas/obs),
``GET /stats`` (the same numbers as a JSON snapshot, with exact
recent-window percentiles from the tracer ring), ``GET /slo``
(per-objective burn rates as JSON), and — with ``--trace`` — submits carry
distributed trace context and ``GET /trace/{task_id}`` assembles the full
cross-process timeline from the store's span plane (obs/tracectx).

Store-side contract on execute (reference old/client_debug.py:40-45): write the
full task hash (status QUEUED, fn_payload, param_payload, result "None") then
PUBLISH the task_id on the announce channel.

Registered functions are stored under ``function:<id>`` hashes so any number of
gateway replicas share one registry through the store. Store calls are blocking
(RESP over local TCP); they run on the event loop's default executor so slow
store I/O never stalls the accept loop.
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
import functools
import hashlib
import math
import threading
import time
import uuid
from dataclasses import dataclass, field

from aiohttp import web

from tpu_faas_torch.admission import (
    AdmissionController,
    CircuitBreaker,
    StoreUnavailable,
    read_fleet_health,
)
from tpu_faas_torch.admission.breaker import OUTAGE_ERRORS
from tpu_faas_torch.admission.controller import AdmissionConfig
from tpu_faas_torch.core.payload import payload_digest
from tpu_faas_torch.core.task import (
    FIELD_CHILDREN,
    FIELD_COST,
    FIELD_DEADLINE,
    FIELD_DEPS,
    FIELD_FINISHED_AT,
    FIELD_FN_DIGEST,
    FIELD_PARAMS,
    FIELD_PENDING_DEPS,
    FIELD_PRIORITY,
    FIELD_RESULT,
    FIELD_RESULT_DIGEST,
    FIELD_SLO_CLASS,
    FIELD_SPECULATIVE,
    FIELD_STATUS,
    FIELD_SUBMITTED_AT,
    FIELD_TENANT,
    FIELD_TIMEOUT,
    FIELD_TRACE_ID,
    FIELD_TRACE_PARENT,
    TaskStatus,
    new_function_id,
    new_task_id,
)
from tpu_faas_torch.tenancy import valid_tenant
from tpu_faas_torch.graph import GraphValidationError, validate_graph
from tpu_faas_torch.obs import REGISTRY, MetricsRegistry, SLOTracker, SpanSink
from tpu_faas_torch.obs import metrics as obs_metrics
from tpu_faas_torch.obs.attribution import (
    SLO_CLASSES,
    AttributionBook,
    class_of,
    class_of_fields,
    latency_buckets,
    normalize_class,
)
from tpu_faas_torch.obs.flightrec import FlightRecorder
from tpu_faas_torch.obs.metrics import LATENCY_BUCKETS
from tpu_faas_torch.obs.slo import DEFAULT_GATEWAY_OBJECTIVES, objectives_from_env
from tpu_faas_torch.obs.tracectx import (
    TRACE_PREFIX,
    assemble_timeline,
    new_trace_id,
    sweep_stale_traces,
    valid_trace_id,
)
from tpu_faas_torch.store.base import (
    BLOB_AT_FIELD,
    BLOB_PREFIX,
    BLOBREQ_ANNOUNCE_PREFIX,
    BLOBREQ_AT_FIELD,
    BLOBREQ_PREFIX,
    LIVE_INDEX_KEY,
    RESULTS_CHANNEL,
    TASKS_CHANNEL,
    TaskStore,
    blobreq_key,
    decode_result_announce,
)
from tpu_faas_torch.store.launch import make_store
from tpu_faas_torch.utils.logging import TickTracer, get_logger

log = get_logger("gateway")

_FUNCTION_PREFIX = "function:"
#: Field on a function-registry hash holding the payload's content digest
#: (payload plane); absent on records written by a pre-plane gateway.
_FN_DIGEST_FIELD = "payload_digest"
#: Content-digest -> function_id index hashes (one per digest, setnx'd):
#: lets a repeated register_function of the SAME bytes dedup to the first
#: function_id instead of writing the body again.
_FN_INDEX_PREFIX = "function_digest:"
#: Namespace for idempotency-key -> task-id derivation (uuid5). Any fixed
#: UUID works; it just keys the hash.
_IDEMPOTENCY_NS = uuid.UUID("2f1aa4f6-0d8e-4cf1-9e65-6d54e6f1c0aa")
#: Hash field atomically claimed by the FIRST submit for an idempotent task
#: id; losers dedup instead of writing (see execute_function). The claim
#: VALUE is "<sha256(param_payload)>:<unix_ts>": carrying the payload hash
#: makes key-reuse-with-different-payload detectable atomically at claim
#: time (no dependence on the winner's later record write), and the
#: timestamp lets the TTL sweeper age out claim-only hashes abandoned by a
#: gateway that died between claim and create.
_IDEM_CLAIM_FIELD = "idem_claim"

#: How long a dedup loser waits for the claim winner's record write to land
#: before adopting the claim (creating the record itself). Covers both the
#: in-flight winner (record appears within ms) and the dead winner (record
#: never appears; the retry must not be stranded against a task that does
#: not exist).
_IDEM_ADOPT_WAIT_S = 1.5


def _idem_claim_value(param_payload: str, now: float | None = None) -> str:
    h = hashlib.sha256(param_payload.encode()).hexdigest()
    ts = int(now if now is not None else time.time())
    return f"{h}:{ts}"


def _idem_claim_hash(claim_value: str) -> str:
    return claim_value.split(":", 1)[0]


def _idem_claim_age(claim_value: str, now: float) -> float | None:
    """Seconds since the claim was written, or None if unparseable (foreign
    producer wrote the field) — unparseable claims are never swept."""
    parts = claim_value.split(":", 1)
    if len(parts) != 2:
        return None
    try:
        return now - float(parts[1])
    except ValueError:
        return None


def _json_error(status: int, message: str) -> web.Response:
    return web.json_response({"error": message}, status=status)


async def _run_blocking(fn, *args):
    loop = asyncio.get_running_loop()
    return await loop.run_in_executor(None, functools.partial(fn, *args))


class _Waiter:
    """One parked wait — single-id long-poll, multiplexed /results/wait,
    or an SSE stream: a PRIVATE wake event plus the express lane's inline
    forward slots, (status, result) payloads the pump decoded off
    RESULTS_CHANNEL announces while this wait was parked. Serving from the
    slot is what removes the store re-read from the woken delivery path;
    the slot is only ever filled from an announce that FOLLOWED the
    authoritative store write on the same pipelined round, so it can never
    disagree with a re-read. Written exclusively on the app loop
    (call_soon_threadsafe) and read by the owning handler on the same
    loop — no lock. Per-waiter (not a global cache) on purpose: a payload
    is only delivered to waits parked when it was announced, so a stale
    forward can never answer a LATER wait for a resubmitted incarnation
    of the same deterministic task id."""

    __slots__ = ("event", "inline")

    def __init__(self) -> None:
        self.event = asyncio.Event()
        self.inline: dict[str, tuple[str, str]] = {}


class _ResultWaiters:
    """Wakes parked /result long-polls when the store announces a terminal
    write on RESULTS_CHANNEL, forwarding the express lane's inline
    payloads to the parked handlers (see _Waiter).

    A pump thread (its own store subscription — a dedicated connection, so
    it never interleaves with handler traffic) drains the channel and sets
    the matching task's waiter events via the app loop. Each parked handler
    owns a PRIVATE _Waiter (one fire sets them all): a shared event
    would let one handler's clear() erase a wake another handler hadn't
    consumed yet. Handlers drop their waiter on exit, fired or not, so
    abandoned waits can't leak entries. The channel is fire-and-forget:
    handlers keep a coarse fallback re-read, and a pump that loses its
    subscription (store restart) just resubscribes."""

    def __init__(self, store: TaskStore):
        self.store = store
        self._waiters: dict[str, list[_Waiter]] = {}
        self._loop: asyncio.AbstractEventLoop | None = None
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def start(self, loop: asyncio.AbstractEventLoop) -> None:
        self._loop = loop
        self._thread = threading.Thread(
            target=self._pump, name="gateway-result-wakeups", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        """Blocking (joins the pump — which may itself sit in a connect
        timeout against a dead store); call off-loop."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def acquire(self, task_id: str) -> _Waiter:
        w = _Waiter()
        self._waiters.setdefault(task_id, []).append(w)
        return w

    def acquire_many(self, task_ids) -> _Waiter:
        """ONE waiter registered under every id — any of their announces
        wakes the (multiplexed) wait, and each id's inline forward lands
        in its own slot."""
        w = _Waiter()
        for task_id in task_ids:
            self._waiters.setdefault(task_id, []).append(w)
        return w

    def release(self, task_id: str, waiter: _Waiter) -> None:
        waiters = self._waiters.get(task_id)
        if waiters is None:
            return
        try:
            waiters.remove(waiter)
        except ValueError:
            pass
        if not waiters:
            self._waiters.pop(task_id, None)

    def release_many(self, task_ids, waiter: _Waiter) -> None:
        for task_id in task_ids:
            self.release(task_id, waiter)

    def _fire(self, payload: str) -> None:
        task_id, status, result = decode_result_announce(payload)
        for w in self._waiters.get(task_id, ()):
            # digest-form announces (result-blob plane, "!r2:") decode
            # with status but NO result — wake only, so the delivery path
            # re-reads the record and materializes the body; forwarding
            # ("status", "") here would serve an empty result as real
            if status is not None and result is not None:
                w.inline[task_id] = (status, result)
            w.event.set()

    def fire_all(self) -> None:
        """Shutdown: wake every parked poll NOW (each re-checks ctx.stopping
        and replies) instead of letting them ride out the fallback timeout."""
        for waiters in self._waiters.values():
            for w in waiters:
                w.event.set()

    def _pump(self) -> None:
        down = False  # log once per outage, not once per retry
        while not self._stop.is_set():
            try:
                with self.store.subscribe(RESULTS_CHANNEL) as sub:
                    if down:
                        down = False
                        log.info("result-wakeup subscription restored")
                    while not self._stop.is_set():
                        msg = sub.get_message(timeout=0.5)
                        if msg is not None and self._loop is not None:
                            self._loop.call_soon_threadsafe(self._fire, msg)
            except Exception as exc:
                if self._stop.is_set():
                    return
                if not down:
                    down = True
                    log.warning(
                        "result-wakeup subscription lost (%s); parked polls "
                        "fall back to store re-reads until it resubscribes",
                        exc,
                    )
                self._stop.wait(1.0)


#: default ceiling for the parked-wait safety re-read cadence (seconds);
#: GatewayContext.wait_safety_poll_s (--wait-safety-poll-s) overrides it
#: per process — latency benches raise it to attribute the poll floor
_WAIT_POLL_MAX_S_DEFAULT = 2.0


@dataclass
class GatewayContext:
    store: TaskStore
    channel: str = TASKS_CHANNEL
    #: wake-on-publish for parked long-polls; started on app startup
    waiters: "_ResultWaiters | None" = None
    #: set on app shutdown so parked long-polls reply immediately instead of
    #: holding the server (and its stop()) for up to _MAX_WAIT_S
    stopping: asyncio.Event = field(default_factory=asyncio.Event)
    #: request/latency ring by endpoint (exact recent percentiles for the
    #: JSON /stats snapshot); built in __post_init__ so it mirrors into the
    #: registry's latency histogram — one record() feeds both surfaces
    tracer: "TickTracer | None" = None
    started_at: float = field(default_factory=time.time)
    n_functions: int = 0
    n_tasks: int = 0
    n_cancelled: int = 0
    #: monotonic per-route request totals — the tracer's ring is bounded
    #: (correct for latency percentiles, WRONG as a counter once saturated)
    route_counts: dict = field(default_factory=dict)
    #: PRIVATE metrics registry (tpu_faas/obs): app instances in one test
    #: process must not share series; /metrics renders this + the
    #: process-global registry
    metrics: MetricsRegistry = field(default_factory=MetricsRegistry)
    #: safety-poll ceiling (seconds) for parked waits whose waiter plane
    #: is armed: the announce is the wake path and the periodic store
    #: re-read only insures against announce loss, so latency benches can
    #: RAISE this to attribute (and tune away) the poll floor — see
    #: tpu_faas_gateway_safety_poll_served_total
    wait_safety_poll_s: float = _WAIT_POLL_MAX_S_DEFAULT
    #: admission controller (tpu_faas/admission): every submit passes it
    #: before any store work. None disables admission entirely (tests of
    #: the raw surface); the default fails open until a dispatcher
    #: publishes the saturation signal or a bound is configured
    admission: "AdmissionController | None" = None
    #: store circuit breaker: store_call routes every handler-side store
    #: op through it; None disables fast-fail (calls hit the store raw)
    breaker: "CircuitBreaker | None" = None
    #: content-addressed payload plane: when True, task records carry
    #: FIELD_FN_DIGEST (body written ONCE under blob:<digest> at register
    #: time) instead of an inline function body per task. OFF by default —
    #: a reference-style dispatcher reading raw ``fn_payload`` hashes
    #: (tests/test_reference_worker_interop.py's stretch leg) needs the
    #: inline contract, and the store cannot negotiate with consumers that
    #: advertise nothing; the operator opts in per deployment
    #: (``--payload-plane``) once every dispatcher on the store is
    #: payload-plane-aware.
    payload_plane: bool = False
    #: distributed tracing (tpu_faas/obs/tracectx.py): when True, every
    #: submit carries a trace id (client-supplied, validated — or minted
    #: here for legacy clients), the gateway emits its own span records
    #: (admit, create, observe) into the store's trace: namespace, and
    #: ``/trace/<task_id>`` assembles the full cross-process timeline.
    #: OFF by default: single-process setups and reference-era fleets run
    #: byte-identical with it off (``--trace`` opts in). The SLO layer
    #: below does NOT depend on it — e2e latency is measured from the
    #: record's own submit/finish stamps either way.
    trace: bool = False

    def __post_init__(self) -> None:
        #: composed-SLO attribution plane (obs/attribution.py): the
        #: tpu_faas_task_attrib_total family when TPU_FAAS_OBS_CLASS is
        #: on, a no-op otherwise — also the flag the e2e histogram's
        #: class label keys off
        self.attrib = AttributionBook(self.metrics)
        #: fleet flight recorder (obs/flightrec.py): bounded in-process
        #: event ring behind GET /flightrec — pure memory, no exposition
        #: or wire change, so it is unconditionally on
        self.flightrec = FlightRecorder()
        self.m_requests = self.metrics.counter(
            "tpu_faas_gateway_requests_total",
            "HTTP requests served, by method+route (long-polls separated)",
            ("route",),
        )
        self.m_latency = self.metrics.histogram(
            "tpu_faas_gateway_request_latency_seconds",
            "HTTP serving latency by method+route (long-poll wait time "
            "kept in its own route bucket)",
            ("route",),
        )
        self.m_functions = self.metrics.counter(
            "tpu_faas_gateway_functions_registered_total",
            "Functions registered through this gateway",
        )
        self.m_tasks = self.metrics.counter(
            "tpu_faas_gateway_tasks_submitted_total",
            "Task records created through this gateway (dedups excluded)",
        )
        self.m_cancel_calls = self.metrics.counter(
            "tpu_faas_gateway_cancel_calls_total",
            "Cancel calls that reported cancelled=true (idempotent "
            "repeats counted — see /stats cancel_calls)",
        )
        self.m_graphs = self.metrics.counter(
            "tpu_faas_gateway_graphs_total",
            "Graph submissions accepted (POST /execute_graph)",
        )
        self.m_graph_nodes = self.metrics.counter(
            "tpu_faas_gateway_graph_nodes_total",
            "Graph nodes created, by kind: root (QUEUED, announced "
            "dispatchable) or waiting (WAITING behind depends_on, promoted "
            "by the store's dependency plane)",
            ("kind",),
        )
        for kind in ("root", "waiting"):
            self.m_graph_nodes.labels(kind=kind)
        self.m_waiting_repaired = self.metrics.counter(
            "tpu_faas_gateway_waiting_repaired_total",
            "Orphaned WAITING nodes the result-TTL sweeper resolved "
            "(promotion/poison re-derived from the parents' terminal "
            "statuses after a resolver crash)",
        )
        self.m_store_up = self.metrics.gauge(
            "tpu_faas_gateway_store_up",
            "1 when the store answered the last scrape-time PING, else 0",
        )
        self.m_uptime = self.metrics.gauge(
            "tpu_faas_gateway_uptime_seconds", "Seconds since app start"
        )
        self.m_admitted = self.metrics.counter(
            "tpu_faas_gateway_admitted_total",
            "Submits admitted by the admission controller (tasks, not "
            "HTTP calls: a batch of N counts N)",
        )
        self.m_rejected = self.metrics.counter(
            "tpu_faas_gateway_rejected_total",
            "Rejects by reason, in TASKS for the admission reasons "
            "(quota | quota_exceeds_burst | brownout | saturated: a "
            "batch of N counts N, same unit as admitted_total) and in "
            "CALLS for store_unavailable (503 on any store-touching "
            "endpoint, where no task count exists)",
            ("reason",),
        )
        for reason in (
            "quota",
            "quota_exceeds_burst",
            "brownout",
            "saturated",
            "store_unavailable",
        ):
            self.m_rejected.labels(reason=reason)
        self.m_saturation = self.metrics.gauge(
            "tpu_faas_gateway_saturation",
            "In-system task estimate over the admission bound at the last "
            "admission decision (>= 1.0 means full stop)",
        )
        self.m_breaker_open = self.metrics.gauge(
            "tpu_faas_gateway_store_breaker_open",
            "1 while the store circuit breaker is open or half-open "
            "(store calls fast-fail 503), else 0",
        )
        self.m_blob_written = self.metrics.counter(
            "tpu_faas_gateway_blob_bytes_written_total",
            "Payload bytes written into the blob namespace (first "
            "registration of each distinct function body)",
        )
        self.m_blob_saved = self.metrics.counter(
            "tpu_faas_gateway_blob_bytes_saved_total",
            "Payload bytes NOT written thanks to content addressing: "
            "inline bodies replaced by digests on task creates, plus "
            "re-registrations of an already-stored body",
        )
        self.m_store_role = self.metrics.gauge(
            "tpu_faas_gateway_store_role",
            "Replication role of the store endpoint this gateway talks "
            "to, at the last scrape: 1 primary, 0 replica, -1 fenced "
            "stale primary, -2 unknown (no HA introspection)",
        )
        self.m_repl_lag = self.metrics.gauge(
            "tpu_faas_store_replication_lag_commands",
            "Replication offset delta between the active store primary "
            "and its slowest attached replica (mutating commands not "
            "yet acknowledged), at the last scrape; 0 with no replica",
        )
        self.m_e2e = self.metrics.histogram(
            "tpu_faas_task_e2e_seconds",
            "End-to-end task latency as THIS gateway can measure it from "
            "the record's own stamps, observed once per task at its first "
            "terminal /result delivery: submit_to_finish (gateway submit "
            "stamp -> terminal write stamp) and submit_to_observe (submit "
            "stamp -> the client actually receiving the result — the "
            "poll/transport gap included); 'terminal' is the record's "
            "closing status, so shed (EXPIRED) and cancelled populations "
            "stay out of the completed-latency distribution the SLO "
            "layer judges",
            ("phase", "terminal", "class")
            if self.attrib.enabled
            else ("phase", "terminal"),
            buckets=latency_buckets(LATENCY_BUCKETS),
        )
        for phase in ("submit_to_finish", "submit_to_observe"):
            if self.attrib.enabled:
                for cls in SLO_CLASSES:
                    self.m_e2e.labels(phase, "COMPLETED", cls)
            else:
                self.m_e2e.labels(phase=phase, terminal="COMPLETED")
        self.m_result_served = self.metrics.counter(
            "tpu_faas_gateway_result_served_total",
            "Terminal result deliveries to clients (/result, "
            "/results/wait, /events) by source: inline = replied from the "
            "express lane's forwarded announce payload (no store re-read "
            "on the delivery path), store = replied from a store read "
            "(immediate-reply polls, oversized/disabled inline, safety-"
            "poll fallback). inline/(inline+store) is the express lane's "
            "hit rate",
            ("source",),
        )
        for source in ("inline", "store"):
            self.m_result_served.labels(source=source)
        self.m_safety_poll = self.metrics.counter(
            "tpu_faas_gateway_safety_poll_served_total",
            "Parked waits (waiter plane armed) whose terminal reply was "
            "found by the periodic SAFETY store re-read rather than an "
            "announce wake — each one ate up to wait_safety_poll_s "
            "(--wait-safety-poll-s) of avoidable latency. Nonzero under "
            "steady traffic means announce loss (bus gap, subscription "
            "reconnect) is on the latency path; see OPERATIONS.md triage",
        )
        self.m_shard_routed = self.metrics.counter(
            "tpu_faas_gateway_shard_routed_total",
            "Task-keyed reads (/status, /result, /trace) routed to a "
            "store shard by the consistent-hash ring, by shard — the "
            "stateless-gateway routing plane's traffic attribution. No "
            "children on single-store stacks",
            ("shard",),
        )
        #: bounded first-delivery dedup for the e2e histogram (repeat
        #: polls of a terminal record must not re-observe)
        self._observed: dict[str, bool] = {}
        #: in-flight fire-and-forget observation tasks (strong refs so
        #: the event loop can't GC them mid-fetch)
        self._observe_tasks: set = set()
        #: latency-SLO layer over the e2e histogram (obs/slo.py):
        #: tpu_faas_slo_* gauges + the /slo endpoint
        self.slo = SLOTracker(
            self.metrics,
            objectives_from_env(DEFAULT_GATEWAY_OBJECTIVES),
            self._e2e_snapshot,
        )
        #: span plane writer (None with tracing off); flushed by a
        #: background task so submit latency never pays the store trip
        self.span_sink = (
            SpanSink(store=self.store, process="gateway", registry=self.metrics)
            if self.trace
            else None
        )
        self.metrics.register_collector(self._collect)
        if self.tracer is None:
            self.tracer = TickTracer(mirror=self.m_latency)

    def _e2e_snapshot(self, phase: str, cls: str | None = None):
        """SLO data source: (bucket uppers, counts) of one e2e phase —
        COMPLETED outcomes only, matching the dispatcher's stage_snapshot
        policy: a burst of deadline-shed EXPIRED tasks is intended
        overload behavior and must not burn the latency error budget,
        and quick cancels must not dilute real violations.

        ``cls`` restricts to one SLO class; None against a class-blind
        histogram (label off) — sum_counts matches positionally, so a
        three-element match over two-label children would silently match
        every class instead of one."""
        if cls is not None:
            if not self.attrib.enabled:
                return None
            return self.m_e2e.sum_counts((phase, "COMPLETED", cls))
        return self.m_e2e.sum_counts((phase, "COMPLETED"))

    _OBSERVED_CAP = 65536

    def note_result_observed(
        self,
        task_id: str,
        fields: dict,
        observed_at: float | None = None,
        source: str | None = None,
    ) -> None:
        """First terminal /result delivery for a task: observe the e2e
        latency phases and emit the ``observe`` span — the poll-gap
        segment no dispatcher-local timeline can see. Repeat polls are
        deduped here (histogram) and by the span store's first-write-wins
        (spans). Non-blocking: spans go to the sink buffer.
        ``observed_at`` is the reply-time stamp the caller took BEFORE
        any telemetry store fetch — the observe phase must measure the
        client's wait, not the measurement's own cost.
        ``source`` is how the FIRST delivery was served ("inline" from
        the express lane's forwarded payload, "store" from a store read)
        — folded into the attribution counters so the express plane's
        percentile contribution is scrapeable per class."""
        first = task_id not in self._observed
        if first:
            self._observed[task_id] = True
            while len(self._observed) > self._OBSERVED_CAP:
                self._observed.pop(next(iter(self._observed)))
        now = observed_at if observed_at is not None else time.time()
        cls = class_of_fields(fields) if self.attrib.enabled else None
        submitted = finished = None
        try:
            submitted = float(fields[FIELD_SUBMITTED_AT])
        except (KeyError, ValueError):
            pass
        try:
            finished = float(fields[FIELD_FINISHED_AT])
        except (KeyError, ValueError):
            pass
        if first and cls is not None and source in ("inline", "store"):
            self.attrib.note("express", source, cls)
        if first:
            # one ring event per task at its terminal delivery — the
            # gateway-side join point for a post-incident /flightrec
            # walk (joins to /trace via task_id)
            self.flightrec.emit(
                "result_delivery",
                task_id=task_id,
                source=source or "store",
                status=str(fields.get(FIELD_STATUS) or "unknown"),
                **({"cls": cls} if cls is not None else {}),
            )
        if first and submitted is not None:
            terminal = str(fields.get(FIELD_STATUS) or "unknown")
            if cls is not None:
                if finished is not None:
                    self.m_e2e.labels(
                        "submit_to_finish", terminal, cls
                    ).observe(max(0.0, finished - submitted))
                self.m_e2e.labels("submit_to_observe", terminal, cls).observe(
                    max(0.0, now - submitted)
                )
            else:
                if finished is not None:
                    self.m_e2e.labels(
                        phase="submit_to_finish", terminal=terminal
                    ).observe(max(0.0, finished - submitted))
                self.m_e2e.labels(
                    phase="submit_to_observe", terminal=terminal
                ).observe(max(0.0, now - submitted))
        trace_id = fields.get(FIELD_TRACE_ID)
        if (
            first
            and self.span_sink is not None
            and trace_id
            and finished is not None
        ):
            # first-delivery-gated here AND first-write-wins in the store:
            # a racing duplicate emit would only tick the duplicate
            # counter for a non-event
            self.span_sink.emit(
                trace_id,
                "observe",
                finished,
                now,
                task_id=task_id,
                outcome=fields.get(FIELD_STATUS),
            )

    def _collect(self) -> None:
        self.m_uptime.set(time.time() - self.started_at)
        if self.admission is not None:
            self.m_saturation.set(self.admission.last_load)
        if self.breaker is not None:
            self.m_breaker_open.set(1.0 if self.breaker.is_open else 0.0)

    def note_shard_route(self, task_id: str) -> None:
        """Count a task-keyed read against the shard the ring routes it
        to. No-op (and no series) on single-store stacks; the ring lookup
        is pure local hashing — no store round trip rides a request."""
        if getattr(self.store, "shard_count", 0) < 2:
            return
        shard_of = getattr(self.store, "shard_of", None)
        if shard_of is not None:
            self.m_shard_routed.labels(shard=str(shard_of(task_id))).inc()

    def _live_in_system(self) -> int:
        """The store's live-task index count: every create writes
        LIVE_INDEX_KEY and every terminal write drops the entry, so its
        size IS the fleet-wide in-system count — including tasks still
        buffered in announce subscriptions (invisible to dispatcher
        snapshots) and foreign producers' tasks. Read whole once per
        admission TTL; the transfer is O(live tasks), which the admission
        bound itself keeps proportionate. Blocking: call via store_call."""
        return len(self.store.hgetall(LIVE_INDEX_KEY))

    async def store_call(self, fn, *args):
        """Run a blocking store op on the executor, behind the circuit
        breaker: an open breaker raises StoreUnavailable WITHOUT touching
        a socket (the <100 ms fast-fail), outage-family failures trip it,
        successes close it. The middleware maps StoreUnavailable to
        503 + Retry-After."""
        breaker = self.breaker
        if breaker is None:
            return await _run_blocking(fn, *args)
        if not breaker.allow():
            raise StoreUnavailable(breaker.retry_after())
        try:
            result = await _run_blocking(fn, *args)
        except OUTAGE_ERRORS as exc:
            breaker.record_failure()
            raise StoreUnavailable(breaker.retry_after()) from exc
        except BaseException:
            # no store verdict (cancelled request, non-outage error):
            # release a held half-open probe slot or the breaker wedges
            # open forever — one aborted probe must not outlive the call
            breaker.record_aborted()
            raise
        breaker.record_success()
        return result

    async def admit(self, request: web.Request, n: int, priority: int):
        """Admission decision for ``n`` tasks at ``priority`` (batches
        pass their minimum). Refreshes the fleet-health snapshot through
        the breaker when stale — at most one store read per TTL, and a
        dead store degrades to the cached snapshot instead of blocking
        the decision. Returns None when admission is disabled."""
        adm = self.admission
        if adm is None:
            return None
        if adm.needs_refresh():
            adm.begin_refresh()
            try:
                health = await self.store_call(read_fleet_health, self.store)
                live = await self.store_call(self._live_in_system)
            except StoreUnavailable:
                # decide on the stale snapshot; the submit's own store
                # write will surface the 503 if the store is truly dark
                adm.refresh_failed()
            except BaseException:
                # BaseException, not Exception: a client disconnect
                # cancels this handler (asyncio.CancelledError), and a
                # leaked _refreshing=True would block every future
                # refresh — the snapshot freezes while admitted-since
                # ratchets, ending in a gateway that 429s forever
                adm.refresh_failed()
                raise
            else:
                adm.update_health(health, live_in_system=live)
        return adm.admit(
            n=n,
            priority=priority,
            client_id=request.headers.get("X-Client-Id"),
        )


CTX_KEY: web.AppKey["GatewayContext"] = web.AppKey("ctx", GatewayContext)
SWEEPER_KEY: web.AppKey["asyncio.Task"] = web.AppKey(
    "result_ttl_sweeper", asyncio.Task
)
SPAN_FLUSHER_KEY: web.AppKey["asyncio.Task"] = web.AppKey(
    "span_flusher", asyncio.Task
)


def _admission_reject(
    ctx: "GatewayContext",
    decision,
    what: str,
    n: int = 1,
    cls: str | None = None,
) -> web.Response:
    """Map an admission reject to the wire: retryable reasons are 429 +
    Retry-After; a batch larger than the quota bucket can EVER hold is a
    permanent 400 — a finite Retry-After there would send well-behaved
    clients into a retry loop against an impossible condition. ``n``
    keeps the reject counter in TASKS, same unit as the admit counter —
    a rejected 1000-task batch is 1000 rejected tasks, not one."""
    ctx.m_rejected.labels(reason=decision.reason).inc(n)
    if cls is not None:
        # the shed attribution bit: tasks that never ran, per class
        ctx.attrib.note("admission", "shed", cls, n)
    ctx.flightrec.emit(
        "admission_shed", reason=decision.reason, what=what, n=n
    )
    if decision.reason == "quota_exceeds_burst":
        return _json_error(
            400,
            f"{what} exceeds the per-client quota burst and can never be "
            "admitted whole; split it or raise --client-quota",
        )
    return _retry_after_response(
        429,
        f"{what} rejected ({decision.reason}); retry later",
        decision.reason,
        decision.retry_after,
    )


def _retry_after_response(
    status: int, message: str, reason: str, retry_after: float
) -> web.Response:
    """A reject carrying machine-readable backpressure: the Retry-After
    header (whole seconds, per RFC 9110) plus the same numbers in the
    body for clients that never look at headers."""
    seconds = max(1, int(math.ceil(retry_after)))
    return web.json_response(
        {"error": message, "reason": reason, "retry_after": seconds},
        status=status,
        headers={"Retry-After": str(seconds)},
    )


@web.middleware
async def _metrics_middleware(request: web.Request, handler):
    ctx: GatewayContext = request.app[CTX_KEY]
    t0 = time.perf_counter()
    try:
        return await handler(request)
    except StoreUnavailable as exc:
        # the store circuit breaker tripped (or the call just failed):
        # fast, honest 503 instead of a hung request — the one reject
        # that applies to EVERY store-touching endpoint
        ctx.m_rejected.labels(reason="store_unavailable").inc()
        return _retry_after_response(
            503,
            "task store unavailable; retry later",
            "store_unavailable",
            exc.retry_after,
        )
    finally:
        resource = request.match_info.route.resource
        # unmatched paths collapse into one bucket: keying by raw path would
        # let a URL scanner grow the span table without bound
        route = resource.canonical if resource is not None else "UNMATCHED"
        name = f"{request.method} {route}"
        # parked long-polls measure wait time, not serving latency — keep
        # them out of the route's real latency distribution
        if request.query.get("wait") not in (None, "", "0"):
            name += " (long-poll)"
        ctx.route_counts[name] = ctx.route_counts.get(name, 0) + 1
        ctx.m_requests.labels(name).inc()
        # mirrored tracer: this one record() feeds both the /stats ring
        # percentiles and the /metrics latency histogram
        ctx.tracer.record(name, time.perf_counter() - t0)


def _sweep_stale_blobs(
    store: TaskStore, all_keys: list[str], ttl: float, now_f: float
) -> list[str]:
    """The refcount-or-TTL GC of the blob namespace: a blob is collected
    only when BOTH (a) its last-put stamp (BLOB_AT_FIELD, refreshed by
    every registration of the same bytes) aged past 4x the result TTL —
    slower than task records on purpose, a cache-refill costs more than a
    stale record — AND (b) nothing references it anymore: no
    function-registry record carries its digest and no LIVE task does.
    The reference set is recomputed from the records at sweep time, so
    there is no persistent counter to corrupt. Result blobs (--result-
    blobs materializations) ride the same policy: a task record carrying
    the digest in FIELD_RESULT_DIGEST — live OR terminal-but-unswept —
    is a reference, so a digest-form record never outlives its readable
    body. Stale ``blobreq:`` request keys (a materialization the
    dispatcher never served — plane off, producer gone) age out at the
    plain result TTL. Returns keys to delete."""
    reqs_stale: list[str] = []
    req_keys = [k for k in all_keys if k.startswith(BLOBREQ_PREFIX)]
    if req_keys:
        for key, stamp in zip(
            req_keys, store.hget_many(req_keys, BLOBREQ_AT_FIELD)
        ):
            try:
                if stamp is not None and now_f - float(stamp) > ttl:
                    reqs_stale.append(key)
            except ValueError:
                continue
    blob_keys = [k for k in all_keys if k.startswith(BLOB_PREFIX)]
    if not blob_keys:
        return reqs_stale
    blob_ttl = 4 * ttl
    stamps = store.hget_many(blob_keys, BLOB_AT_FIELD)
    stale = []
    for key, stamp in zip(blob_keys, stamps):
        try:
            if stamp is not None and now_f - float(stamp) > blob_ttl:
                stale.append(key)
        except ValueError:
            continue  # unparseable stamp: never collect
    if not stale:
        return reqs_stale
    referenced: set[str] = set()
    fn_keys = [k for k in all_keys if k.startswith(_FUNCTION_PREFIX)]
    if fn_keys:
        for d in store.hget_many(fn_keys, _FN_DIGEST_FIELD):
            if d:
                referenced.add(d)
    live_ids = list(store.hgetall(LIVE_INDEX_KEY))
    if live_ids:
        for d in store.hget_many(live_ids, FIELD_FN_DIGEST):
            if d:
                referenced.add(d)
    # result-digest references over EVERY surviving task record (the
    # live index only tracks pre-terminal tasks, but a terminal digest-
    # form record is exactly the reader the materialized body serves)
    record_keys = [
        k
        for k in all_keys
        if not k.startswith(_FUNCTION_PREFIX)
        and not k.startswith(BLOB_PREFIX)
        and not k.startswith(BLOBREQ_PREFIX)
        and not k.startswith(_FN_INDEX_PREFIX)
        and not k.startswith(TRACE_PREFIX)
        and k != LIVE_INDEX_KEY
    ]
    if record_keys:
        for d in store.hget_many(record_keys, FIELD_RESULT_DIGEST):
            if d:
                referenced.add(d)
    return reqs_stale + [
        k for k in stale if k[len(BLOB_PREFIX):] not in referenced
    ]


def _repair_orphaned_waiting(
    store: TaskStore,
    keys: list[str],
    statuses: list[str | None],
    channel: str,
) -> int:
    """Resolve WAITING graph nodes whose promotion was lost: a resolver
    crash between the dependency decrement and the status flip (or a
    dispatcher dying with deferred dep completions) leaves a node WAITING
    forever while its parents are all terminal. Re-derive each such
    node's fate from the parents' statuses via the store's write-once
    resolution claim (TaskStore.resolve_waiting) — nodes with any LIVE
    parent are left strictly alone. Returns nodes resolved."""
    waiting = [
        k
        for k, s in zip(keys, statuses)
        if s == str(TaskStatus.WAITING)
    ]
    if not waiting:
        return 0
    repaired = 0
    for key, raw_deps in zip(waiting, store.hget_many(waiting, FIELD_DEPS)):
        parents = [p for p in (raw_deps or "").split(",") if p]
        if not parents:
            continue  # WAITING without deps: not ours to judge
        parent_statuses = dict(
            zip(parents, store.hget_many(parents, FIELD_STATUS))
        )
        fate = store.resolve_waiting(key, parent_statuses, channel)
        if fate is not None:
            log.warning("repaired orphaned WAITING node %s: %s", key, fate)
            repaired += 1
    return repaired


def _sweep_expired_results(
    store: TaskStore,
    ttl: float,
    now: float | None = None,
    channel: str = TASKS_CHANNEL,
    on_waiting_repaired=None,
) -> int:
    """Delete terminal task records older than ``ttl`` seconds (their
    FIELD_FINISHED_AT stamp). Returns records deleted. Pipelined status +
    stamp probes so the sweep stays one round trip per phase, not per key;
    live (QUEUED/RUNNING) tasks, unstamped records, and the function
    registry are never touched. Blob-namespace keys get their own
    refcount-or-TTL policy (_sweep_stale_blobs) instead of the terminal
    probe. WAITING graph nodes are never deleted, but orphaned ones —
    all parents terminal, promotion lost to a crash — are resolved in
    passing (_repair_orphaned_waiting; count reported via
    ``on_waiting_repaired``)."""
    now_f = now if now is not None else time.time()
    all_keys = store.keys()
    keys = [
        k
        for k in all_keys
        if not k.startswith(_FUNCTION_PREFIX)
        and not k.startswith(BLOB_PREFIX)
        and not k.startswith(BLOBREQ_PREFIX)
        and not k.startswith(_FN_INDEX_PREFIX)
        and not k.startswith(TRACE_PREFIX)
    ]
    blob_expired = _sweep_stale_blobs(store, all_keys, ttl, now_f)
    # span-plane hashes age by their own t0 stamp (they carry no status,
    # so the terminal probe below would never collect them)
    trace_expired = sweep_stale_traces(store, all_keys, ttl, now_f)
    blob_expired = blob_expired + trace_expired
    if not keys:
        store.delete_many(blob_expired)
        return len(blob_expired)
    statuses = store.hget_many(keys, FIELD_STATUS)
    repaired = _repair_orphaned_waiting(store, keys, statuses, channel)
    if repaired and on_waiting_repaired is not None:
        on_waiting_repaired(repaired)
    terminal = []
    statusless = []
    for key, status in zip(keys, statuses):
        if status is None:
            statusless.append(key)
            continue
        try:
            if TaskStatus(status).is_terminal():
                terminal.append(key)
        except ValueError:
            continue
    expired = []
    if terminal:
        stamps = store.hget_many(terminal, FIELD_FINISHED_AT)
        for key, stamp in zip(terminal, stamps):
            if stamp is None:
                continue  # pre-stamp record (foreign producer): never expire
            try:
                finished_at = float(stamp)
            except ValueError:
                continue
            if now_f - finished_at > ttl:
                expired.append(key)
    if expired:
        # a terminal GRAPH PARENT must outlive the TTL while any of its
        # children still sits WAITING: resolve_waiting treats a missing
        # parent record as poison-worthy ("reached MISSING"), so deleting
        # a COMPLETED parent whose dep walk is still pending (deferred
        # through an outage, resolver crashed) would later fail a child
        # whose parents all succeeded. Children statuses are already in
        # hand from this sweep's own probe — one extra pipelined
        # FIELD_CHILDREN round over the aged slice, no per-key traffic.
        # A child absent from the probe is long-deleted (children are
        # created with their parents), not waiting — those parents expire.
        kids_lists = store.hget_many(expired, FIELD_CHILDREN)
        status_by_key = dict(zip(keys, statuses))
        waiting = str(TaskStatus.WAITING)
        expired = [
            key
            for key, kids in zip(expired, kids_lists)
            if not kids
            or not any(
                status_by_key.get(child) == waiting
                for child in kids.split(",")
                if child
            )
        ]
    if statusless:
        # claim-only hashes: an idempotency claim whose winner died between
        # claim and create, never adopted by a retry. The claim value's
        # timestamp dates it; without this they would leak forever
        # (invisible to the terminal sweep — they have no status).
        claims = store.hget_many(statusless, _IDEM_CLAIM_FIELD)
        stale_claims = []
        for key, claim in zip(statusless, claims):
            if claim is None:
                continue  # not ours (foreign producer hash): never touch
            age = _idem_claim_age(claim, now_f)
            if age is not None and age > max(ttl, 10 * _IDEM_ADOPT_WAIT_S):
                stale_claims.append(key)
        if stale_claims:
            # re-probe right before deleting: a retry may have ADOPTED the
            # claim (created the real task record) since the snapshot above
            # — deleting then would vaporize an acknowledged submit. The
            # re-read shrinks the race to the sub-ms gap between these two
            # commands, against an adoption window that opens only after
            # the claim sat unadopted for minutes.
            recheck = store.hget_many(stale_claims, FIELD_STATUS)
            expired.extend(
                k for k, s in zip(stale_claims, recheck) if s is None
            )
    expired.extend(blob_expired)
    store.delete_many(expired)  # one variadic DEL on RESP backends
    return len(expired)


def make_app(
    store: TaskStore,
    channel: str = TASKS_CHANNEL,
    result_ttl: float | None = None,
    *,
    admission: "AdmissionController | None | bool" = True,
    breaker: "CircuitBreaker | None | bool" = True,
    payload_plane: bool = False,
    trace: bool = False,
    wait_safety_poll_s: float = _WAIT_POLL_MAX_S_DEFAULT,
) -> web.Application:
    """``admission``/``breaker``: True builds the defaults (admission
    fails open until a dispatcher publishes the saturation signal or a
    bound is configured; the breaker trips after 3 consecutive outage
    failures), False/None disables, or pass a configured instance.
    ``payload_plane=True`` turns on content-addressed function shipping
    (see GatewayContext.payload_plane for why it is opt-in).
    ``trace=True`` turns on distributed tracing (see GatewayContext.trace;
    off by default — single-process and reference-era setups run
    unchanged)."""
    if admission is True:
        admission = AdmissionController()
    elif admission is False:
        admission = None
    if breaker is True:
        breaker = CircuitBreaker()
    elif breaker is False:
        breaker = None
    if breaker is not None:
        # store HA: against a multi-endpoint (replicated) store, a failed
        # half-open probe rotates the client to the next endpoint and
        # re-probes immediately — failover happens inside ONE breaker
        # window instead of one full open window per dead endpoint
        rotate = getattr(store, "rotate_endpoint", None)
        endpoints = getattr(store, "endpoints", None)
        if rotate is not None and endpoints and len(endpoints) > 1:
            breaker.set_rotate_hook(rotate, budget=len(endpoints) - 1)
    ctx = GatewayContext(
        store=store,
        channel=channel,
        admission=admission,
        breaker=breaker,
        payload_plane=payload_plane,
        trace=trace,
        wait_safety_poll_s=max(0.1, float(wait_safety_poll_s)),
    )
    app = web.Application(
        client_max_size=256 * 1024 * 1024, middlewares=[_metrics_middleware]
    )
    app[CTX_KEY] = ctx
    app.router.add_post("/register_function", register_function)
    app.router.add_post("/execute_function", execute_function)
    app.router.add_post("/execute_batch", execute_batch)
    app.router.add_post("/execute_graph", execute_graph)
    app.router.add_get("/status/{task_id}", get_status)
    app.router.add_get("/result/{task_id}", get_result)
    app.router.add_post("/results/wait", wait_results)
    app.router.add_get("/events", events_stream)
    app.router.add_post("/cancel/{task_id}", cancel_task)
    app.router.add_delete("/task/{task_id}", delete_task)
    app.router.add_get("/healthz", healthz)
    app.router.add_get("/readyz", readyz)
    app.router.add_get("/metrics", metrics)
    app.router.add_get("/stats", stats)
    app.router.add_get("/slo", slo)
    app.router.add_get("/flightrec", flightrec)
    app.router.add_get("/trace/{task_id}", trace_task)

    async def _start_wakeups(_app: web.Application) -> None:
        ctx.waiters = _ResultWaiters(store)
        ctx.waiters.start(asyncio.get_running_loop())
        if result_ttl is not None and result_ttl > 0:
            async def sweeper() -> None:
                """Age out consumed results (reference behavior — the store
                grows until a manual FLUSHDB — is the default; this runs
                only when the operator sets --result-ttl). Clients that
                still need a result poll it before the TTL; late pollers
                get a 404, same as after an explicit DELETE /task."""
                # each sweep is a full KEYS walk (the RESP subset has no
                # SCAN): floor the period near the TTL itself so a small
                # TTL can't turn the sweeper into a keyspace-scan loop that
                # competes with the dispatcher on the store
                period = max(result_ttl / 4.0, min(result_ttl, 30.0))
                while not ctx.stopping.is_set():
                    try:
                        n = await _run_blocking(
                            functools.partial(
                                _sweep_expired_results,
                                ctx.store,
                                result_ttl,
                                channel=ctx.channel,
                                on_waiting_repaired=(
                                    ctx.m_waiting_repaired.inc
                                ),
                            )
                        )
                        if n:
                            log.info("result-ttl sweep: %d records expired", n)
                    except Exception as exc:
                        log.warning("result-ttl sweep failed (%s); retrying", exc)
                    try:
                        await asyncio.wait_for(
                            ctx.stopping.wait(), timeout=period
                        )
                    except asyncio.TimeoutError:
                        pass

            _app[SWEEPER_KEY] = asyncio.create_task(sweeper())

        if ctx.span_sink is not None:
            async def span_flusher() -> None:
                """Drain the span sink's buffer to the store on a short
                cadence — submits only append to the in-memory buffer, so
                tracing never puts a store round trip on the serving path.
                Outages are absorbed by the sink itself (bounded buffer,
                retry next cycle)."""
                while not ctx.stopping.is_set():
                    try:
                        await _run_blocking(ctx.span_sink.flush)
                    except Exception:  # flush never raises; belt+braces
                        pass
                    try:
                        await asyncio.wait_for(
                            ctx.stopping.wait(), timeout=0.25
                        )
                    except asyncio.TimeoutError:
                        pass

            _app[SPAN_FLUSHER_KEY] = asyncio.create_task(span_flusher())

    async def _release_waiters(_app: web.Application) -> None:
        ctx.stopping.set()
        flusher_task = _app.get(SPAN_FLUSHER_KEY)
        if flusher_task is not None:
            flusher_task.cancel()
            with contextlib.suppress(asyncio.CancelledError):
                await flusher_task
            # best-effort final flush so short-lived gateways (tests,
            # bench legs) don't strand their last buffered spans
            with contextlib.suppress(Exception):
                await _run_blocking(ctx.span_sink.flush)
        sweeper_task = _app.get(SWEEPER_KEY)
        if sweeper_task is not None:
            # the sweep period can be hours; don't wait it out on shutdown —
            # but DO await the cancellation, or the loop may close with the
            # task pending ('Task was destroyed but it is pending!')
            sweeper_task.cancel()
            with contextlib.suppress(asyncio.CancelledError):
                await sweeper_task
        if ctx.waiters is not None:
            ctx.waiters.fire_all()
            # stop() blocks on the pump-thread join (which can sit in a
            # connect timeout against a dead store) — run it off-loop so the
            # just-woken parked polls can actually send their replies
            await asyncio.get_running_loop().run_in_executor(
                None, ctx.waiters.stop
            )

    app.on_startup.append(_start_wakeups)
    app.on_shutdown.append(_release_waiters)
    return app


async def register_function(request: web.Request) -> web.Response:
    ctx: GatewayContext = request.app[CTX_KEY]
    try:
        body = await request.json()
        name, payload = body["name"], body["payload"]
    except Exception:
        return _json_error(400, "expected JSON body with 'name' and 'payload'")
    if not ctx.payload_plane:
        function_id = new_function_id()
        await ctx.store_call(
            ctx.store.hset,
            _FUNCTION_PREFIX + function_id,
            {"name": name, "payload": payload},
        )
        ctx.n_functions += 1
        ctx.m_functions.inc()
        return web.json_response({"function_id": function_id})
    # payload plane: the body is content-addressed. Register-once dedup —
    # the SAME bytes registered again (client retry, N replicas of one
    # service each registering at boot) resolve to the FIRST function_id,
    # writing nothing new. The digest index is claimed with setnx, so
    # exactly one of N concurrent registrations creates; losers adopt the
    # winner's id (the registry record may be a few ms behind the claim —
    # same write-once adoption shape as the idempotent submit path).
    digest = payload_digest(payload)
    function_id = new_function_id()
    claimed, current = await ctx.store_call(
        ctx.store.setnx_field,
        _FN_INDEX_PREFIX + digest,
        "function_id",
        function_id,
    )
    if not claimed:
        ctx.m_blob_saved.inc(len(payload))
        # refresh the blob TTL stamp (put-if-absent: write-once data, new
        # stamp) so an active function's body can't age out under it
        await ctx.store_call(ctx.store.put_blob, digest, payload)
        # adopt-and-repair: the claim winner may have died between its
        # index setnx and its registry hset (store outage mid-register) —
        # without this, the claimed id would 404 on every submit and the
        # poisoned digest index would pin every future registration of
        # these bytes to it forever. Safe to (re)write: same digest means
        # byte-identical payload, so racing repairers and a slow winner
        # all write the same record (name is last-writer, cosmetic).
        existing = await ctx.store_call(
            ctx.store.hget, _FUNCTION_PREFIX + current, "payload"
        )
        if existing is None:
            await ctx.store_call(
                ctx.store.hset,
                _FUNCTION_PREFIX + current,
                {"name": name, "payload": payload, _FN_DIGEST_FIELD: digest},
            )
        return web.json_response(
            {"function_id": current, "deduplicated": True}
        )
    created = await ctx.store_call(ctx.store.put_blob, digest, payload)
    if created:
        ctx.m_blob_written.inc(len(payload))
    else:
        ctx.m_blob_saved.inc(len(payload))
    await ctx.store_call(
        ctx.store.hset,
        _FUNCTION_PREFIX + function_id,
        # the inline payload stays on the (single) registry record: it is
        # the restore source for legacy-mode submits and debugging; the
        # per-task win is the digest below
        {"name": name, "payload": payload, _FN_DIGEST_FIELD: digest},
    )
    ctx.n_functions += 1
    ctx.m_functions.inc()
    return web.json_response({"function_id": function_id})


#: Priority bound: fits int32 with headroom for negation on device, and far
#: beyond any sane number of priority classes. Shared with the dispatcher's
#: defensive clamp (dispatch/base.py PendingTask.from_fields).
_PRIORITY_BOUND = 2**30


def _parse_hints(
    priority, cost, timeout=None, deadline=None, now: float | None = None,
    speculative=None,
) -> dict[str, str]:
    """Validate the optional scheduling hints into store hash fields.

    Raises ValueError with a client-facing message. Bounds: priority is an
    int (bool rejected — it JSON-decodes from true/false and is almost
    certainly a client bug); cost, timeout and deadline finite positive
    floats. ``deadline`` is RELATIVE on the wire (a submit-TTL in
    seconds); the stored field is the ABSOLUTE epoch instant past which a
    still-QUEUED task is shed to EXPIRED, so the decision survives
    dispatcher restarts without re-deriving the submit time.
    """
    extra: dict[str, str] = {}
    if priority is not None:
        if isinstance(priority, bool) or not isinstance(priority, int):
            raise ValueError("'priority' must be an integer")
        if not -_PRIORITY_BOUND <= priority <= _PRIORITY_BOUND:
            raise ValueError(
                f"'priority' must be within +/-{_PRIORITY_BOUND}"
            )
        extra[FIELD_PRIORITY] = str(priority)
    for name, field_name, value in (
        ("cost", FIELD_COST, cost),
        ("timeout", FIELD_TIMEOUT, timeout),
        ("deadline", FIELD_DEADLINE, deadline),
    ):
        if value is None:
            continue
        if (
            isinstance(value, bool)
            or not isinstance(value, (int, float))
            or not math.isfinite(value)
            or value <= 0
        ):
            raise ValueError(f"'{name}' must be a finite positive number")
        if field_name == FIELD_DEADLINE:
            base = now if now is not None else time.time()
            extra[field_name] = repr(base + float(value))
        else:
            extra[field_name] = repr(float(value))
    if speculative is not None:
        # strict bool: the flag is a CLIENT PROMISE (this task is safe to
        # execute more than once), not a tuning hint — a truthy string
        # must not silently opt a non-idempotent task into hedging
        if not isinstance(speculative, bool):
            raise ValueError("'speculative' must be a boolean")
        if speculative:
            extra[FIELD_SPECULATIVE] = "1"
    return extra


def _priority_of(value) -> int:
    """The admission-facing priority of a validated hint (0 = default)."""
    return value if isinstance(value, int) and not isinstance(value, bool) else 0


#: sentinel distinguishing "no header" (fine: default tenant) from "bad
#: header" (400) in _tenant_of's return
_BAD_TENANT = object()


def _tenant_of(request: web.Request):
    """The validated ``X-Tenant-Id`` header, None when absent (legacy
    clients — their tasks read as the default tenant everywhere), or
    ``_BAD_TENANT`` for a malformed value. Validated because the name
    becomes store-hash content, a share-table key, and a metrics-label
    candidate at the dispatcher."""
    tenant = request.headers.get("X-Tenant-Id")
    if tenant is None:
        return None
    if not valid_tenant(tenant):
        return _BAD_TENANT
    return tenant


_TENANT_400 = (
    "X-Tenant-Id must be 1-64 characters of [A-Za-z0-9._-], starting "
    "alphanumeric"
)

#: sentinel distinguishing "no declaration" (fine: class derived from the
#: priority sign downstream) from "bad declaration" (400) — same shape as
#: the tenant-header validation above, and for the same reason: the value
#: becomes store-hash content and a metrics-label candidate
_BAD_CLASS = object()

_CLASS_400 = (
    "X-SLO-Class (or 'slo_class') must be one of "
    + "/".join(SLO_CLASSES)
)


def _slo_class_of(request: web.Request, body: dict | None = None):
    """The declared SLO class: JSON body key ``slo_class`` (the SDK
    kwarg's wire form) wins over the ``X-SLO-Class`` header; None when
    neither is present; ``_BAD_CLASS`` for an off-vocabulary value —
    declarations are validated (a typo'd class silently degrading to
    ``default`` would un-judge the tasks the operator most cares about).
    """
    raw = None
    if body is not None:
        raw = body.get("slo_class")
    if raw is None:
        raw = request.headers.get("X-SLO-Class")
    if raw is None:
        return None
    cls = normalize_class(raw)
    return cls if cls is not None else _BAD_CLASS


def _idempotent_task_id(function_id: str, key: str) -> str:
    """Deterministic task id for (function, idempotency key): a client that
    re-sends the same submit — e.g. after a response was lost — addresses
    the SAME task record instead of creating a duplicate execution."""
    return str(uuid.uuid5(_IDEMPOTENCY_NS, f"{function_id}\x00{key}"))


async def execute_function(request: web.Request) -> web.Response:
    ctx: GatewayContext = request.app[CTX_KEY]
    try:
        body = await request.json()
        function_id, param_payload = body["function_id"], body["payload"]
    except Exception:
        return _json_error(400, "expected JSON body with 'function_id' and 'payload'")
    now = time.time()
    try:
        extra = _parse_hints(
            body.get("priority"),
            body.get("cost"),
            body.get("timeout"),
            body.get("deadline"),
            now=now,
            speculative=body.get("speculative"),
        )
    except ValueError as exc:
        return _json_error(400, str(exc))
    # first event of the task's lifecycle timeline (obs/trace.py): rides
    # the record so the dispatcher can measure queue wait from the submit
    extra[FIELD_SUBMITTED_AT] = repr(now)
    # tenancy plane: the record carries the validated tenant header so the
    # dispatcher's weighted-fair tick accounts this task to its principal;
    # absent = default tenant (legacy clients pay nothing)
    tenant = _tenant_of(request)
    if tenant is _BAD_TENANT:
        return _json_error(400, _TENANT_400)
    if tenant is not None:
        extra[FIELD_TENANT] = tenant
    # SLO class (obs/attribution.py): written ONLY when declared — the
    # record (and the submit wire) stays byte-identical for clients that
    # never declare; consumers derive from the priority sign instead
    slo_class = _slo_class_of(request, body)
    if slo_class is _BAD_CLASS:
        return _json_error(400, _CLASS_400)
    if slo_class is not None:
        extra[FIELD_SLO_CLASS] = slo_class
    # distributed trace context (obs/tracectx.py): client-supplied id
    # validated (it becomes a store key), or minted here for legacy
    # clients; ignored entirely while tracing is off
    trace_id = None
    if ctx.trace:
        trace_id = body.get("trace_id")
        if trace_id is not None and not valid_trace_id(trace_id):
            return _json_error(
                400, "'trace_id' must be 8-64 lowercase hex characters"
            )
        parent_span = body.get("parent_span")
        if parent_span is not None and (
            not isinstance(parent_span, str) or len(parent_span) > 64
        ):
            return _json_error(
                400, "'parent_span' must be a string of at most 64 chars"
            )
        if trace_id is None:
            trace_id = new_trace_id()
        extra[FIELD_TRACE_ID] = trace_id
        if parent_span:
            extra[FIELD_TRACE_PARENT] = parent_span
    idem_key = body.get("idempotency_key")
    if idem_key is not None and (
        not isinstance(idem_key, str) or not idem_key
    ):
        return _json_error(400, "'idempotency_key' must be a non-empty string")
    # admission BEFORE any store work: the reject path must cost
    # microseconds exactly when the system is drowning. (A duplicate
    # keyed re-send pays admission again — under overload even a dedup
    # probe is store load the 429 tells the client to defer.)
    decision = await ctx.admit(
        request, n=1, priority=_priority_of(body.get("priority"))
    )
    if decision is not None and not decision.admitted:
        return _admission_reject(
            ctx,
            decision,
            "submit",
            cls=class_of(slo_class, _priority_of(body.get("priority"))),
        )
    ctx.m_admitted.inc()
    t_admit = time.time()

    def note_submit_spans(created_at: float | None) -> None:
        """Gateway span records of this submit (buffered; the background
        flusher pays the store trip). Called only at sites that actually
        created the record — a dedup hit's trace belongs to the winner.
        Reads ``task_id`` from the enclosing scope at call time (every
        call site binds it first): the trace hash learns its task so the
        sweeper can check liveness."""
        if ctx.span_sink is None or not trace_id:
            return
        ctx.span_sink.emit(trace_id, "admit", now, t_admit, task_id=task_id)
        if created_at is not None:
            ctx.span_sink.emit(
                trace_id, "create", created_at, time.time(), task_id=task_id
            )

    def submit_response(
        task_id: str, own_trace: bool = True, **extra_body
    ) -> web.Response:
        """``own_trace=False``: this request's trace id is NOT the one on
        the record (a racing creator's won) — suppress it like a dedup
        hit's, even though the submit itself wasn't deduplicated."""
        body_out: dict = {"task_id": task_id, **extra_body}
        if (
            trace_id is not None
            and own_trace
            and not extra_body.get("deduplicated")
        ):
            body_out["trace_id"] = trace_id
        return web.json_response(body_out)

    fn_payload, fn_dig = await ctx.store_call(
        ctx.store.hmget,
        _FUNCTION_PREFIX + function_id,
        ["payload", _FN_DIGEST_FIELD],
    )
    if fn_payload is None:
        return _json_error(404, f"unknown function_id {function_id!r}")
    # payload plane: the record carries the digest, not the body — this
    # single line is where a burst of N submits stops writing the function
    # N times (the body already sits under blob:<digest>)
    fn_body = fn_payload
    blob_saved = 0
    if ctx.payload_plane and fn_dig:
        extra[FIELD_FN_DIGEST] = fn_dig
        fn_body = ""
        # counted only where a record is actually created (below) —
        # idempotent duplicates and failed creates save nothing, and the
        # batch path gates the same metric on its to_create set
        blob_saved = len(fn_payload)

    def write_task(task_id: str) -> None:
        ctx.store.create_task(
            task_id, fn_body, param_payload, ctx.channel, extra or None
        )

    def write_task_nx(task_id: str) -> bool:
        # keyed creates only: winner and adopter can both believe the
        # deterministic task id is theirs to write; a plain create racing
        # an already-dispatched copy would reset RUNNING back to QUEUED
        # and run the task twice
        return ctx.store.create_task_if_absent(
            task_id, fn_body, param_payload, ctx.channel, extra or None
        )

    if idem_key is not None:
        task_id = _idempotent_task_id(function_id, idem_key)
        # atomic claim (store-side: exactly one of N concurrent claimers
        # wins — a get-then-create here would let two in-flight duplicates
        # both create+announce and run the task twice). The claim value
        # carries the payload hash, so key-reuse-with-different-payload is
        # caught right here without waiting for the winner's record write.
        claim = _idem_claim_value(param_payload)
        created, current = await ctx.store_call(
            ctx.store.setnx_field, task_id, _IDEM_CLAIM_FIELD, claim
        )
        if not created:
            if _idem_claim_hash(current) != _idem_claim_hash(claim):
                return _json_error(
                    409,
                    "idempotency_key was already used with a different "
                    "payload",
                )
            # duplicate submit: normally write nothing, announce nothing.
            # But the record must EXIST before we acknowledge, or the
            # client's next GET /status 404s for a submit we just accepted
            # — and if the winner died between claim and create, nobody
            # would ever create it. Wait briefly for the in-flight winner;
            # past the deadline, adopt the claim and create the record
            # ourselves (safe: the task id is deterministic and create_task
            # writes the identical payload in one atomic HSET; a duplicate
            # announce is deduped by dispatcher intake, which skips
            # non-QUEUED tasks and same-batch repeats).
            deadline = time.monotonic() + _IDEM_ADOPT_WAIT_S
            pause = 0.02
            while True:
                # presence probe only (hexists): params can be multi-MB
                # and this loop may poll a dozen times while the winner's
                # create is in flight — never drag the payload to ask "is
                # it there yet"
                present = await ctx.store_call(
                    ctx.store.hexists, task_id, FIELD_PARAMS
                )
                if present or time.monotonic() >= deadline:
                    break
                await asyncio.sleep(pause)
                pause = min(pause * 2, 0.25)
            if not present:
                log.warning(
                    "adopting abandoned idempotency claim for task %s",
                    task_id,
                )
                t_create = time.time()
                if await ctx.store_call(write_task_nx, task_id):
                    ctx.n_tasks += 1
                    ctx.m_tasks.inc()
                    if blob_saved:
                        ctx.m_blob_saved.inc(blob_saved)
                    # the adopted record carries OUR trace context (the
                    # winner died before writing one) — so unlike a plain
                    # dedup hit, THIS caller's trace id is the one on the
                    # record and the response must say so
                    note_submit_spans(t_create)
                    if trace_id is not None:
                        return submit_response(
                            task_id, deduplicated=True, trace_id=trace_id
                        )
            elif (
                await ctx.store_call(ctx.store.hget, task_id, FIELD_STATUS)
                is None
            ):
                # payload present but status stripped: a cancel aimed at a
                # PREVIOUS incarnation of this deterministic id had its
                # ghost cleanup race the winner's create (store/base.py
                # cancel_task). write_task_nx re-claims the absent status
                # and re-announces — identical values, write-once
                log.warning(
                    "repairing status-stripped record for task %s", task_id
                )
                await ctx.store_call(write_task_nx, task_id)
            return submit_response(task_id, deduplicated=True)
        t_create = time.time()
        if await ctx.store_call(write_task_nx, task_id):
            ctx.n_tasks += 1
            ctx.m_tasks.inc()
            if blob_saved:
                ctx.m_blob_saved.inc(blob_saved)
            note_submit_spans(t_create)
            return submit_response(task_id)
        # won the claim but LOST the record write: our create stalled past
        # the adopt deadline and a dedup loser created the record with ITS
        # trace context — echoing ours would hand the client a trace id
        # that disagrees with the record (and the adopter already counted
        # the task)
        return submit_response(task_id, own_trace=False)

    task_id = new_task_id()
    t_create = time.time()
    await ctx.store_call(write_task, task_id)
    ctx.n_tasks += 1
    ctx.m_tasks.inc()
    if blob_saved:
        ctx.m_blob_saved.inc(blob_saved)
    note_submit_spans(t_create)
    return submit_response(task_id)


async def execute_batch(request: web.Request) -> web.Response:
    """Submit many invocations of one function in a single HTTP call — the
    store writes + announces ride one pipelined round trip (RespStore
    .create_tasks). Beyond the reference surface, where N tasks cost N POSTs
    (its time-to-register metric is dominated by exactly this)."""
    ctx: GatewayContext = request.app[CTX_KEY]
    try:
        body = await request.json()
        function_id = body["function_id"]
        payloads = body["payloads"]
    except Exception:
        return _json_error(
            400, "expected JSON body with 'function_id' and 'payloads' list"
        )
    if not isinstance(payloads, list) or not all(
        isinstance(p, str) for p in payloads
    ):
        return _json_error(400, "'payloads' must be a list of strings")
    # optional parallel hint lists; None entries mean "no hint for this task"
    priorities = body.get("priorities")
    costs = body.get("costs")
    timeouts = body.get("timeouts")
    deadlines = body.get("deadlines")
    for name, lst in (
        ("priorities", priorities),
        ("costs", costs),
        ("timeouts", timeouts),
        ("deadlines", deadlines),
    ):
        if lst is not None and (
            not isinstance(lst, list) or len(lst) != len(payloads)
        ):
            return _json_error(
                400, f"'{name}' must be a list parallel to 'payloads'"
            )
    now = time.time()
    try:
        # one speculative flag for the whole batch (like the tenant
        # header): the client's idempotency promise is per-submit-call
        extras = [
            _parse_hints(
                priorities[i] if priorities else None,
                costs[i] if costs else None,
                timeouts[i] if timeouts else None,
                deadlines[i] if deadlines else None,
                now=now,
                speculative=body.get("speculative"),
            )
            for i in range(len(payloads))
        ]
    except ValueError as exc:
        return _json_error(400, str(exc))
    submit_stamp = repr(now)  # one submit time for the whole batch
    # one tenant per request (the header), stamped on every member
    tenant = _tenant_of(request)
    if tenant is _BAD_TENANT:
        return _json_error(400, _TENANT_400)
    # one declared SLO class per request (the header / body key), stamped
    # on every member that has one — members without a declaration keep
    # deriving from their own priority sign
    slo_class = _slo_class_of(request, body)
    if slo_class is _BAD_CLASS:
        return _json_error(400, _CLASS_400)
    for e in extras:
        e[FIELD_SUBMITTED_AT] = submit_stamp
        if tenant is not None:
            e[FIELD_TENANT] = tenant
        if slo_class is not None:
            e[FIELD_SLO_CLASS] = slo_class
    # distributed trace context, batched: a parallel optional list of
    # client-minted ids; holes (and the whole list, for legacy clients)
    # are minted here. Ignored entirely while tracing is off.
    trace_ids: list[str | None] = [None] * len(payloads)
    if ctx.trace:
        client_tids = body.get("trace_ids")
        if client_tids is not None and (
            not isinstance(client_tids, list)
            or len(client_tids) != len(payloads)
        ):
            return _json_error(
                400, "'trace_ids' must be a list parallel to 'payloads'"
            )
        seen_tids: set[str] = set()
        for i in range(len(payloads)):
            tid = client_tids[i] if client_tids else None
            if tid is not None and not valid_trace_id(tid):
                return _json_error(
                    400,
                    f"trace_ids[{i}] must be 8-64 lowercase hex characters",
                )
            if tid is not None:
                if tid in seen_tids:
                    # two tasks sharing one trace id would fight over the
                    # same span hash: identical process:stage fields lose
                    # the first-write-wins race, the loser's timeline
                    # silently assembles as the winner's, and the
                    # duplicate counter (the replay-storm signal) ticks
                    # on client misuse — same contract as duplicate
                    # idempotency_keys below
                    return _json_error(
                        400, f"trace_ids[{i}] duplicates an earlier entry"
                    )
                seen_tids.add(tid)
            trace_ids[i] = tid or new_trace_id()
            extras[i][FIELD_TRACE_ID] = trace_ids[i]
    idem_keys = body.get("idempotency_keys")
    if idem_keys is not None:
        if not isinstance(idem_keys, list) or len(idem_keys) != len(payloads):
            return _json_error(
                400, "'idempotency_keys' must be a list parallel to 'payloads'"
            )
        seen_keys: set[str] = set()
        for k in idem_keys:
            if k is None:
                continue
            if not isinstance(k, str) or not k:
                return _json_error(
                    400,
                    "'idempotency_keys' entries must be non-empty strings "
                    "or null",
                )
            if k in seen_keys:
                # two items with one key cannot both be honored — and the
                # claim round would silently dedup the second against the
                # first mid-flight, before its payload is even comparable
                return _json_error(
                    400,
                    f"duplicate idempotency_key {k!r} within one batch",
                )
            seen_keys.add(k)
    # admission AFTER every cheap validation (a malformed batch must not
    # drain its client's quota or inflate the in-system estimate) but
    # BEFORE any store work (the reject path stays store-free — which is
    # also why the unknown-function 404 can still cost a charge: probing
    # function existence first would put a store read on every reject).
    # The batch decides ATOMICALLY on its LOWEST priority
    # (shed-lowest-first stays monotonic: a batch is only admitted where
    # its weakest member would be) and consumes n quota tokens —
    # splitting would break the all-ids-or-nothing reply.
    decision = await ctx.admit(
        request,
        n=len(payloads),
        priority=min(
            (_priority_of(p) for p in (priorities or [0])), default=0
        ),
    )
    if decision is not None and not decision.admitted:
        return _admission_reject(
            ctx,
            decision,
            "batch",
            n=len(payloads),
            cls=class_of(
                slo_class,
                min((_priority_of(p) for p in (priorities or [0])), default=0),
            ),
        )
    ctx.m_admitted.inc(len(payloads))
    t_admit = time.time()
    fn_payload, fn_dig = await ctx.store_call(
        ctx.store.hmget,
        _FUNCTION_PREFIX + function_id,
        ["payload", _FN_DIGEST_FIELD],
    )
    if fn_payload is None:
        return _json_error(404, f"unknown function_id {function_id!r}")
    # payload plane: every record of the batch carries the digest instead
    # of the inline body (see execute_function)
    fn_body = fn_payload
    if ctx.payload_plane and fn_dig:
        for e in extras:
            e[FIELD_FN_DIGEST] = fn_dig
        fn_body = ""

    task_ids: list[str] = []
    dedup: list[bool] = [False] * len(payloads)
    if idem_keys is None:
        task_ids = [new_task_id() for _ in payloads]
        to_create = list(range(len(payloads)))
    else:
        # same semantics as the single endpoint, batched. Validation comes
        # BEFORE any claim is written: a 409 discovered after claiming
        # other items would leave their fresh claims without task records
        # (burned keys). The pre-read catches every already-stored
        # mismatch; only a mismatch racing in between the pre-read and the
        # claim round can still 409 after claims, and those orphaned claims
        # are self-healing (adopted by the next retry, or aged out by the
        # TTL sweeper via the claim timestamp).
        keyed = [i for i, k in enumerate(idem_keys) if k is not None]
        claim_ids = {
            i: _idempotent_task_id(function_id, idem_keys[i]) for i in keyed
        }
        claims = {i: _idem_claim_value(payloads[i]) for i in keyed}
        existing = await ctx.store_call(
            ctx.store.hget_many,
            [claim_ids[i] for i in keyed],
            _IDEM_CLAIM_FIELD,
        )
        for i, current in zip(keyed, existing):
            if current is not None and _idem_claim_hash(
                current
            ) != _idem_claim_hash(claims[i]):
                return _json_error(
                    409,
                    f"idempotency_keys[{i}] was already used with a "
                    "different payload",
                )
        # one pipelined round trip claims every keyed id atomically
        results = await ctx.store_call(
            ctx.store.setnx_fields,
            [(claim_ids[i], claims[i]) for i in keyed],
            _IDEM_CLAIM_FIELD,
        )
        won: dict[int, bool] = {}
        for i, (created, current) in zip(keyed, results):
            if not created and _idem_claim_hash(
                current
            ) != _idem_claim_hash(claims[i]):
                return _json_error(
                    409,
                    f"idempotency_keys[{i}] was already used with a "
                    "different payload",
                )
            won[i] = created
        # Dedup losers still need their records to EXIST before we ack
        # (claim winner may be in flight — or dead). One collective bounded
        # wait, then adopt whatever never appeared.
        losers = [i for i in keyed if not won[i]]
        missing: list[int] = []
        if losers:
            deadline = time.monotonic() + _IDEM_ADOPT_WAIT_S
            pause = 0.02
            while True:
                stored = await ctx.store_call(
                    ctx.store.hget_many,
                    [claim_ids[i] for i in losers],
                    FIELD_PARAMS,
                )
                missing = [
                    i for i, s in zip(losers, stored) if s is None
                ]
                if not missing or time.monotonic() >= deadline:
                    break
                losers = missing
                await asyncio.sleep(pause)
                pause = min(pause * 2, 0.25)
            if missing:
                log.warning(
                    "adopting %d abandoned idempotency claims", len(missing)
                )
        adopt = set(missing)
        to_create = []
        for i in range(len(payloads)):
            if idem_keys[i] is None:
                task_ids.append(new_task_id())
                to_create.append(i)
            elif won[i] or i in adopt:
                task_ids.append(claim_ids[i])
                to_create.append(i)
                dedup[i] = not won[i]
            else:
                task_ids.append(claim_ids[i])
                dedup[i] = True

    def write_tasks() -> dict[int, bool]:
        """Write every to-create record; returns which indices THIS call
        actually created — an NX item can lose to a racing adopter, and
        its slot's trace id / task count then belongs to the winner."""
        if idem_keys is None:
            ctx.store.create_tasks(
                [
                    (task_ids[i], fn_body, payloads[i], extras[i] or None)
                    for i in to_create
                ],
                ctx.channel,
            )
            return {i: True for i in to_create}
        # keyed items use the regression-proof create (see write_task_nx in
        # execute_function), batched — a bounded number of pipelined
        # rounds, not several round trips per item; unkeyed items in the
        # same batch keep the one-round-trip pipelined create
        created_flags: dict[int, bool] = {}
        unkeyed = [i for i in to_create if idem_keys[i] is None]
        if unkeyed:
            ctx.store.create_tasks(
                [
                    (task_ids[i], fn_body, payloads[i], extras[i] or None)
                    for i in unkeyed
                ],
                ctx.channel,
            )
            created_flags.update({i: True for i in unkeyed})
        keyed_idx = [i for i in to_create if idem_keys[i] is not None]
        if keyed_idx:
            flags = ctx.store.create_tasks_if_absent(
                [
                    (task_ids[i], fn_body, payloads[i], extras[i] or None)
                    for i in keyed_idx
                ],
                ctx.channel,
            )
            created_flags.update(dict(zip(keyed_idx, flags)))
        return created_flags

    created_flags = await ctx.store_call(write_tasks)
    n_created = sum(1 for won_i in created_flags.values() if won_i)
    if fn_body == "" and fn_payload and n_created:
        ctx.m_blob_saved.inc(len(fn_payload) * n_created)
    ctx.n_tasks += n_created
    ctx.m_tasks.inc(n_created)
    if ctx.span_sink is not None:
        # gateway spans for the records this call actually created (a
        # dedup hit's trace belongs to the claim winner); buffered — the
        # background flusher pays the store trip
        t_done = time.time()
        # one pipelined write round serves the whole batch, so per-record
        # windows don't exist: every member's span covers the BATCH window,
        # annotated with the batch size so triage can divide (or discount)
        # instead of reading N copies of the whole batch's store work as N
        # independently slow creates
        batch_attr = {"batch": len(to_create)} if len(to_create) > 1 else {}
        for i in to_create:
            tid = trace_ids[i]
            if tid and created_flags.get(i):
                ctx.span_sink.emit(
                    tid,
                    "admit",
                    now,
                    t_admit,
                    task_id=task_ids[i],
                    **batch_attr,
                )
                ctx.span_sink.emit(
                    tid,
                    "create",
                    t_admit,
                    t_done,
                    task_id=task_ids[i],
                    **batch_attr,
                )
    resp = {"task_ids": task_ids}
    if idem_keys is not None:
        resp["deduplicated"] = dedup
    if ctx.trace:
        # a trace id is only truthful for records THIS call wrote — a
        # dedup hit's (or an NX race loser's) record carries the claim
        # winner's id, so its slot reports null (query /trace/<task_id>
        # for the real one)
        resp["trace_ids"] = [
            trace_ids[i] if created_flags.get(i) else None
            for i in range(len(payloads))
        ]
    return web.json_response(resp)


async def execute_graph(request: web.Request) -> web.Response:
    """Submit a task DAG in one call: ``{"nodes": [{"function_id",
    "payload", "depends_on": [refs], "id"?, hints...}, ...]}`` where each
    ``depends_on`` entry is an integer node index or another node's
    client-local ``id``. The gateway proves acyclicity + the size cap and
    charges admission for the WHOLE graph up front; creation is two
    pipelined store rounds — every dependent node first (status WAITING,
    carrying FIELD_DEPS + FIELD_PENDING_DEPS + its children edges), then
    the roots (QUEUED, announced dispatchable), so a parent can never
    finish against missing child records. From there the store's
    promotion plane owns the lifecycle: the last COMPLETED parent flips a
    child WAITING -> QUEUED onto the ordinary bus; a FAILED/EXPIRED/
    CANCELLED parent poisons its transitive frontier (dep_failed, never
    dispatched). Reply: ``{"task_ids": [per node], "graph": {...}}``."""
    ctx: GatewayContext = request.app[CTX_KEY]
    try:
        body = await request.json()
        nodes = body["nodes"]
    except Exception:
        return _json_error(400, "expected JSON body with a 'nodes' list")
    try:
        deps, topo = validate_graph(nodes)
    except GraphValidationError as exc:
        return _json_error(400, str(exc))
    now = time.time()
    submit_stamp = repr(now)
    tenant = _tenant_of(request)  # one tenant per graph (the header)
    if tenant is _BAD_TENANT:
        return _json_error(400, _TENANT_400)
    slo_class = _slo_class_of(request, body)  # one class per graph, ditto
    if slo_class is _BAD_CLASS:
        return _json_error(400, _CLASS_400)
    extras: list[dict[str, str]] = []
    fids: list[str] = []
    for i, node in enumerate(nodes):
        fid, payload = node.get("function_id"), node.get("payload")
        if not isinstance(fid, str) or not isinstance(payload, str):
            return _json_error(
                400,
                f"nodes[{i}] needs 'function_id' and 'payload' strings",
            )
        try:
            extra = _parse_hints(
                node.get("priority"),
                node.get("cost"),
                node.get("timeout"),
                node.get("deadline"),
                now=now,
            )
        except ValueError as exc:
            return _json_error(400, f"nodes[{i}]: {exc}")
        extra[FIELD_SUBMITTED_AT] = submit_stamp
        if tenant is not None:
            extra[FIELD_TENANT] = tenant
        if slo_class is not None:
            extra[FIELD_SLO_CLASS] = slo_class
        extras.append(extra)
        fids.append(fid)
    # admission AFTER validation, BEFORE store work; the graph decides
    # ATOMICALLY (children are useless without their parents admitted) on
    # its lowest priority and consumes one token per node — same contract
    # as the batch endpoint
    decision = await ctx.admit(
        request,
        n=len(nodes),
        priority=min(_priority_of(n.get("priority")) for n in nodes),
    )
    if decision is not None and not decision.admitted:
        return _admission_reject(
            ctx,
            decision,
            "graph",
            n=len(nodes),
            cls=class_of(
                slo_class,
                min(_priority_of(n.get("priority")) for n in nodes),
            ),
        )
    ctx.m_admitted.inc(len(nodes))
    distinct = list(dict.fromkeys(fids))
    fn_keys = [_FUNCTION_PREFIX + f for f in distinct]
    # payload + digest in ONE pipelined round, like the single/batch
    # submit endpoints' hmget — not a sequential round trip per field
    records = await ctx.store_call(ctx.store.hgetall_many, fn_keys)
    fn_map: dict[str, tuple[str, str | None]] = {}
    for fid, rec in zip(distinct, records):
        fn_payload = rec.get("payload")
        if fn_payload is None:
            return _json_error(404, f"unknown function_id {fid!r}")
        fn_map[fid] = (fn_payload, rec.get(_FN_DIGEST_FIELD))
    task_ids = [new_task_id() for _ in nodes]
    children: list[list[int]] = [[] for _ in nodes]
    for i, parents in enumerate(deps):
        for p in parents:
            children[p].append(i)
    trace_ids: list[str | None] = [None] * len(nodes)
    bodies: list[str] = []
    for i in range(len(nodes)):
        if children[i]:
            extras[i][FIELD_CHILDREN] = ",".join(
                task_ids[c] for c in children[i]
            )
        if deps[i]:
            extras[i][FIELD_DEPS] = ",".join(task_ids[p] for p in deps[i])
            extras[i][FIELD_PENDING_DEPS] = str(len(deps[i]))
        if ctx.trace:
            trace_ids[i] = new_trace_id()
            extras[i][FIELD_TRACE_ID] = trace_ids[i]
        fn_payload, dig = fn_map[fids[i]]
        if ctx.payload_plane and dig:
            extras[i][FIELD_FN_DIGEST] = dig
            ctx.m_blob_saved.inc(len(fn_payload))
            bodies.append("")
        else:
            bodies.append(fn_payload)
    # creation order: children BEFORE parents (reverse topological), so a
    # parent's terminal write can never walk edges to records that don't
    # exist yet; WAITING nodes in one pipelined round, then the QUEUED
    # roots (whose announces make the graph runnable) in a second
    order = list(reversed(topo))
    waiting_nodes = [
        (task_ids[i], bodies[i], nodes[i]["payload"], extras[i])
        for i in order
        if deps[i]
    ]
    root_nodes = [
        (task_ids[i], bodies[i], nodes[i]["payload"], extras[i])
        for i in order
        if not deps[i]
    ]

    def write_graph() -> None:
        if waiting_nodes:
            ctx.store.create_tasks(
                waiting_nodes, ctx.channel, status=TaskStatus.WAITING
            )
        if root_nodes:
            ctx.store.create_tasks(root_nodes, ctx.channel)

    await ctx.store_call(write_graph)
    ctx.n_tasks += len(nodes)
    ctx.m_tasks.inc(len(nodes))
    ctx.m_graphs.inc()
    ctx.m_graph_nodes.labels(kind="root").inc(len(root_nodes))
    ctx.m_graph_nodes.labels(kind="waiting").inc(len(waiting_nodes))
    resp: dict = {
        "task_ids": task_ids,
        "graph": {
            "nodes": len(nodes),
            "roots": len(root_nodes),
            "edges": sum(len(d) for d in deps),
        },
    }
    if ctx.trace:
        resp["trace_ids"] = trace_ids
    return web.json_response(resp)


async def get_status(request: web.Request) -> web.Response:
    ctx: GatewayContext = request.app[CTX_KEY]
    task_id = request.match_info["task_id"]
    ctx.note_shard_route(task_id)
    status = await ctx.store_call(ctx.store.get_status, task_id)
    if status is None:
        return _json_error(404, f"unknown task_id {task_id!r}")
    return web.json_response({"task_id": task_id, "status": status})


#: Long-poll cap: bounds handler lifetime (proxies and LB idle timeouts
#: commonly sit at 30-60 s).
_MAX_WAIT_S = 30.0
#: Fallback re-read cadence for parked long-polls. The fast path is the
#: RESULTS_CHANNEL wake-up (_ResultWaiters) — these re-reads only catch a
#: lost publish (fire-and-forget bus, subscription reconnect gap), so they
#: can be coarse: parked waiters must not saturate the shared executor
#: (each re-read is a blocking store call on the default thread pool).
_WAIT_POLL_S = 0.5
_WAIT_POLL_MAX_S = _WAIT_POLL_MAX_S_DEFAULT


#: Lazy result materialization (result-blob plane, legacy readers): a
#: digest-form task record stores FIELD_RESULT="" + FIELD_RESULT_DIGEST —
#: the body lives only in the producing worker's result cache until a
#: reader needs it. The gateway requests materialization by claiming
#: ``blobreq:<digest>`` (setnx — one requester wins, the rest piggyback)
#: and publishing ``!blobreq:<digest>`` on the tasks channel; the
#: dispatcher reverse-pulls the producer and lands the body at
#: ``blob:<digest>``. The poll below bounds how long a reader waits for
#: that round-trip before declaring the body gone (producer evicted /
#: worker restarted): 410, not a hang.
_BLOBREQ_WAIT_S = 2.0
_BLOBREQ_POLL_S = 0.1


async def _materialize_result(
    ctx: "GatewayContext",
    task_id: str,
    status: str | None,
    result: str | None,
) -> tuple[str | None, bool]:
    """Resolve a digest-form terminal record to its result body.

    Returns ``(result, ok)``. Pass-through (ok=True) when the record
    already carries a body, isn't terminal, or never had a digest — the
    plane-off path does zero extra store reads beyond one hmget only when
    the fetched result was empty AND terminal (an empty COMPLETED body is
    legal and rare; the hmget distinguishes it from digest form)."""
    if result:
        return result, True
    try:
        if status is None or not TaskStatus(status).is_terminal():
            return result, True
    except ValueError:
        return result, True
    digest = (
        await ctx.store_call(ctx.store.hmget, task_id, [FIELD_RESULT_DIGEST])
    )[0]
    if not digest:
        return result, True  # genuinely empty body, not digest form
    body = await ctx.store_call(ctx.store.get_blob, digest)
    if body is not None:
        return body, True
    # not materialized yet: claim the request key (idempotent across
    # concurrent readers and gateways) and ask the dispatcher plane
    await ctx.store_call(
        ctx.store.setnx_field,
        blobreq_key(digest),
        BLOBREQ_AT_FIELD,
        repr(time.time()),
    )
    await ctx.store_call(
        ctx.store.publish, ctx.channel, BLOBREQ_ANNOUNCE_PREFIX + digest
    )
    loop = asyncio.get_running_loop()
    deadline = loop.time() + _BLOBREQ_WAIT_S
    while loop.time() < deadline and not ctx.stopping.is_set():
        await asyncio.sleep(_BLOBREQ_POLL_S)
        body = await ctx.store_call(ctx.store.get_blob, digest)
        if body is not None:
            return body, True
    return None, False


def _note_terminal_delivery(
    ctx: "GatewayContext",
    task_id: str,
    status: str,
    source: str,
    loop: asyncio.AbstractEventLoop,
) -> None:
    """Bookkeeping shared by every terminal delivery path (/result,
    /results/wait, /events): the delivery-source counter plus the
    fire-and-forget first-delivery observation (e2e histograms + observe
    span) — the reply must never wait on the telemetry fetch (the task is
    held via ctx so it can't be GC'd mid-flight)."""
    ctx.m_result_served.labels(source=source).inc()
    if task_id not in ctx._observed:
        t = loop.create_task(
            _note_observed(ctx, task_id, status, time.time(), source)
        )
        ctx._observe_tasks.add(t)
        t.add_done_callback(ctx._observe_tasks.discard)


async def get_result(request: web.Request) -> web.Response:
    """``?wait=N`` long-polls: hold the request up to N seconds (capped)
    until the task is terminal, then reply immediately — one request
    replaces hundreds of 10 ms polls per task. Parked requests are woken by
    the store's terminal-write announce the moment the result lands — and
    when that announce carries the express lane's inline payload
    (dispatcher ``--express``), the reply is served straight from the
    forwarded status+result with NO store re-read on the delivery path
    (counted in result_served_total{source="inline"}). ``wait`` absent or
    0 keeps the reference's immediate-reply contract, store read and
    all."""
    ctx: GatewayContext = request.app[CTX_KEY]
    task_id = request.match_info["task_id"]
    try:
        wait_s = float(request.query.get("wait", 0) or 0)
    except ValueError:
        wait_s = math.nan
    if not (0.0 <= wait_s):  # rejects NaN too (any NaN compare is False)
        return _json_error(400, "'wait' must be a non-negative number")
    wait_s = min(wait_s, _MAX_WAIT_S)
    ctx.note_shard_route(task_id)
    loop = asyncio.get_running_loop()
    deadline = loop.time() + wait_s
    waiters = ctx.waiters
    waiter = (
        waiters.acquire(task_id)
        if waiters is not None and wait_s > 0
        else None
    )
    # safety-poll tuning: with a waiter armed, the announce IS the wake
    # path and the store re-read is only announce-loss insurance — start
    # it coarse instead of re-reading at 0.5 s. Without a waiter plane the
    # poll is the only wake path and keeps its fine-grained start.
    poll_cap = ctx.wait_safety_poll_s if waiter is not None else _WAIT_POLL_MAX_S
    poll_s = poll_cap if waiter is not None else _WAIT_POLL_S
    # attribution: did the last park time out (safety re-read) rather
    # than being woken by an announce? A terminal found that way is
    # counted in safety_poll_served_total
    woke_by_poll = False
    try:
        while True:
            # clear BEFORE the read: an announce landing between the read
            # and the wait then leaves the event set, so the wait returns at
            # once and the next read observes the terminal record (or the
            # forwarded payload) — the wake-up can be consumed spuriously
            # but never lost
            if waiter is not None:
                waiter.event.clear()
                inline = waiter.inline.get(task_id)
                if inline is not None:
                    # express delivery: the announce that woke us carried
                    # the terminal payload — the authoritative store write
                    # landed BEFORE it on the same pipelined round, so this
                    # reply equals the re-read it replaces
                    status, result = inline
                    _note_terminal_delivery(
                        ctx, task_id, status, "inline", loop
                    )
                    return web.json_response(
                        {
                            "task_id": task_id,
                            "status": status,
                            "result": result,
                        }
                    )
            status, result = await ctx.store_call(ctx.store.get_result, task_id)
            if status is None:
                return _json_error(404, f"unknown task_id {task_id!r}")
            try:
                terminal = TaskStatus(status).is_terminal()
            except ValueError:
                terminal = True  # unknown status string: reply, don't 500/hang
            if terminal or loop.time() >= deadline or ctx.stopping.is_set():
                if terminal:
                    result, ok = await _materialize_result(
                        ctx, task_id, status, result
                    )
                    if not ok:
                        # digest-form record whose body never materialized
                        # (producer evicted it or left the fleet): the
                        # record is authoritative about status, the body is
                        # unrecoverable — permanent, not retryable
                        return _json_error(
                            410,
                            f"result body for {task_id!r} is gone "
                            "(result-blob expired before materialization)",
                        )
                    if waiter is not None and woke_by_poll:
                        # the announce never woke us — the safety re-read
                        # found the terminal record (announce loss on the
                        # latency path; see --wait-safety-poll-s)
                        ctx.m_safety_poll.inc()
                    _note_terminal_delivery(
                        ctx, task_id, status, "store", loop
                    )
                return web.json_response(
                    {"task_id": task_id, "status": status, "result": result}
                )
            pause = min(poll_s, max(0.0, deadline - loop.time()))
            if waiter is not None:
                try:
                    await asyncio.wait_for(waiter.event.wait(), timeout=pause)
                    woke_by_poll = False
                except asyncio.TimeoutError:
                    woke_by_poll = True
            else:
                await asyncio.sleep(pause)
            poll_s = min(poll_s * 1.5, poll_cap)
    finally:
        if waiter is not None and waiters is not None:
            waiters.release(task_id, waiter)


async def _note_observed(
    ctx: "GatewayContext",
    task_id: str,
    status: str,
    observed_at: float,
    source: str | None = None,
) -> None:
    """First terminal /result delivery: feed the e2e latency histograms
    and the ``observe`` span (the poll-gap segment no dispatcher-local
    view can see). Runs as a FIRE-AND-FORGET task scheduled after the
    reply, with ``observed_at`` stamped reply-side — the extra field
    fetch must neither delay the delivery it measures nor inflate the
    submit_to_observe phase by its own round trip. Never allowed to fail
    anything (telemetry degrades, replies don't); the dedup set makes a
    burst of concurrent first polls observe once."""
    if task_id in ctx._observed:
        return
    try:
        submitted, finished, trace_id, slo_class, priority = (
            await ctx.store_call(
                ctx.store.hmget,
                task_id,
                [
                    FIELD_SUBMITTED_AT,
                    FIELD_FINISHED_AT,
                    FIELD_TRACE_ID,
                    FIELD_SLO_CLASS,
                    FIELD_PRIORITY,
                ],
            )
        )
    except Exception:
        return
    fields: dict = {FIELD_STATUS: status}
    if submitted is not None:
        fields[FIELD_SUBMITTED_AT] = submitted
    if finished is not None:
        fields[FIELD_FINISHED_AT] = finished
    if trace_id is not None:
        fields[FIELD_TRACE_ID] = trace_id
    if slo_class is not None:
        fields[FIELD_SLO_CLASS] = slo_class
    if priority is not None:
        fields[FIELD_PRIORITY] = priority
    ctx.note_result_observed(task_id, fields, observed_at, source=source)


#: /results/wait and /events accept at most this many task ids per call:
#: each probe round is a pipelined read over the still-pending slice, and
#: an unbounded list would let one request park unbounded store work.
_WAIT_MANY_CAP = 1024


class _ResultWatch:
    """The multiplexed waiter behind POST /results/wait and GET /events:
    ONE parked request watching many task ids, woken by any of their
    terminal announces (express inline payloads served without a store
    re-read), with the same coarse safety re-read as the single-id
    long-poll. Probe rounds are two pipelined reads over the still-pending
    slice (statuses, then results for the newly-terminal) — never a round
    trip per id."""

    def __init__(self, ctx: "GatewayContext", ids: list[str], wait_s: float):
        self.ctx = ctx
        self.ids = ids
        self.loop = asyncio.get_running_loop()
        self.deadline = self.loop.time() + wait_s
        self.pending: set[str] = set(ids)
        #: ids the LAST store probe found no record for; exposed through
        #: the ``unknown`` property, which re-filters against ``pending``
        #: so an id delivered from an inline forward AFTER the probe can
        #: never be reported unknown and delivered in the same reply
        self._unknown: set[str] = set()
        self.waiter = (
            ctx.waiters.acquire_many(ids)
            if ctx.waiters is not None and wait_s > 0
            else None
        )
        self.poll_cap = (
            ctx.wait_safety_poll_s
            if self.waiter is not None
            else _WAIT_POLL_MAX_S
        )
        self.poll_s = (
            self.poll_cap if self.waiter is not None else _WAIT_POLL_S
        )
        #: the last park timed out (safety re-read) instead of an
        #: announce wake — store-sourced deliveries then count into
        #: safety_poll_served_total
        self._woke_by_poll = False

    async def collect(self) -> list[tuple[str, str, str, str]]:
        """Newly-terminal (task_id, status, result, source) since the last
        call: the waiter's inline forwards first (no store traffic), then
        one pipelined status probe + one result fetch over whatever is
        still pending. Ids with no record are reported in ``unknown`` (a
        mid-create id may appear on a later probe; they never block the
        reply)."""
        out: list[tuple[str, str, str, str]] = []
        if self.waiter is not None:
            self.waiter.event.clear()
            for tid in list(self.pending):
                inline = self.waiter.inline.get(tid)
                if inline is not None:
                    self.pending.discard(tid)
                    out.append((tid, inline[0], inline[1], "inline"))
        if self.pending:
            remaining = [t for t in self.ids if t in self.pending]
            statuses = await self.ctx.store_call(
                self.ctx.store.hget_many, remaining, FIELD_STATUS
            )
            self._unknown = {
                t for t, s in zip(remaining, statuses) if s is None
            }
            term: list[tuple[str, str]] = []
            for tid, status in zip(remaining, statuses):
                if status is None or not isinstance(status, str):
                    continue
                try:
                    is_term = TaskStatus(status).is_terminal()
                except ValueError:
                    is_term = True  # foreign status: deliver, don't hang
                if is_term:
                    term.append((tid, status))
            if term:
                results = await self.ctx.store_call(
                    self.ctx.store.hget_many,
                    [t for t, _ in term],
                    FIELD_RESULT,
                )
                for (tid, status), result in zip(term, results):
                    self.pending.discard(tid)
                    body = result if isinstance(result, str) else ""
                    if not body:
                        # digest-form record (result-blob plane) or a
                        # genuinely empty body — _materialize_result tells
                        # them apart; an unrecoverable blob delivers ""
                        # (the multiplexed reply has no per-id 410 lane;
                        # /result on the same id reports the 410)
                        body, _ok = await _materialize_result(
                            self.ctx, tid, status, body
                        )
                        body = body or ""
                    out.append((tid, status, body, "store"))
        for tid, status, _result, source in out:
            if (
                source == "store"
                and self.waiter is not None
                and self._woke_by_poll
            ):
                self.ctx.m_safety_poll.inc()
            _note_terminal_delivery(self.ctx, tid, status, source, self.loop)
        return out

    @property
    def exhausted(self) -> bool:
        return (
            not self.pending
            or self.loop.time() >= self.deadline
            or self.ctx.stopping.is_set()
        )

    async def park(self) -> None:
        """Sleep until an announce wake or the next safety re-read."""
        pause = min(self.poll_s, max(0.0, self.deadline - self.loop.time()))
        if self.waiter is not None:
            self._woke_by_poll = True
            with contextlib.suppress(asyncio.TimeoutError):
                await asyncio.wait_for(self.waiter.event.wait(), timeout=pause)
                self._woke_by_poll = False
        else:
            await asyncio.sleep(pause)
        self.poll_s = min(self.poll_s * 1.5, self.poll_cap)

    @property
    def unknown(self) -> list[str]:
        """Ids with no record as of the last probe that are ALSO still
        undelivered, input order — an inline forward landing after the
        probe removes its id from pending, and with it from here."""
        return [
            t for t in self.ids if t in self._unknown and t in self.pending
        ]

    def pending_ids(self) -> list[str]:
        """Still-live ids in input order (unknown ids excluded — they are
        reported separately)."""
        unknown = self._unknown
        return [
            t for t in self.ids if t in self.pending and t not in unknown
        ]

    def close(self) -> None:
        if self.waiter is not None and self.ctx.waiters is not None:
            self.ctx.waiters.release_many(self.ids, self.waiter)


def _parse_wait_ids(task_ids, wait_raw):
    """Shared validation for the multiplexed wait surfaces: returns
    (ids, wait_s) or raises ValueError with the client-facing message."""
    if (
        not isinstance(task_ids, list)
        or not task_ids
        or not all(isinstance(t, str) and t for t in task_ids)
    ):
        raise ValueError("'task_ids' must be a non-empty list of strings")
    if len(task_ids) > _WAIT_MANY_CAP:
        raise ValueError(
            f"at most {_WAIT_MANY_CAP} task_ids per wait; split the call"
        )
    try:
        wait_s = float(wait_raw or 0)
    except (TypeError, ValueError):
        wait_s = math.nan
    if not (0.0 <= wait_s):  # rejects NaN
        raise ValueError("'wait' must be a non-negative number")
    # dedup preserving order: one id parked once, results keyed by id
    return list(dict.fromkeys(task_ids)), min(wait_s, _MAX_WAIT_S)


async def wait_results(request: web.Request) -> web.Response:
    """``POST /results/wait`` — the multiplexed long-poll: many task ids,
    ONE parked request. Body ``{"task_ids": [...], "wait": N}``. Replies
    as soon as at least one watched task is terminal (immediately, if any
    already are — the wait=0 immediate-reply contract holds per id), else
    when the wait lapses. Reply: ``{"results": {task_id: {"status",
    "result"}}, "pending": [...], "unknown": [...]}`` — unknown ids (no
    record; possibly mid-create) are reported, never 404 the whole call,
    and stay watched until the deadline in case their create lands.
    Batch-submitting clients replace N serial per-id long-polls (the
    run_many wait loop) with one parked request per wave."""
    ctx: GatewayContext = request.app[CTX_KEY]
    try:
        body = await request.json()
        raw_ids = body["task_ids"]
    except Exception:
        return _json_error(400, "expected JSON body with a 'task_ids' list")
    try:
        ids, wait_s = _parse_wait_ids(raw_ids, body.get("wait", 0))
    except ValueError as exc:
        return _json_error(400, str(exc))
    for tid in ids:
        ctx.note_shard_route(tid)
    watch = _ResultWatch(ctx, ids, wait_s)
    results: dict[str, dict] = {}
    try:
        while True:
            for tid, status, result, _source in await watch.collect():
                results[tid] = {"status": status, "result": result}
            if results or watch.exhausted:
                break
            await watch.park()
    finally:
        watch.close()
    return web.json_response(
        {
            "results": results,
            "pending": watch.pending_ids(),
            "unknown": watch.unknown,
        }
    )


async def events_stream(request: web.Request) -> web.StreamResponse:
    """``GET /events?task_ids=a,b,c&wait=N`` — Server-Sent Events over the
    same waiter plane: one ``event: result`` frame per terminal task as it
    lands (express inline payloads stream with no store re-read), closed
    by an ``event: done`` frame carrying whatever is still pending/unknown
    when every watched task is terminal or the wait cap lapses (clients
    reconnect with the remainder; the cap bounds handler lifetime exactly
    like the long-poll's). A store outage mid-stream degrades to the done
    frame with an ``error`` field — headers are already on the wire, so a
    503 is no longer possible."""
    import json as _json

    ctx: GatewayContext = request.app[CTX_KEY]
    raw_ids = [t for t in request.query.get("task_ids", "").split(",") if t]
    try:
        ids, wait_s = _parse_wait_ids(
            raw_ids, request.query.get("wait", _MAX_WAIT_S)
        )
    except ValueError as exc:
        return _json_error(400, str(exc))
    for tid in ids:
        ctx.note_shard_route(tid)
    resp = web.StreamResponse(
        headers={
            "Content-Type": "text/event-stream",
            "Cache-Control": "no-store",
            "Connection": "keep-alive",
        }
    )
    await resp.prepare(request)

    async def send(event: str, data: dict) -> None:
        await resp.write(
            f"event: {event}\ndata: {_json.dumps(data)}\n\n".encode()
        )

    watch = _ResultWatch(ctx, ids, wait_s)
    error = ""
    try:
        while True:
            try:
                ready = await watch.collect()
            except StoreUnavailable:
                error = "store_unavailable"
                break
            for tid, status, result, source in ready:
                await send(
                    "result",
                    {
                        "task_id": tid,
                        "status": status,
                        "result": result,
                        "source": source,
                    },
                )
            if watch.exhausted:
                break
            await watch.park()
    except (ConnectionResetError, asyncio.CancelledError):
        raise  # client went away: nothing to finalize on the wire
    finally:
        watch.close()
    done: dict = {
        "pending": watch.pending_ids(),
        "unknown": watch.unknown,
    }
    if error:
        done["error"] = error
    with contextlib.suppress(ConnectionResetError):
        await send("done", done)
        await resp.write_eof()
    return resp


async def cancel_task(request: web.Request) -> web.Response:
    """Best-effort cancellation (beyond the reference surface; the
    reference can only let a submitted task run). QUEUED -> CANCELLED
    (terminal); a RUNNING task is refused with 409 by default — it keeps
    its worker and completes normally; cancelling an already-terminal task
    is an idempotent no-op reporting the terminal status. The store-level
    protocol (conditional write + dispatcher eviction via the announce
    bus + the one benign race) is documented at store/base.py cancel_task.

    Optional JSON body ``{"force": true}``: a RUNNING task is ASKED to
    stop — the owning dispatcher relays a CANCEL to its worker, which
    interrupts the task mid-run (worker/pool.py force-cancel) and ships a
    terminal CANCELLED result. Asynchronous and best-effort by nature
    (the task may finish first, or be C code that never yields): the
    response is 202 with ``kill_requested`` and the record converges via
    the ordinary result path — poll /status."""
    ctx: GatewayContext = request.app[CTX_KEY]
    task_id = request.match_info["task_id"]
    force = False
    if request.can_read_body:
        try:
            raw_force = (await request.json()).get("force", False)
        except Exception:
            return _json_error(400, "body, when present, must be JSON")
        # strict JSON boolean: truthiness would read {"force": "false"}
        # as a request to interrupt a running task — a destructive action
        # must never hinge on a string's non-emptiness
        if not isinstance(raw_force, bool):
            return _json_error(400, "'force' must be a JSON boolean")
        force = raw_force
    status = await ctx.store_call(ctx.store.cancel_task, task_id, ctx.channel)
    if status is None:
        # no status field: either a genuinely unknown id, or a record
        # MID-CREATE (idempotency path: claim field written, payloads and
        # status still in flight). The latter's id was just handed to its
        # submitter, so a 404 would be a lie — answer 409 "not yet
        # cancellable" (the SDK maps 409 to False, not an HTTPError) and
        # let the client retry once the create lands.
        claim = await ctx.store_call(
            ctx.store.hget, task_id, _IDEM_CLAIM_FIELD
        )
        if claim is not None:
            return _json_error(
                409,
                f"task {task_id!r} is still being created and not yet "
                "cancellable; retry",
            )
        return _json_error(404, f"unknown task_id {task_id!r}")
    kill_requested = False
    if force and status in (
        str(TaskStatus.RUNNING), str(TaskStatus.CANCELLED)
    ):
        # publish the kill for CANCELLED too, not just RUNNING: the
        # conditional cancel write can WIN while a concurrent dispatch
        # also wins (the documented lost race) — the record reads
        # CANCELLED but the task is executing, and without a kill it
        # would run its full natural length despite an explicit force
        # request. For a genuinely-queued cancel the note simply finds no
        # in-flight owner and ages out.
        await ctx.store_call(ctx.store.request_kill, task_id, ctx.channel)
        kill_requested = True
    if status == str(TaskStatus.RUNNING):
        if not force:
            return _json_error(
                409, f"task {task_id!r} is RUNNING and cannot be cancelled"
            )
        return web.json_response(
            {
                "task_id": task_id,
                "status": status,
                "cancelled": False,
                "kill_requested": True,
            },
            status=202,
        )
    cancelled = status == str(TaskStatus.CANCELLED)
    if cancelled:
        ctx.n_cancelled += 1
        ctx.m_cancel_calls.inc()
    body = {"task_id": task_id, "status": status, "cancelled": cancelled}
    if force:
        body["kill_requested"] = kill_requested
    return web.json_response(body)


async def delete_task(request: web.Request) -> web.Response:
    """Drop a finished task's record (result + payloads). Beyond the
    reference's surface (its store grows until FLUSHDB): clients that have
    consumed a result can free the store, which also keeps the dispatcher's
    stranded-task rescans proportional to LIVE work. Deleting a QUEUED or
    RUNNING task is refused — the dispatcher still owns it."""
    ctx: GatewayContext = request.app[CTX_KEY]
    task_id = request.match_info["task_id"]
    status = await ctx.store_call(ctx.store.get_status, task_id)
    if status is None:
        return _json_error(404, f"unknown task_id {task_id!r}")
    if not TaskStatus(status).is_terminal():
        return _json_error(409, f"task {task_id!r} is {status}, not terminal")
    await ctx.store_call(ctx.store.delete, task_id)
    return web.json_response({"task_id": task_id, "deleted": True})


async def healthz(request: web.Request) -> web.Response:
    return web.json_response({"ok": True})


def _safe_ping(store: TaskStore) -> bool:
    try:
        return bool(store.ping())
    except Exception:
        return False


#: INFO "role" string -> the role gauge's encoding (see m_store_role)
_ROLE_GAUGE = {"primary": 1.0, "replica": 0.0, "fenced": -1.0}


def _safe_store_ha(store: TaskStore) -> tuple[str | None, float | None]:
    """(role, replication_lag) from the store's INFO introspection, both
    None when the backend has no HA surface (MemoryStore, plain Redis)
    or the store is unreachable. Blocking — call off-loop."""
    info_fn = getattr(store, "info", None)
    if info_fn is None:
        return None, None
    try:
        info = info_fn()
    except Exception:
        return None, None
    role = info.get("role")
    lag: float | None = None
    try:
        lag = float(info["repl_lag"])
    except (KeyError, ValueError):
        pass
    return role, lag


async def readyz(request: web.Request) -> web.Response:
    """Readiness (vs /healthz's liveness): 503 while this gateway cannot
    usefully serve — store breaker open/half-open, store unreachable, or
    the store client settled on a non-writable replica/fenced endpoint.
    Orchestration probes route traffic on THIS endpoint and keep /healthz
    for restarts: a degraded gateway must be drained, not killed."""
    ctx: GatewayContext = request.app[CTX_KEY]
    ready, reason = True, "ok"
    if ctx.breaker is not None and ctx.breaker.state != "closed":
        ready, reason = False, f"store_breaker_{ctx.breaker.state}"
    elif not await _run_blocking(_safe_ping, ctx.store):
        ready, reason = False, "store_unreachable"
    else:
        role, _lag = await _run_blocking(_safe_store_ha, ctx.store)
        if role in ("replica", "fenced"):
            ready, reason = False, f"store_role_{role}"
    return web.json_response(
        {"ready": ready, "reason": reason}, status=200 if ready else 503
    )


async def slo(request: web.Request) -> web.Response:
    """Per-objective multi-window burn rates over the gateway's e2e
    latency histograms (obs/slo.py) — the JSON twin of the
    ``tpu_faas_slo_*`` gauges on /metrics."""
    ctx: GatewayContext = request.app[CTX_KEY]
    return web.json_response(await _run_blocking(ctx.slo.snapshot))


async def flightrec(request: web.Request) -> web.Response:
    """The flight recorder's event ring as JSON (obs/flightrec.py):
    ``?since=N`` returns only events newer than cursor N (pass the last
    reply's ``cursor`` back to poll incrementally), ``?limit=K`` keeps
    the NEWEST K. Pure in-memory read — no store traffic."""
    ctx: GatewayContext = request.app[CTX_KEY]
    try:
        since = int(request.query.get("since", 0) or 0)
        limit = int(request.query.get("limit", 0) or 0)
    except ValueError:
        return _json_error(400, "'since' and 'limit' must be integers")
    return web.json_response(ctx.flightrec.snapshot(since=since, limit=limit))


async def trace_task(request: web.Request) -> web.Response:
    """The assembled CROSS-PROCESS timeline of one task: gateway admit/
    create/observe spans, dispatcher intake-to-finalize spans, and the
    worker's exec window, merged from the store's span plane
    (obs/tracectx.py assemble_timeline). Works store-wide — any gateway
    can assemble any task's trace, unlike the dispatcher's /trace which
    only knows tasks it dispatched. Tasks without a trace id (tracing
    off, legacy producers) resolve with zero spans rather than 404ing."""
    ctx: GatewayContext = request.app[CTX_KEY]
    task_id = request.match_info["task_id"]
    ctx.note_shard_route(task_id)
    timeline = await ctx.store_call(assemble_timeline, ctx.store, task_id)
    if timeline is None:
        return _json_error(404, f"unknown task_id {task_id!r}")
    return web.json_response(timeline)


async def metrics(request: web.Request) -> web.Response:
    """Prometheus text exposition: the gateway's private registry (request
    counts + latency histograms per route, submission counters, store
    reachability, uptime) concatenated with the process-global registry
    (store round trips). The scrape path; the JSON twin lives at /stats."""
    ctx: GatewayContext = request.app[CTX_KEY]
    ctx.m_store_up.set(1.0 if await _run_blocking(_safe_ping, ctx.store) else 0.0)
    role, lag = await _run_blocking(_safe_store_ha, ctx.store)
    ctx.m_store_role.set(_ROLE_GAUGE.get(role, -2.0))
    if lag is not None:
        ctx.m_repl_lag.set(lag)
    body = await _run_blocking(obs_metrics.render, [ctx.metrics, REGISTRY])
    # the shared CONTENT_TYPE constant (version=0.0.4 included), same as
    # the dispatcher's scrape surface — one format, advertised once
    return web.Response(
        body=body.encode("utf-8"),
        headers={"Content-Type": obs_metrics.CONTENT_TYPE},
    )


async def stats(request: web.Request) -> web.Response:
    """JSON observability snapshot: the same counters as /metrics plus the
    tracer ring's exact recent-window latency percentiles."""
    ctx: GatewayContext = request.app[CTX_KEY]
    store_ok = await _run_blocking(_safe_ping, ctx.store)
    store_role, _lag = await _run_blocking(_safe_store_ha, ctx.store)
    return web.json_response(
        {
            "uptime_s": round(time.time() - ctx.started_at, 1),
            # replication role of the endpoint this gateway's store client
            # settled on (None = backend without HA introspection); the
            # promotion runbook's "is the fleet pointed at the primary?"
            # probe
            "store_role": store_role,
            # sharded control plane: shard count (0 = single store) —
            # every gateway is stateless over the ring, so any of them
            # reports the same topology
            "store_shards": getattr(ctx.store, "shard_count", 0) or 0,
            "functions_registered": ctx.n_functions,
            "tasks_submitted": ctx.n_tasks,
            # overload surfaces: admission controller + store breaker
            "admission": (
                None if ctx.admission is None else ctx.admission.snapshot()
            ),
            "store_breaker": (
                None if ctx.breaker is None else ctx.breaker.snapshot()
            ),
            # cancel CALLS that reported cancelled=true — an idempotent
            # repeat on an already-CANCELLED task counts again (the store
            # protocol cannot distinguish transitioned-now from
            # already-cancelled without an extra read; call-count is the
            # honest cheap metric)
            "cancel_calls": ctx.n_cancelled,
            "payload_plane": ctx.payload_plane,
            "store_ok": store_ok,
            "requests": {
                name: {
                    "count": ctx.route_counts.get(name, 0),
                    "latency": {
                        k: round(v, 6)
                        for k, v in stats.items()
                        if k != "count"  # ring-bounded; the monotonic
                        # counter above is the true total
                    },
                }
                for name, stats in ctx.tracer.summary().items()
            },
        }
    )


# -- serving ----------------------------------------------------------------


@dataclass
class GatewayHandle:
    host: str
    port: int
    thread: threading.Thread
    _loop: asyncio.AbstractEventLoop
    _stop: asyncio.Event

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def stop(self) -> None:
        self._loop.call_soon_threadsafe(self._stop.set)
        self.thread.join(timeout=10)


def start_gateway_thread(
    store: TaskStore,
    host: str = "127.0.0.1",
    port: int = 0,
    channel: str = TASKS_CHANNEL,
    result_ttl: float | None = None,
    admission: "AdmissionController | None | bool" = True,
    breaker: "CircuitBreaker | None | bool" = True,
    payload_plane: bool = False,
    trace: bool = False,
    wait_safety_poll_s: float = _WAIT_POLL_MAX_S_DEFAULT,
) -> GatewayHandle:
    """Serve the gateway in a daemon thread; returns once the port is bound."""
    started = threading.Event()
    holder: dict[str, object] = {}

    def run() -> None:
        loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)
        stop = asyncio.Event()
        holder["loop"], holder["stop"] = loop, stop

        async def main() -> None:
            runner = web.AppRunner(
                make_app(
                    store,
                    channel,
                    result_ttl,
                    admission=admission,
                    breaker=breaker,
                    payload_plane=payload_plane,
                    trace=trace,
                    wait_safety_poll_s=wait_safety_poll_s,
                )
            )
            await runner.setup()
            site = web.TCPSite(runner, host, port)
            await site.start()
            holder["port"] = runner.addresses[0][1]
            started.set()
            await stop.wait()
            await runner.cleanup()

        loop.run_until_complete(main())
        loop.close()

    thread = threading.Thread(target=run, name="tpu-faas-gateway", daemon=True)
    thread.start()
    if not started.wait(timeout=10):
        raise RuntimeError("gateway failed to start")
    return GatewayHandle(
        host=host,
        port=holder["port"],  # type: ignore[arg-type]
        thread=thread,
        _loop=holder["loop"],  # type: ignore[arg-type]
        _stop=holder["stop"],  # type: ignore[arg-type]
    )


def main(argv: list[str] | None = None) -> None:
    from tpu_faas_torch.utils.config import Config

    cfg = Config.load()
    ap = argparse.ArgumentParser(description="tpu-faas REST gateway")
    ap.add_argument("--host", default=cfg.gateway_host)
    ap.add_argument("--port", type=int, default=cfg.gateway_port)
    ap.add_argument("--store", default=cfg.store_url)
    ap.add_argument(
        "--result-ttl", type=float, default=None,
        help="seconds to keep terminal task records before the sweeper "
        "deletes them (default: keep forever, the reference behavior)",
    )
    ap.add_argument(
        "--max-system-inflight", type=int, default=None,
        help="hard bound on tasks in the system before submits 429 "
        "(default: derived from the fleet's published capacity; with no "
        "publishing dispatcher either, the bound is off)",
    )
    ap.add_argument(
        "--client-quota", default=None, metavar="RATE[:BURST]",
        help="per-client token-bucket quota keyed on the X-Client-Id "
        "header, in tasks/second (burst defaults to 2x rate); off unless "
        "set",
    )
    ap.add_argument(
        "--no-admission", action="store_true",
        help="disable the admission controller AND the store circuit "
        "breaker (the pre-overload-hardening behavior)",
    )
    ap.add_argument(
        "--payload-plane", action="store_true",
        help="content-addressed function shipping: task records carry a "
        "digest (body written once under blob:<sha256>) instead of an "
        "inline copy per task. Requires every dispatcher on this store "
        "to be payload-plane-aware; leave off while reference-style "
        "dispatchers read the store",
    )
    ap.add_argument(
        "--trace", action="store_true",
        help="distributed tracing: every submit carries a trace id "
        "(client-minted or minted here), every hop emits span records "
        "into the store's trace: namespace, and /trace/<task_id> "
        "assembles the cross-process timeline. Off by default — "
        "single-process and reference-era setups run unchanged",
    )
    ap.add_argument(
        "--wait-safety-poll-s", type=float,
        default=_WAIT_POLL_MAX_S_DEFAULT, metavar="S",
        help="ceiling of the parked long-poll SAFETY store re-read "
        "cadence while the announce-wake plane is armed (default 2.0). "
        "The re-read only insures against announce loss; replies it "
        "serves are counted in "
        "tpu_faas_gateway_safety_poll_served_total so latency runs can "
        "attribute — and by raising this — tune away the poll floor",
    )
    ns = ap.parse_args(argv)
    store = make_store(ns.store)
    if ns.no_admission:
        admission: AdmissionController | bool = False
        breaker = False
    else:
        quota_rate = quota_burst = None
        if ns.client_quota:
            rate_s, _, burst_s = ns.client_quota.partition(":")
            quota_rate = float(rate_s)
            quota_burst = float(burst_s) if burst_s else None
        admission = AdmissionController(
            AdmissionConfig(
                max_system_inflight=ns.max_system_inflight,
                quota_rate=quota_rate,
                quota_burst=quota_burst,
            )
        )
        breaker = True
    log.info("gateway on %s:%d (store %s)", ns.host, ns.port, ns.store)
    app = make_app(
        store,
        result_ttl=ns.result_ttl,
        admission=admission,
        breaker=breaker,
        payload_plane=ns.payload_plane,
        trace=ns.trace,
        wait_safety_poll_s=ns.wait_safety_poll_s,
    )
    ctx = app[CTX_KEY]

    async def _dump_flightrec(_app: web.Application) -> None:
        # SIGTERM lands here via aiohttp's graceful-exit path (run_app
        # owns the signal handlers): the ring's last seconds go to the
        # log before the process dies — CLI serve only, so embedded/test
        # gateways shut down quietly
        log.warning(
            "flightrec shutdown dump: %s", ctx.flightrec.dump_json()
        )

    app.on_shutdown.append(_dump_flightrec)
    web.run_app(app, host=ns.host, port=ns.port, print=None)


if __name__ == "__main__":
    main()
