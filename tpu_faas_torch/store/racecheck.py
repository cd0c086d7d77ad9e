"""Protocol race detector for the task lifecycle.

The reference has no race detection; its safety is "by construction" —
single-threaded event loops plus message passing (SURVEY §5.2). That argument
broke the moment this framework added what the reference lacks: re-dispatch of
in-flight tasks from purged workers. Now two agents can race on one task
record (the zombie worker's late result vs the replacement's result), and the
gateway and dispatcher write the same hashes from different processes.

This module makes the implicit protocol checkable:

- :class:`RaceMonitor` owns the task-lifecycle state machine
  (QUEUED -> RUNNING -> COMPLETED | FAILED) plus the re-dispatch extension
  (RUNNING -> RUNNING is legal only when declared), validates every observed
  write online, and collects :class:`Violation` records instead of raising —
  a detector, not an enforcer.
- :class:`RaceCheckStore` wraps any :class:`TaskStore` and feeds every write
  through a shared monitor. Wrap each agent's handle with its own ``actor``
  label and violations name who raced with whom.
- :func:`check_trace` replays a recorded event list through a fresh monitor
  for offline/post-mortem analysis.

Used by the test suite (wrap the store, run a full E2E stack, assert no
errors) and available in production at ~one dict update per store write.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Iterable, Mapping

from tpu_faas_torch.admission.signal import FLEET_HEALTH_KEY
from tpu_faas_torch.core.payload import payload_digest
from tpu_faas_torch.core.task import FIELD_RESULT, FIELD_STATUS, TaskStatus
from tpu_faas_torch.obs.tracectx import TRACE_PREFIX
from tpu_faas_torch.store.base import (
    BLOB_DATA_FIELD,
    BLOB_PREFIX,
    LIVE_INDEX_KEY,
    TASKS_CHANNEL,
    Subscription,
    TaskStore,
)

#: Legal status transitions. ``None`` is "task does not exist yet".
#: RUNNING -> RUNNING appears here because re-dispatch re-marks a task on its
#: replacement worker; the monitor still flags it unless the dispatcher
#: declared the re-dispatch (see RaceMonitor.expect_redispatch).
_LEGAL: frozenset[tuple[str | None, str]] = frozenset(
    {
        (None, "QUEUED"),
        ("QUEUED", "QUEUED"),  # idempotent gateway retry
        ("QUEUED", "RUNNING"),
        ("RUNNING", "RUNNING"),
        ("RUNNING", "COMPLETED"),
        ("RUNNING", "FAILED"),
        # QUEUED -> terminal: legal but suspicious (result without dispatch);
        # reported as a warning, see _transition_kind.
        ("QUEUED", "COMPLETED"),
        ("QUEUED", "FAILED"),
        # queued-only cancellation (gateway POST /cancel, store cancel_task)
        ("QUEUED", "CANCELLED"),
        # the cancel's conditional write racing a concurrent RUNNING mark:
        # lawful per the protocol (the task runs; its result overwrites the
        # stale CANCELLED later) but worth surfacing — warning, see
        # _check_transition
        ("RUNNING", "CANCELLED"),
        # queue-deadline shedding (store expire_task, dispatcher-side):
        # deliberately from QUEUED ONLY — a RUNNING -> EXPIRED write is an
        # illegal-transition error, which is how the monitor proves "shed
        # never touches a dispatched task" at runtime
        ("QUEUED", "EXPIRED"),
        # -- task graphs (tpu_faas/graph, store complete_dep_many) ---------
        # a graph node created behind its dependencies (gateway
        # /execute_graph); deliberately NO ("WAITING", "RUNNING") entry —
        # that transition being illegal is how the monitor proves at
        # runtime that no WAITING node ever reaches a worker
        (None, "WAITING"),
        # promotion: the last parent COMPLETED and the pending count hit
        # zero (single writer by the FIELD_DEP_RESOLVED claim)
        ("WAITING", "QUEUED"),
        # poison: a parent reached FAILED/EXPIRED/CANCELLED, so the node
        # (and transitively its own frontier) fails without dispatching
        ("WAITING", "FAILED"),
    }
)

#: Terminal statuses that assert the task NEVER RAN. A write of one over
#: the other (cancel racing a deadline shed) is a warning, not an error:
#: both agree on the only fact a client can act on.
_NEVER_RAN = frozenset({"CANCELLED", "EXPIRED"})


@dataclass(frozen=True)
class Event:
    """One observed store write, in global observation order."""

    seq: int
    time: float
    actor: str
    op: str  # create | status | finish | delete | flush
    task_id: str
    from_status: str | None
    #: status carried by this write; None means the write had no status field
    to_status: str | None
    #: result payload accompanying a terminal write (None otherwise)
    result: str | None = None


@dataclass(frozen=True)
class Violation:
    kind: str
    severity: str  # "error" | "warning"
    task_id: str
    detail: str
    events: tuple[Event, ...] = ()

    def __str__(self) -> str:
        return f"[{self.severity}] {self.kind} on {self.task_id}: {self.detail}"


def _is_terminal(status: str | None) -> bool:
    """Terminal check that tolerates non-enum garbage: the monitor is a
    detector, not an enforcer — a corrupt status string must be FLAGGED
    (illegal-transition fires via the _LEGAL table), never crash observe().
    unknown=False: garbage is 'not terminal' here so the transition table
    gets to see and flag it."""
    return TaskStatus.terminal_str(status)


@dataclass
class _TaskState:
    status: str | None = None
    result: str | None = None
    last_writer: str = "?"
    last_event: Event | None = None
    redispatch_credits: int = 0
    #: a force-cancel (!kill) was requested for this task — a worker's
    #: result-bearing CANCELLED write is lawful only with this set
    kill_requested: bool = False
    #: a hedge replica was declared (speculation plane): the loser's
    #: CANCELLED-after-winner-terminal write is the expected kill
    #: confirmation (warning with hedge attribution, never an error);
    #: double-COMPLETION with a different result stays a terminal-
    #: overwrite ERROR — that is what "first-wins held" means at runtime
    replica_declared: bool = False


class RaceMonitor:
    """Thread-safe online checker of the task-lifecycle protocol.

    Error kinds
    -----------
    - ``terminal-overwrite`` — a write changed a terminal status or replaced
      a terminal result with a different value (the zombie-vs-replacement
      race; ``finish_task(first_wins=True)`` exists to prevent exactly this).
    - ``illegal-transition`` — any transition outside the state machine
      (e.g. COMPLETED -> RUNNING).

    Warning kinds
    -------------
    - ``double-dispatch`` — RUNNING -> RUNNING without a declared re-dispatch:
      two workers may hold the same task.
    - ``result-without-dispatch`` — terminal write on a task never marked
      RUNNING.
    - ``unknown-task`` — write to a task id with no observed create (only
      with ``strict=True``; otherwise the task is adopted silently, since a
      checker attached mid-run legitimately misses earlier creates).
    - ``cancel-after-dispatch`` / ``cancel-after-finish`` /
      ``late-cancel-race`` — the lawful interleavings of the queued-only
      cancel's conditional write racing a concurrent dispatch
      (store/base.py cancel_task): CANCELLED lands over RUNNING, CANCELLED
      transiently clobbers a just-landed terminal record (repaired from
      the final_status stamp), and the true status lands over the stale
      CANCELLED.
    """

    def __init__(self, *, strict: bool = False, max_events: int = 100_000) -> None:
        self._lock = threading.Lock()
        self._seq = itertools.count()
        self._tasks: dict[str, _TaskState] = {}
        #: blob namespace state: digest -> sha256 fingerprint of the FIRST
        #: observed data write (fingerprint, not the bytes: payloads can
        #: be multi-MB and the monitor must stay cheap)
        self._blobs: dict[str, str] = {}
        self._strict = strict
        self.events: deque[Event] = deque(maxlen=max_events)
        self.violations: list[Violation] = []

    # -- blob namespace (payload plane) ------------------------------------
    def observe_blob_write(self, actor: str, key: str, data: str) -> None:
        """Validate a write touching a blob's data field. Two invariants,
        both errors when broken:

        - ``blob-digest-mismatch`` — the bytes do not hash to the key's
          digest: a consumer resolving this digest would execute the
          wrong function (content addressing's one load-bearing promise);
        - ``blob-overwrite`` — a second data write carries DIFFERENT
          bytes than the first: blobs are create-once, and put_blob's
          setnx makes this impossible through the API — seeing it means
          some writer bypassed it.
        """
        digest = key[len(BLOB_PREFIX):]
        fp = payload_digest(data)
        with self._lock:
            if fp != digest:
                self._flag(
                    "blob-digest-mismatch",
                    "error",
                    key,
                    f"{actor} wrote bytes hashing to {fp[:16]}... under "
                    f"digest {digest[:16]}...: resolvers of this digest "
                    f"would run the wrong function",
                )
            prev = self._blobs.setdefault(digest, fp)
            if prev != fp:
                self._flag(
                    "blob-overwrite",
                    "error",
                    key,
                    f"{actor} rewrote blob {digest[:16]}... with "
                    f"different bytes (blobs are create-once; put_blob's "
                    f"setnx was bypassed)",
                )

    # -- declarations ------------------------------------------------------
    def expect_force_cancel(self, task_id: str) -> None:
        """Declare a force-cancel request: the worker's eventual
        result-bearing CANCELLED write for this task is lawful. Fed by
        RaceCheckStore.request_kill."""
        with self._lock:
            self._state(task_id).kill_requested = True

    def expect_redispatch(self, task_id: str) -> None:
        """Declare that the next RUNNING -> RUNNING write on ``task_id`` is a
        deliberate re-dispatch (purged worker's task moved to a replacement),
        not a double-dispatch bug."""
        with self._lock:
            self._state(task_id).redispatch_credits += 1

    def expect_replica(self, task_id: str) -> None:
        """Declare a hedge replica (speculation plane, tpu_faas/spec): the
        next RUNNING -> RUNNING write is the replica's deliberate dispatch
        beside a still-running original (one redispatch credit), and the
        eventual loser's CANCELLED write over the winner's terminal record
        is the kill confirmation (hedge-loser warning, not an error). The
        monitor still proves no double-COMPLETION: a second terminal write
        carrying a DIFFERENT result stays a terminal-overwrite error —
        first_wins at the store is what keeps it from ever appearing."""
        with self._lock:
            state = self._state(task_id)
            state.redispatch_credits += 1
            state.replica_declared = True

    # -- observation -------------------------------------------------------
    def observe(
        self,
        actor: str,
        op: str,
        task_id: str,
        fields: Mapping[str, str] | None = None,
    ) -> Event:
        """Record one store write and validate it. Returns the event."""
        fields = fields or {}
        with self._lock:
            state = self._tasks.get(task_id)
            if state is None:
                if self._strict and op not in ("create", "flush"):
                    self._flag(
                        "unknown-task",
                        "warning",
                        task_id,
                        f"{actor} wrote {op} to a task never created",
                    )
                state = self._state(task_id)

            event = Event(
                seq=next(self._seq),
                time=time.time(),
                actor=actor,
                op=op,
                task_id=task_id,
                from_status=state.status,
                to_status=fields.get(FIELD_STATUS),
                result=fields.get(FIELD_RESULT),
            )
            self.events.append(event)

            if op == "delete":
                self._tasks.pop(task_id, None)
                return event
            if event.to_status is not None:
                self._check_transition(state, event)
                state.status = event.to_status
            if event.result is not None:
                state.result = event.result
            state.last_writer = actor
            state.last_event = event
            return event

    def observe_flush(self, actor: str) -> None:
        with self._lock:
            self.events.append(
                Event(next(self._seq), time.time(), actor, "flush", "*", None, None)
            )
            self._tasks.clear()
            self._blobs.clear()

    # -- queries -----------------------------------------------------------
    @property
    def errors(self) -> list[Violation]:
        return [v for v in self.violations if v.severity == "error"]

    @property
    def warnings(self) -> list[Violation]:
        return [v for v in self.violations if v.severity == "warning"]

    def unfinished(self) -> list[str]:
        """Task ids observed but not terminal — call after the run drains to
        detect lost tasks (the reference loses in-flight tasks on purge,
        SURVEY §5.3; this framework must not)."""
        with self._lock:
            # keys that never carried a status are not tasks (e.g. the
            # gateway's function-registry hashes share the store)
            return [
                tid
                for tid, s in self._tasks.items()
                if s.status is not None and not _is_terminal(s.status)
            ]

    def assert_clean(self, *, allow_warnings: bool = False) -> None:
        bad = self.violations if not allow_warnings else self.errors
        if bad:
            raise AssertionError(
                "race detector found:\n" + "\n".join(str(v) for v in bad)
            )

    # -- internals ---------------------------------------------------------
    def _state(self, task_id: str) -> _TaskState:
        return self._tasks.setdefault(task_id, _TaskState())

    def _flag(
        self,
        kind: str,
        severity: str,
        task_id: str,
        detail: str,
        events: tuple[Event, ...] = (),
    ) -> None:
        self.violations.append(Violation(kind, severity, task_id, detail, events))

    def _check_transition(self, state: _TaskState, event: Event) -> None:
        frm, to = state.status, event.to_status
        assert to is not None
        prior = (state.last_event,) if state.last_event else ()
        if _is_terminal(frm):
            same = frm == to and (
                event.result is None or event.result == state.result
            )
            if frm in _NEVER_RAN and to in (
                "RUNNING", "COMPLETED", "FAILED"
            ):
                # the one lawful terminal overwrite: a cancel/shed that
                # LOST its race against dispatch (store/base.py
                # cancel_task, expire_task) — the task ran anyway and
                # reality overwrites the stale record (includes the
                # writers' own post-write repairs restoring a clobbered
                # terminal status)
                self._flag(
                    "late-cancel-race",
                    "warning",
                    event.task_id,
                    f"{event.actor} wrote {to} over {frm}: the "
                    f"cancel/shed raced dispatch and lost; the task ran",
                    prior + (event,),
                )
                return
            if to in _NEVER_RAN and frm in ("COMPLETED", "FAILED"):
                if state.replica_declared and to == "CANCELLED":
                    # hedge loser reporting in after the winner's terminal
                    # write landed (speculation plane): the CANCEL kill
                    # confirmation for a declared replica — expected, and
                    # first_wins froze the record before this write could
                    # even be attempted through finish_task
                    self._flag(
                        "hedge-loser-cancelled",
                        "warning",
                        event.task_id,
                        f"{event.actor} wrote CANCELLED over terminal "
                        f"{frm} for a declared hedge replica: the loser's "
                        f"kill confirmation; the winner's record stands",
                        prior + (event,),
                    )
                    return
                # the sub-millisecond-task interleaving: the result landed
                # inside the cancel/shed's read->write window and its
                # write transiently clobbered it — lawful because the
                # writers' post-write repair (keyed on the redundant
                # final_status stamp) restores the record immediately
                self._flag(
                    "cancel-after-finish",
                    "warning",
                    event.task_id,
                    f"{event.actor} wrote {to} over terminal {frm}; "
                    f"the post-write repair restores it from final_status",
                    prior + (event,),
                )
                return
            if to in _NEVER_RAN and frm in _NEVER_RAN and frm != to:
                # cancel racing a deadline shed (or vice versa): both
                # writes assert the task never ran — whichever stands,
                # the record tells the client the truth
                self._flag(
                    "cancel-expire-race",
                    "warning",
                    event.task_id,
                    f"{event.actor} wrote {to} over {frm}: a cancel and "
                    f"a deadline shed raced; both mean the task never ran",
                    prior + (event,),
                )
                return
            if not same:
                self._flag(
                    "terminal-overwrite",
                    "error",
                    event.task_id,
                    f"{event.actor} wrote {to} over terminal {frm} "
                    f"(prev writer {state.last_writer})",
                    prior + (event,),
                )
            return
        if (frm, to) not in _LEGAL:
            self._flag(
                "illegal-transition",
                "error",
                event.task_id,
                f"{event.actor}: {frm} -> {to}",
                prior + (event,),
            )
            return
        if frm == "RUNNING" and to == "RUNNING":
            if state.redispatch_credits > 0:
                state.redispatch_credits -= 1
            else:
                self._flag(
                    "double-dispatch",
                    "warning",
                    event.task_id,
                    f"{event.actor} re-marked RUNNING without a declared "
                    f"re-dispatch (prev writer {state.last_writer})",
                    prior + (event,),
                )
        elif frm == "QUEUED" and to in ("COMPLETED", "FAILED"):
            self._flag(
                "result-without-dispatch",
                "warning",
                event.task_id,
                f"{event.actor} wrote {to} on a task never marked RUNNING",
                prior + (event,),
            )
        elif frm == "RUNNING" and to == "CANCELLED":
            if event.op == "finish":
                if state.kill_requested:
                    # result-bearing CANCELLED from the worker AFTER an
                    # observed !kill request: a FORCE cancel confirmed by
                    # the interrupt (worker/pool.py) — deliberate, lawful
                    return
                # a CANCELLED result nobody asked for: a stray signal or a
                # misfire-repair bug shipped it — exactly what this
                # monitor exists to surface
                self._flag(
                    "unrequested-cancel-result",
                    "warning",
                    event.task_id,
                    f"{event.actor} shipped a CANCELLED result with no "
                    f"observed force-cancel request",
                    prior + (event,),
                )
                return
            self._flag(
                "cancel-after-dispatch",
                "warning",
                event.task_id,
                f"{event.actor} wrote CANCELLED over RUNNING: the "
                f"conditional cancel raced a concurrent dispatch; the "
                f"record converges when the result lands",
                prior + (event,),
            )


class RaceCheckStore(TaskStore):
    """Transparent :class:`TaskStore` wrapper feeding a :class:`RaceMonitor`.

    Wrap each agent's handle separately so the monitor can attribute writes:

        monitor = RaceMonitor()
        gw_store = RaceCheckStore(make_store(url), monitor, actor="gateway")
        disp_store = RaceCheckStore(make_store(url), monitor, actor="dispatcher")

    Only writes are intercepted; reads and the announce bus pass straight
    through (the bus is fire-and-forget by design — nothing to check).
    """

    def __init__(self, inner: TaskStore, monitor: RaceMonitor, actor: str) -> None:
        self.inner = inner
        self.monitor = monitor
        self.actor = actor

    # -- intercepted writes ------------------------------------------------
    def hset(self, key: str, fields: Mapping[str, str]) -> None:
        if key in (LIVE_INDEX_KEY, FLEET_HEALTH_KEY):
            # bookkeeping hashes, not task records: their fields are task
            # ids / dispatcher ids, which the lifecycle monitor must not
            # mistake for task fields
            self.inner.hset(key, fields)
            return
        if key.startswith(BLOB_PREFIX):
            # blob namespace, not a task record: data-field writes get the
            # create-once/content check; stamp-only writes (BLOB_AT_FIELD
            # refresh) are bookkeeping
            if BLOB_DATA_FIELD in fields:
                self.monitor.observe_blob_write(
                    self.actor, key, fields[BLOB_DATA_FIELD]
                )
            self.inner.hset(key, fields)
            return
        if key.startswith(TRACE_PREFIX):
            # span-plane hashes (obs/tracectx.py): telemetry, not task
            # records — span fields are first-write-wins by construction
            # (hsetnx), the stamp refresh is bookkeeping
            self.inner.hset(key, fields)
            return
        op = "finish" if FIELD_RESULT in fields else "status"
        if FIELD_STATUS in fields and fields[FIELD_STATUS] in (
            str(TaskStatus.QUEUED),
            str(TaskStatus.WAITING),  # graph nodes created behind deps
        ):
            op = "create"
        self.monitor.observe(self.actor, op, key, fields)
        self.inner.hset(key, fields)

    def hdel(self, key: str, *fields: str) -> None:
        return self.inner.hdel(key, *fields)

    def delete(self, key: str) -> None:
        self.monitor.observe(self.actor, "delete", key)
        self.inner.delete(key)

    def declare_redispatch(self, task_id: str) -> None:
        self.monitor.expect_redispatch(task_id)
        self.inner.declare_redispatch(task_id)

    def declare_replica(self, task_id: str) -> None:
        self.monitor.expect_replica(task_id)
        self.inner.declare_replica(task_id)

    def request_kill(
        self, task_id: str, channel: str = TASKS_CHANNEL
    ) -> None:
        self.monitor.expect_force_cancel(task_id)
        self.inner.request_kill(task_id, channel)

    def flush(self) -> None:
        self.monitor.observe_flush(self.actor)
        self.inner.flush()

    # -- pass-through ------------------------------------------------------
    def hget(self, key: str, field: str) -> str | None:
        return self.inner.hget(key, field)

    def hgetall(self, key: str) -> dict[str, str]:
        return self.inner.hgetall(key)

    def hmget(self, key: str, fields: list[str]) -> list[str | None]:
        # pass through, not the base loop-of-hget default: the reclaim path
        # relies on hmget being ONE round trip on RESP backends
        return self.inner.hmget(key, fields)

    def hget_many(self, keys: list[str], field: str) -> list[str | None]:
        return self.inner.hget_many(keys, field)

    def hincrby(self, key: str, field: str, delta: int) -> int:
        # dependency-count bookkeeping, not a lifecycle write: pass through
        # for atomicity (the base default's read-modify-write would race)
        return self.inner.hincrby(key, field, delta)

    def hincrby_many(self, items) -> list[int]:
        return self.inner.hincrby_many(items)

    def hgetall_many(self, keys: list[str]) -> list[dict[str, str]]:
        # reads pass through pipelined; only writes need the monitor.
        # The batch WRITE forms (set_status_many / finish_task_many /
        # hset_many) deliberately keep the base per-item loop defaults:
        # each item then flows through the intercepted hset above, so a
        # race-checked run trades the pipelining away for full observation
        return self.inner.hgetall_many(keys)

    @property
    def n_round_trips(self) -> int:
        # surface the wrapped backend's counter: a dispatcher wrapped for
        # race checking must still publish round-trip deltas (inflated by
        # the per-item write loops above — that is the observation tax)
        return self.inner.n_round_trips

    def setnx_field(self, key: str, field: str, value: str) -> tuple[bool, str]:
        # pass through for atomicity. Idempotency/dispatch claims are not
        # lifecycle writes — but a WINNING setnx on the STATUS field IS
        # one: create_task_if_absent claims its QUEUED status this way
        # (keyed submits), and without observing it here the monitor
        # would see the eventual RUNNING as None -> RUNNING
        created, current = self.inner.setnx_field(key, field, value)
        if created and field == FIELD_STATUS:
            self.monitor.observe(
                self.actor, "create", key, {FIELD_STATUS: value}
            )
        elif (
            created
            and field == BLOB_DATA_FIELD
            and key.startswith(BLOB_PREFIX)
        ):
            # put_blob's winning claim IS the blob's create: validate the
            # content against the digest (losers write nothing)
            self.monitor.observe_blob_write(self.actor, key, value)
        return created, current

    def setnx_fields(self, items, field: str):
        results = self.inner.setnx_fields(items, field)
        if field == FIELD_STATUS:
            for (key, value), (created, _current) in zip(items, results):
                if created:
                    self.monitor.observe(
                        self.actor, "create", key, {FIELD_STATUS: value}
                    )
        return results

    def hsetnx_many(self, items) -> list[bool]:
        # span-plane first-write-wins writes: trace hashes carry no
        # lifecycle fields, so there is nothing to observe — but route
        # through setnx_field-aware inner for atomicity
        return self.inner.hsetnx_many(items)

    def keys(self) -> list[str]:
        return self.inner.keys()

    def publish(self, channel: str, payload: str) -> None:
        self.inner.publish(channel, payload)

    def subscribe(self, channel: str) -> Subscription:
        return self.inner.subscribe(channel)

    def ping(self) -> bool:
        return self.inner.ping()

    # -- HA pass-throughs (store/replication.py) ---------------------------
    # replay delivers announces, not writes — nothing lifecycle-shaped to
    # observe; dedup/verification happens at dispatcher intake as usual
    def replay_announces(self, after: int):
        return self.inner.replay_announces(after)

    @property
    def failover_generation(self) -> int:
        return getattr(self.inner, "failover_generation", 0)

    @property
    def endpoints(self):
        return getattr(self.inner, "endpoints", None)

    # -- sharding pass-throughs (store/sharding.py) ------------------------
    # the ring is routing, not lifecycle: a race-checked sharded stack
    # keeps its shard topology visible to dispatchers/gateways while every
    # write above still flows through the observed per-item paths
    @property
    def shard_count(self):
        return getattr(self.inner, "shard_count", 0)

    @property
    def owned_shards(self):
        return getattr(self.inner, "owned_shards", None)

    def shard_of(self, task_id: str) -> int:
        fn = getattr(self.inner, "shard_of", None)
        return fn(task_id) if fn is not None else 0

    def shard_failover_generations(self):
        fn = getattr(self.inner, "shard_failover_generations", None)
        return fn() if fn is not None else []

    def rotate_endpoint(self) -> bool:
        fn = getattr(self.inner, "rotate_endpoint", None)
        return bool(fn()) if fn is not None else False

    def promote(self) -> int:
        fn = getattr(self.inner, "promote", None)
        if fn is None:
            raise NotImplementedError(
                f"{type(self.inner).__name__} cannot be promoted"
            )
        return fn()

    def info(self) -> dict:
        fn = getattr(self.inner, "info", None)
        return fn() if fn is not None else {}

    def save(self, path: str | None = None) -> None:
        self.inner.save(path)

    def close(self) -> None:
        self.inner.close()


def check_trace(events: Iterable[Event], *, strict: bool = False) -> list[Violation]:
    """Replay a recorded event trace through a fresh monitor (offline /
    post-mortem mode). Events may come from ``RaceMonitor.events`` of a live
    run or be reconstructed from logs."""
    monitor = RaceMonitor(strict=strict)
    for e in sorted(events, key=lambda e: e.seq):
        if e.op == "flush":
            monitor.observe_flush(e.actor)
            continue
        fields: dict[str, str] = {}
        if e.to_status is not None:
            fields[FIELD_STATUS] = e.to_status
        if e.result is not None:
            fields[FIELD_RESULT] = e.result
        monitor.observe(e.actor, e.op, e.task_id, fields)
    return monitor.violations
