"""Task model: ids, lifecycle statuses, and the per-task record.

Lifecycle contract (reference SURVEY §0.1; status enum observed at reference
test_suit.py:19): QUEUED -> RUNNING -> COMPLETED | FAILED. Statuses are plain
strings on the wire and in the store.

Beyond the reference surface: QUEUED -> CANCELLED (terminal), written by the
gateway's POST /cancel/{task_id}. Cancellation is queued-only and
best-effort: a task already RUNNING keeps running (the gateway refuses with
409), and the rare cancel that loses its race against dispatch simply runs
to completion — the record then reads COMPLETED/FAILED, never a lie. See
store/base.py cancel_task for the protocol.
"""

from __future__ import annotations

import enum
import uuid
from dataclasses import dataclass, field


class TaskStatus(str, enum.Enum):
    QUEUED = "QUEUED"
    #: non-terminal "not yet dispatchable": a graph node whose parents have
    #: not all COMPLETED. Created by the gateway's POST /execute_graph for
    #: every node with a non-empty depends_on; the store's promotion plane
    #: (store/base.py complete_dep_many) flips it to QUEUED when the last
    #: parent completes (then it flows through intake/admission/shedding
    #: like any submit) or to FAILED when any parent reaches a
    #: FAILED/EXPIRED/CANCELLED terminal (the transitive frontier is
    #: poisoned, never dispatched). WAITING -> RUNNING is an ILLEGAL
    #: transition by protocol: no dispatcher may ever send a WAITING task
    #: to a worker.
    WAITING = "WAITING"
    RUNNING = "RUNNING"
    COMPLETED = "COMPLETED"
    FAILED = "FAILED"
    #: terminal "never ran, never will": queued-only cancellation
    CANCELLED = "CANCELLED"
    #: terminal "never ran, never will": the task's queue deadline
    #: (FIELD_DEADLINE, an optional client hint) lapsed while it was still
    #: QUEUED, and the dispatcher shed it instead of burning a worker slot
    #: on an answer nobody is waiting for. Written only by the dispatcher
    #: that owns the task's pending copy, via store.expire_task — the
    #: transition is legal from QUEUED alone (a RUNNING task always runs
    #: to completion; mid-run deadlines are the per-task `timeout` hint's
    #: job, enforced in the worker pool child).
    EXPIRED = "EXPIRED"

    def is_terminal(self) -> bool:
        return self in (
            TaskStatus.COMPLETED,
            TaskStatus.FAILED,
            TaskStatus.CANCELLED,
            TaskStatus.EXPIRED,
        )

    @classmethod
    def terminal_str(cls, status: str | None, *, unknown: bool = False) -> bool:
        """``is_terminal`` over a raw store/wire string. ``unknown`` is the
        answer for None or a foreign status string — callers pick their
        safe side (a result-freeze guard wants True: never overwrite what
        it can't parse; a drop/GC site wants False: leave it alone). The
        ValueError policy lives HERE so every consumer of raw status
        strings agrees on it."""
        if status is None:
            return unknown
        try:
            return cls(status).is_terminal()
        except ValueError:
            return unknown

    def __str__(self) -> str:  # plain string on the wire
        return self.value


#: Store hash field names, one hash per task (reference contract demonstrated
#: by old/client_debug.py:40-45 and read back at task_dispatcher.py:48-52).
FIELD_STATUS = "status"
FIELD_FN = "fn_payload"
FIELD_PARAMS = "param_payload"
FIELD_RESULT = "result"
#: Optional scheduling hints, written by the gateway only when the client
#: supplied them (the reference contract has no analog; absent fields keep
#: hand-rolled reference-style clients fully interoperable).
FIELD_PRIORITY = "priority"  # int as str; higher = admitted first
FIELD_COST = "cost"  # float as str; estimated run-cost (scheduler pairing)
FIELD_TIMEOUT = "timeout"  # float as str; execution budget enforced in-child
#: Optional queue deadline (ABSOLUTE epoch seconds as str), computed by the
#: gateway from the client's relative ``deadline`` submit-TTL hint. A task
#: still QUEUED past this instant is shed to the terminal EXPIRED status by
#: the dispatcher that holds it, instead of being dispatched. Absolute on
#: the wire (not the relative TTL) so the decision survives dispatcher
#: restarts and re-announces without re-deriving the submit time.
FIELD_DEADLINE = "deadline"
#: Speculative-execution opt-in ("1" when set; tpu_faas/spec): the client
#: declares this task safe to execute more than once (idempotent side
#: effects), so a dispatcher running with ``--speculate-mult`` may hedge a
#: straggling execution with a replica on a second worker — the store's
#: first-wins finish_task arbitrates, the loser is killed via the CANCEL
#: plane. Absent (every legacy producer) = never hedged.
FIELD_SPECULATIVE = "speculative"
#: Content address (sha256 hex, core/payload.py) of the task's serialized
#: function, written by a payload-plane gateway in place of an inline
#: FIELD_FN body: the bytes live ONCE under the store's ``blob:<digest>``
#: key and every consumer (dispatcher blob cache, worker payload cache)
#: resolves them by digest. A record carrying this field may carry an
#: EMPTY FIELD_FN; legacy records (and every record from a
#: reference-style producer) carry the inline body and no digest —
#: dispatch falls back per record, so the two populations mix freely on
#: one store.
FIELD_FN_DIGEST = "fn_digest"
#: Content address (sha256 hex) of the task's serialized RESULT — the
#: result-blob plane's mirror of FIELD_FN_DIGEST. Written by finish_task
#: when a ``--result-blobs`` dispatcher records a digest-form result: the
#: record's FIELD_RESULT may then be EMPTY, the bytes staying in the
#: producing worker's result cache (and, once anything needed them, under
#: the store's ``blob:<digest>`` key — lazy materialization,
#: store/base.py BLOBREQ_ANNOUNCE_PREFIX). Absent on every legacy record
#: and whenever the plane is off, so reference-style readers that only
#: know FIELD_RESULT keep their contract byte for byte.
FIELD_RESULT_DIGEST = "result_digest"
#: Byte length of the digest-form result body (int as str), written in the
#: same terminal write as FIELD_RESULT_DIGEST: readers and the placement
#: tick's parent-locality lane can reason about result SIZE without
#: materializing the bytes.
FIELD_RESULT_SIZE = "result_size"

#: Written by finish_task alongside every terminal write (epoch seconds as
#: str) — lets the gateway's optional result-TTL sweeper age out consumed
#: records without a per-task client DELETE.
FIELD_FINISHED_AT = "finished_at"
#: Redundant copies of the result's terminal status and finish time,
#: written by finish_task in the same hash write as FIELD_STATUS /
#: FIELD_FINISHED_AT. They exist for exactly one interleaving: a cancel
#: whose pre-write status read said QUEUED while a sub-millisecond task ran
#: to completion inside the read->write window would otherwise clobber the
#: landed COMPLETED/FAILED (and its finish stamp) forever — the primary
#: fields alone can't say what they were. cancel_task re-reads these after
#: its write and restores the record — see store/base.py cancel_task.
FIELD_FINAL_STATUS = "final_status"
FIELD_FINAL_AT = "final_finished_at"

#: Optional submit stamp (epoch seconds as str), written by the gateway in
#: the create-task hash write. Feeds the first event of the per-task
#: lifecycle timeline (tpu_faas/obs/trace.py): the dispatcher reads it at
#: intake so queue-wait and end-to-end latency are measurable from the
#: client's submit, not just from announce receipt. Absent on tasks from
#: hand-rolled reference-style producers — the timeline simply starts at
#: its first dispatcher-side event.
FIELD_SUBMITTED_AT = "submitted_at"

#: Distributed trace context (tpu_faas/obs/tracectx.py): the trace id this
#: task's cross-process spans are keyed by (lowercase hex, minted by the
#: SDK — or by a trace-enabled gateway for legacy clients), plus the
#: optional parent span id of the submitting client. Absent on tasks from
#: reference-style producers and on trace-disabled gateways — every
#: consumer treats absence as "tracing off for this task" and changes
#: nothing.
FIELD_TRACE_ID = "trace_id"
FIELD_TRACE_PARENT = "trace_parent"

#: Tenant identity (tpu_faas/tenancy): which principal this task is
#: accounted to by the weighted-fair placement plane. Written by the
#: gateway from the ``X-Tenant-Id`` request header (validated — it becomes
#: a metrics-label candidate and a share-table key); ABSENT on tasks from
#: legacy/reference-style producers, which every consumer reads as the
#: default tenant — so tenancy-oblivious clients share one fair-queued
#: bucket and the whole plane is invisible until two tenants actually
#: coexist. Rides RECLAIM_FIELDS: a reclaimed task keeps its accounting.
FIELD_TENANT = "tenant"

#: SLO class (tpu_faas/obs/attribution.py): which latency class this task
#: is judged under by the per-class tail accounting — one of the CLOSED
#: vocabulary (interactive/batch/default; it becomes a histogram label).
#: Written by the gateway ONLY when the client declared one (``X-SLO-Class``
#: header / SDK ``slo_class=``); ABSENT otherwise — consumers derive the
#: effective class from the priority sign, so the submit surface stays
#: byte-identical for clients that never declare and legacy records need
#: no migration. Off-vocabulary values degrade to ``default`` at read.
FIELD_SLO_CLASS = "slo_class"

#: Written (epoch seconds as str) with every RUNNING mark and refreshed
#: periodically by the dispatcher that owns the task's worker. A RUNNING
#: record whose lease has gone stale has no live owner left — its worker
#: AND its dispatcher died — and may be adopted by a stranded-task rescan
#: (the reference loses such tasks forever: its purge only deletes
#: bookkeeping, task_dispatcher.py:241-249, README:262-264).
FIELD_LEASE_AT = "lease_at"

#: How many times this task has been reclaimed from a dead worker (int as
#: str), stamped on every re-dispatch RUNNING mark. In-memory retry counts
#: die with their dispatcher — without this stamp, a task that keeps
#: killing worker+dispatcher together would reset its poison-guard counter
#: every dispatcher generation and cycle forever instead of FAILing.
FIELD_RECLAIMS = "reclaim_count"

#: Atomic dispatch-ownership claim for SHARED fleets (several dispatchers
#: on one store+channel — each receives every announce, and without a
#: claim each would dispatch every task). Value is
#: "<dispatcher_id>:<epoch seconds>"; exactly one of N concurrent
#: dispatchers wins the setnx and dispatches. Adoptions of an owner that
#: died re-arbitrate on generation-scoped fields (``claim_field_for``).
FIELD_DISPATCH_CLAIM = "dispatch_claim"


#: Task-graph dependency edges (tpu_faas/graph): comma-joined parent task
#: ids on a WAITING node, written once at graph create and never mutated.
#: The sweeper's orphan repair re-derives a stranded node's fate from
#: these; the tpu-push frontier builds its device edge list from them.
FIELD_DEPS = "deps"
#: Countdown of not-yet-COMPLETED parents (int as str) on a WAITING node.
#: Decremented ATOMICALLY (store hincrby) by the promotion plane, exactly
#: once per parent (each decrement is gated by a write-once per-edge claim
#: field "dep_done:<parent>", so a zombie's duplicate terminal write can't
#: double-count). Hitting zero triggers WAITING -> QUEUED.
FIELD_PENDING_DEPS = "pending_deps"
#: Comma-joined child task ids on any graph node that other nodes depend
#: on — the forward edges the promotion plane walks on the parent's
#: terminal write. Absent on non-graph tasks, so the flat hot path never
#: pays a dependency probe.
FIELD_CHILDREN = "dep_children"
#: Write-once resolution claim on a WAITING node ("promote" or
#: "poison:<parent_id>"): exactly one resolver — the promotion plane, the
#: poison walk, or the gateway sweeper's orphan repair — ever moves the
#: node out of WAITING, so promote/poison cannot race each other into an
#: illegal status interleaving. A claim whose writer died before the
#: status write is re-applied idempotently by the sweeper.
FIELD_DEP_RESOLVED = "dep_resolved"

#: Per-edge decrement claim field for parent ``parent_id`` on a child's
#: hash — see FIELD_PENDING_DEPS.
def dep_done_field(parent_id: str) -> str:
    return f"dep_done:{parent_id}"


#: Result-message prefix of a dep-poisoned node's FAILED payload: the
#: serialized exception reads "dep_failed:<parent_id>: <detail>", so SDKs
#: can raise TaskDependencyError with the failed parent attached without
#: any dill class-identity coupling.
DEP_FAILED_PREFIX = "dep_failed:"


def claim_field_for(generation: int) -> str:
    """The dispatch-claim hash field for reclaim generation ``generation``
    (0 = the initial announce-time claim). Each generation is a fresh
    write-once field, so N dispatchers racing to ADOPT the same orphaned
    task arbitrate with the same setnx primitive as the initial dispatch —
    exactly one wins generation g."""
    return (
        FIELD_DISPATCH_CLAIM
        if generation == 0
        else f"{FIELD_DISPATCH_CLAIM}:g{generation}"
    )


def new_task_id() -> str:
    return str(uuid.uuid4())


def new_function_id() -> str:
    return str(uuid.uuid4())


@dataclass
class Task:
    """In-memory view of one task's store hash."""

    task_id: str
    status: TaskStatus = TaskStatus.QUEUED
    fn_payload: str = ""
    param_payload: str = ""
    result: str = "None"
    #: Scheduler-side metadata (not part of the reference contract): an
    #: estimated execution cost used to build the tasks x workers cost matrix.
    cost_estimate: float = field(default=1.0, compare=False)

    def to_fields(self) -> dict[str, str]:
        return {
            FIELD_STATUS: str(self.status),
            FIELD_FN: self.fn_payload,
            FIELD_PARAMS: self.param_payload,
            FIELD_RESULT: self.result,
        }

    @classmethod
    def from_fields(cls, task_id: str, fields: dict[str, str]) -> "Task":
        return cls(
            task_id=task_id,
            status=TaskStatus(fields.get(FIELD_STATUS, "QUEUED")),
            fn_payload=fields.get(FIELD_FN, ""),
            param_payload=fields.get(FIELD_PARAMS, ""),
            result=fields.get(FIELD_RESULT, "None"),
        )
