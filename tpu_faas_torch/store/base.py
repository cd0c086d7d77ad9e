"""Abstract task store + announce bus interface.

Operations are the minimal set the reference exercises against Redis:

- hash per task: HSET/HGET/HGETALL (reference task_dispatcher.py:48-52,
  85-86, 153-156, 288-295; gateway side per SURVEY §0.1);
- announce bus: PUBLISH task_id on a channel at submit time; the dispatcher
  SUBSCRIBEs and drains at most one message per tick via a non-blocking
  ``get_message()`` (reference task_dispatcher.py:75,170,299,394,452) so that
  back-pressure stays implicit — unread announcements buffer in the
  subscription;
- FLUSHDB between benchmark runs (reference client_performance.py:152,253).

Task-level conveniences (`create_task`, `finish_task`, ...) wrap the raw hash
ops so call sites stay readable; both levels are part of the interface because
the gateway writes the exact field contract while dispatchers read it.
"""

from __future__ import annotations

import abc
import time
from typing import Mapping

from tpu_faas_torch.core.task import (
    DEP_FAILED_PREFIX,
    FIELD_CHILDREN,
    FIELD_DEP_RESOLVED,
    FIELD_FINAL_AT,
    FIELD_FINAL_STATUS,
    FIELD_FINISHED_AT,
    FIELD_FN,
    FIELD_PARAMS,
    FIELD_PENDING_DEPS,
    FIELD_RESULT,
    FIELD_RESULT_DIGEST,
    FIELD_RESULT_SIZE,
    FIELD_STATUS,
    TaskStatus,
    dep_done_field,
)

#: Default announce channel name (reference config.ini:7 `TASKS_CHANNEL=tasks`).
TASKS_CHANNEL = "tasks"

#: Index hash of live (non-terminal) task ids: field = task_id, value "1".
#: Written with every create, removed with every terminal write, so a
#: stranded-task rescan reads O(live tasks) instead of KEYS-walking the
#: full keyspace — whose size grows with HISTORY (every task that ever
#: ran) unless a TTL sweeper prunes it. Stale entries are harmless (the
#: rescan status-probes each candidate anyway) and are garbage-collected
#: by the rescan itself; MISSING entries (foreign producers writing the
#: raw reference contract, pre-index snapshots) are covered by the
#: rescan's periodic full-scan fallback.
LIVE_INDEX_KEY = "tasks:index"

#: Dispatcher liveness registry: field = dispatcher_id, value = epoch
#: seconds of its last lease-renewal pass. Shared-fleet adoption decisions
#: key off this — a task claim is only stealable once its OWNER's
#: heartbeat here has gone stale (a merely-overloaded sibling keeps
#: renewing and keeps its claims).
DISPATCHERS_KEY = "dispatchers:alive"
#: Fleet-wide lease configuration. Each rescanning dispatcher publishes its
#: adoption horizon as a write-once field "t:<lease_timeout>" -> wall time
#: of first publication (setnx); the fleet's effective horizon is the MIN
#: over fields (value-keyed so concurrent publishers can't lose updates to
#: each other). Every dispatcher mode folds it into its lease-renew cadence
#: (renew at timeout/3 when that is tighter than the default
#: LEASE_RENEW_PERIOD), and rescanners grace-floor adoptions briefly after
#: a value first appears. Without this, a mixed fleet where a rescanner
#: runs ``--lease-timeout`` at or below ~2-3x the siblings' fixed renew
#: period would adopt tasks whose owner is alive but between renewals —
#: double execution.
LEASE_CONF_KEY = "fleet:lease_conf"
#: Fleet-wide tenant-fairness configuration (tpu_faas/tenancy): fields
#: ``shares`` / ``caps`` hold "<spec>:<wall stamp>" — the spec is the same
#: "name=value,..." string the ``--tenant-shares``/``--tenant-caps`` CLI
#: flags take, and the trailing stamp makes the sharded store's
#: freshest-wins fleet-hash merge (store/sharding.py) pick the newest
#: publication. Dispatchers re-read it at capacity-publish cadence (~1 Hz)
#: and apply changes to their live TenantTable without a restart.
TENANT_CONF_KEY = "fleet:tenant_conf"
#: Results channel: finish_task announces every terminal write here so the
#: gateway can wake parked /result long-polls instantly instead of polling
#: the store. No reference analog (its clients poll, SURVEY §3.1); the
#: channel is fire-and-forget like the task bus — consumers must keep a
#: fallback re-read, never rely on delivery.
RESULTS_CHANNEL = "results"

#: Express result lane: terminal announces on RESULTS_CHANNEL may carry the
#: status + result INLINE ("<prefix><task_id>\\x00<status>\\x00<result>") so
#: a woken gateway long-poll replies from the forwarded payload instead of
#: paying a store re-read per delivery. Strictly opt-in at the producer
#: (finish_task's ``inline_max``; 0 = the classic id-only payload, the
#: default everywhere) — the store write stays authoritative and PRECEDES
#: the announce on the same pipelined round, so a consumer that ignores the
#: inline form and re-reads the record sees the identical terminal state.
#: Reference-era consumers never see the form unless the operator enables
#: it fleet-wide.
RESULT_INLINE_PREFIX = "!r1:"
#: Express digest form (result-blob plane, ``--result-blobs`` producers):
#: the announce carries status + result DIGEST + size instead of the body
#: ("<prefix><task_id>\\x00<status>\\x00<digest>\\x00<size>"). Produced
#: only for digest-form terminal writes (FIELD_RESULT_DIGEST set, body
#: empty), so off-plane announce bytes are untouched; a consumer that
#: doesn't know the form treats the whole payload as an opaque id (its
#: record probe finds nothing and skips, like any garbage announce).
RESULT_DIGEST_PREFIX = "!r2:"
#: Default inline-payload bound for express producers (the dispatcher's
#: ``--express`` knob): results larger than this fall back to the id-only
#: announce and the gateway's ordinary store read.
RESULT_INLINE_MAX_BYTES = 4096
_RESULT_INLINE_SEP = "\x00"


def encode_result_announce(
    task_id: str,
    status: str,
    result: str,
    inline_max: int = 0,
    result_digest: str | None = None,
    result_size: int = 0,
) -> str:
    """The RESULTS_CHANNEL payload for one terminal write: the digest form
    for digest-form writes (result-blob plane), the inline express form
    when ``inline_max`` allows it, else the classic bare task id.
    Oversized results — and any field that would collide with the
    framing — fall back to id-only rather than truncate: a wrong inline
    payload is worse than a store re-read."""
    status = str(status)
    if (
        result_digest
        and not result
        and _RESULT_INLINE_SEP not in task_id
        and _RESULT_INLINE_SEP not in status
        and _RESULT_INLINE_SEP not in result_digest
    ):
        return (
            f"{RESULT_DIGEST_PREFIX}{task_id}{_RESULT_INLINE_SEP}"
            f"{status}{_RESULT_INLINE_SEP}{result_digest}"
            f"{_RESULT_INLINE_SEP}{int(result_size)}"
        )
    if (
        inline_max > 0
        and len(result) <= inline_max
        and _RESULT_INLINE_SEP not in task_id
        and _RESULT_INLINE_SEP not in status
        and _RESULT_INLINE_SEP not in result
    ):
        return (
            f"{RESULT_INLINE_PREFIX}{task_id}{_RESULT_INLINE_SEP}"
            f"{status}{_RESULT_INLINE_SEP}{result}"
        )
    return task_id


def decode_result_announce(
    payload: str,
) -> tuple[str, str | None, str | None]:
    """(task_id, status, result) of one RESULTS_CHANNEL payload; status and
    result are None for the classic id-only form (and for any malformed
    inline frame — the consumer then falls back to its store read, which is
    always correct). The digest form decodes to (task_id, status, None):
    body-oblivious consumers get the wake-up and re-read the record."""
    tid, status, result, _digest, _size = decode_result_announce_full(payload)
    return tid, status, result


def decode_result_announce_full(
    payload: str,
) -> tuple[str, str | None, str | None, str | None, int]:
    """(task_id, status, result, result_digest, result_size) of one
    RESULTS_CHANNEL payload — the digest-aware decode for consumers that
    can materialize blobs (gateway result delivery). Classic id-only and
    malformed frames decode with every optional part None, same fallback
    contract as :func:`decode_result_announce`."""
    if payload.startswith(RESULT_DIGEST_PREFIX):
        parts = payload[len(RESULT_DIGEST_PREFIX):].split(
            _RESULT_INLINE_SEP, 3
        )
        if len(parts) != 4 or not parts[0] or not parts[1] or not parts[2]:
            return payload, None, None, None, 0
        try:
            size = int(parts[3])
        except ValueError:
            size = 0
        return parts[0], parts[1], None, parts[2], size
    if not payload.startswith(RESULT_INLINE_PREFIX):
        return payload, None, None, None, 0
    parts = payload[len(RESULT_INLINE_PREFIX):].split(_RESULT_INLINE_SEP, 2)
    if len(parts) != 3 or not parts[0] or not parts[1]:
        # malformed frame (foreign producer): treat the whole payload as an
        # opaque id — the consumer's record probe will find nothing and
        # skip, exactly like any garbage announce
        return payload, None, None, None, 0
    return parts[0], parts[1], parts[2], None, 0

#: Content-addressed payload namespace: one hash per payload body, keyed
#: ``blob:<sha256>`` (core/payload.py payload_digest). Write-once by
#: protocol — the digest IS the content, so a second writer of the same
#: key by definition carries identical bytes, and put_blob claims the data
#: field with setnx so even a buggy second writer cannot mutate it (the
#: race monitor flags any bypass, store/racecheck.py). Values keep the
#: ASCII payload contract: the RESP wire and every reference-style
#: consumer of this store are string-typed surfaces.
BLOB_PREFIX = "blob:"
#: the payload body field of a blob hash
BLOB_DATA_FIELD = "data"
#: epoch-seconds stamp of the blob's last put ATTEMPT (a dedup hit
#: refreshes it): the TTL half of refcount-or-TTL GC — the gateway's
#: sweeper only collects blobs whose stamp has aged out AND that no
#: function-registry record or live task still references (the refcount
#: half, recomputed from the referencing records at sweep time so there
#: is no counter to corrupt).
BLOB_AT_FIELD = "blob_at"


def blob_key(digest: str) -> str:
    return BLOB_PREFIX + digest


#: Materialize-request namespace (result-blob plane): a reader that needs
#: the BODY of a digest-form result the store doesn't hold yet — a legacy
#: /result consumer, mostly — claims ``blobreq:<digest>`` (setnx on the
#: REQ_AT field, dedup across concurrent readers) and publishes
#: "<BLOBREQ_ANNOUNCE_PREFIX><digest>" on the TASKS announce channel. The
#: dispatcher that tracks a producer worker for the digest pulls the body
#: off that worker's result cache (reverse BLOB_MISS/BLOB_FILL), writes
#: the ``blob:<digest>`` record, and deletes the request key; the reader
#: polls get_blob meanwhile. Plain ring-routed — every client spells the
#: key identically, so the fleet shares one copy per digest. Stale
#: requests (producer died with the only copy) are aged out by the blob
#: sweeper.
BLOBREQ_PREFIX = "blobreq:"
#: epoch-seconds stamp of the materialize request (its only field)
BLOBREQ_AT_FIELD = "req_at"


def blobreq_key(digest: str) -> str:
    return BLOBREQ_PREFIX + digest


#: Control message on the TASKS announce channel: "<prefix><task_id>" tells
#: dispatchers to drop the task from any pending structure they hold (the
#: gateway publishes it only AFTER it actually wrote CANCELLED). Plain
#: create-announces are bare task ids, which never start with this prefix;
#: a reference-style consumer that treats it as a task id just finds no
#: record and skips — the bus stays wire-compatible.
CANCEL_ANNOUNCE_PREFIX = "!cancel:"
#: Control message requesting a FORCE cancel of a RUNNING task: whichever
#: dispatcher holds it in flight relays a CANCEL to the owning worker,
#: which interrupts the task mid-run (worker/pool.py SIGUSR1) and ships a
#: terminal CANCELLED result through the ordinary result path. Best-effort:
#: no store write happens here — the record converges when the worker's
#: result lands (or stays RUNNING if the task finished first).
KILL_ANNOUNCE_PREFIX = "!kill:"
#: Control message requesting lazy materialization of a result blob:
#: "<prefix><digest>" asks whichever dispatcher tracks a live producer for
#: the digest to pull the body off that worker's result cache and write
#: the ``blob:<digest>`` record (see BLOBREQ_PREFIX). Best-effort like
#: every announce — the requester keeps polling get_blob and times out to
#: its documented failure mode if nobody can serve.
BLOBREQ_ANNOUNCE_PREFIX = "!blobreq:"


class Subscription(abc.ABC):
    """A pub/sub subscription handle with a non-blocking drain."""

    @abc.abstractmethod
    def get_message(self, timeout: float = 0.0) -> str | None:
        """Return the next published payload, or None if nothing is pending.

        ``timeout`` > 0 blocks up to that many seconds. The default 0 makes a
        dispatcher tick non-blocking, matching the reference's
        ``subscriber.get_message()`` usage.
        """

    @abc.abstractmethod
    def close(self) -> None: ...

    def fileno(self) -> int | None:
        """A file descriptor whose READABILITY signals that a message may
        be pending — what lets an event-driven serve loop park in one
        poll() over its worker sockets AND the announce bus instead of
        waking on a tick cadence. None (the default) means the backend has
        no pollable signal; consumers keep their periodic drain. The fd
        may change across reconnects — pollers should re-check each
        iteration. Readability is a HINT (spurious wakes are fine, the
        drain finding nothing is fine); the periodic fallback drain still
        covers a backend whose signal is lossy."""
        return None

    def pollable_fds(self) -> list[int]:
        """Every pollable readability fd of this subscription (fan-out
        subscriptions over several shards return one per shard); [] when
        the backend has no pollable signal."""
        fd = self.fileno()
        return [fd] if fd is not None else []

    def __enter__(self) -> "Subscription":
        return self

    def __exit__(self, *exc: object) -> None:
        self.close()


class TaskStore(abc.ABC):
    """Hash-per-task store + announce bus."""

    #: Monotonic count of wire round trips this handle has paid (a
    #: pipelined batch counts as ONE). Only networked backends increment
    #: it (RespStore); in-process backends leave it 0. Observability only:
    #: the tpu-push dispatcher publishes per-tick deltas of this so an
    #: operator can SEE that the data plane stays at a bounded number of
    #: pipelined rounds per tick instead of O(tasks) round trips.
    n_round_trips: int = 0

    #: Bumped by failover-capable backends (multi-endpoint RespStore)
    #: every time commands settle on a DIFFERENT store endpoint.
    #: Dispatchers watch it to trigger their post-failover re-arm
    #: (announce replay + immediate rescan); 0 forever on backends that
    #: cannot fail over.
    failover_generation: int = 0

    # -- raw hash ops ------------------------------------------------------
    @abc.abstractmethod
    def hset(self, key: str, fields: Mapping[str, str]) -> None: ...

    @abc.abstractmethod
    def hget(self, key: str, field: str) -> str | None: ...

    @abc.abstractmethod
    def hgetall(self, key: str) -> dict[str, str]: ...

    @abc.abstractmethod
    def hdel(self, key: str, *fields: str) -> None:
        """Remove fields from a hash (standard Redis HDEL; a key whose last
        field is removed disappears). The live-task index depends on it."""

    @abc.abstractmethod
    def delete(self, key: str) -> None: ...

    @abc.abstractmethod
    def keys(self) -> list[str]: ...

    # -- announce bus ------------------------------------------------------
    @abc.abstractmethod
    def publish(self, channel: str, payload: str) -> None: ...

    def publish_many(self, channel: str, payloads: list[str]) -> None:
        """Batch publish on one channel. Default: a loop; the RESP client
        pipelines one round trip — the batched keyed-create's announces
        ride this so a large batch doesn't pay one round trip per task."""
        for payload in payloads:
            self.publish(channel, payload)

    @abc.abstractmethod
    def subscribe(self, channel: str) -> Subscription: ...

    def replay_announces(
        self, after: int
    ) -> tuple[int, list[tuple[str, str]]]:
        """Re-read recent announces from the backend's bounded replay ring
        (store/replication.py): entries with replay offset > ``after``
        plus the current tail offset; ``after=-1`` asks for the tail
        alone. The post-failover re-arm reads this on a promoted replica
        to re-discover announces the dead primary published that no
        dispatcher drained. Default: unsupported — tail -1, no entries
        (backends without a ring simply rely on the rescan)."""
        return -1, []

    # -- admin -------------------------------------------------------------
    @abc.abstractmethod
    def flush(self) -> None:
        """Drop all hashes (FLUSHDB equivalent). Subscriptions stay open."""

    @abc.abstractmethod
    def close(self) -> None: ...

    def ping(self) -> bool:
        return True

    def save(self, path: str | None = None) -> None:
        """Checkpoint the store (see tpu_faas/store/snapshot.py).

        `path=None` means "the backend's configured snapshot target"
        (a server's --snapshot file). Backends without durability raise."""
        raise NotImplementedError(f"{type(self).__name__} cannot checkpoint")

    def hincrby(self, key: str, field: str, delta: int) -> int:
        """Atomically add ``delta`` to an integer hash field (absent = 0)
        and return the new value — the dependency plane's pending-count
        decrement. This base default is read-modify-write and only
        single-thread safe; production backends override it (the RESP
        client sends HINCRBY, the memory store holds its lock)."""
        current = self.hget(key, field)
        try:
            value = int(current) if current is not None else 0
        except ValueError:
            value = 0
        value += int(delta)
        self.hset(key, {field: str(value)})
        return value

    def hincrby_many(self, items: list[tuple[str, str, int]]) -> list[int]:
        """hincrby over (key, field, delta) triples. Default: a loop; the
        RESP client pipelines one HINCRBY round — the promotion plane
        decrements every child of a finished parent batch at once."""
        return [self.hincrby(key, field, delta) for key, field, delta in items]

    # -- task-level conveniences ------------------------------------------
    def create_task(
        self,
        task_id: str,
        fn_payload: str,
        param_payload: str,
        channel: str = TASKS_CHANNEL,
        extra_fields: dict[str, str] | None = None,
        status: TaskStatus = TaskStatus.QUEUED,
    ) -> None:
        """Write the gateway-side contract: full hash then announce.

        Field set and QUEUED initial status per SURVEY §0.1 (demonstrated in
        the reference by old/client_debug.py:40-45). ``extra_fields`` carries
        optional scheduling hints (FIELD_PRIORITY/FIELD_COST); the core four
        fields win on any name collision. ``status`` admits exactly one
        other initial state: WAITING, for graph nodes created behind their
        dependencies (gateway /execute_graph) — the announce still fires
        (graph-aware dispatchers park the node in their frontier; everyone
        else skips non-QUEUED announces as always).
        """
        # index first: a crash after the index write leaves a stale entry
        # (filtered by the rescan's status probe); the opposite order would
        # leave a live task invisible to indexed rescans
        self.hset(LIVE_INDEX_KEY, {task_id: "1"})
        self.hset(
            task_id,
            {
                **(extra_fields or {}),
                FIELD_STATUS: str(status),
                FIELD_FN: fn_payload,
                FIELD_PARAMS: param_payload,
                FIELD_RESULT: "None",
            },
        )
        self.publish(channel, task_id)

    def create_task_if_absent(
        self,
        task_id: str,
        fn_payload: str,
        param_payload: str,
        channel: str = TASKS_CHANNEL,
        extra_fields: dict[str, str] | None = None,
    ) -> bool:
        """create_task that can NEVER regress an existing record: the status
        field is claimed with setnx, so a concurrent (or very late) second
        creator writes nothing — a plain create_task racing an already-
        dispatched copy of the same deterministic task id would reset
        RUNNING back to QUEUED and get the task executed twice. Used by the
        gateway for every idempotency-keyed create, where winner and
        adopter can both believe the record is theirs to write.

        Returns True when this call created (and announced) the record.
        A predecessor that died between its status claim and its field
        write (status QUEUED, no params) is repaired in place — same
        values, write-once — and re-announced; duplicate announces are
        deduped at dispatcher intake.
        """
        created, current = self.setnx_field(
            task_id, FIELD_STATUS, str(TaskStatus.QUEUED)
        )
        if not created and not (
            current == str(TaskStatus.QUEUED)
            and self.hget(task_id, FIELD_PARAMS) is None
        ):
            return False
        self.hset(LIVE_INDEX_KEY, {task_id: "1"})
        self.hset(
            task_id,
            {
                **(extra_fields or {}),
                FIELD_FN: fn_payload,
                FIELD_PARAMS: param_payload,
                FIELD_RESULT: "None",
            },
        )
        self.publish(channel, task_id)
        # claim-loss repair: a concurrent cancel aimed at the PREVIOUS
        # incarnation of this deterministic id can clobber the setnx'd
        # QUEUED with CANCELLED and then have its ghost cleanup strip the
        # status field entirely (cancel_task's probe saw no params yet) —
        # leaving this freshly-written record status-less, which intake
        # skips forever. Re-claim and re-announce; a duplicate announce is
        # deduped at intake. Deliberate cost: one small-field read per
        # keyed create (status is bytes, never a payload) buys out a
        # stranded acknowledged submit — the one failure in this family
        # that no retry or sweeper would ever repair.
        if self.hget(task_id, FIELD_STATUS) is None:
            self.hset(task_id, {FIELD_STATUS: str(TaskStatus.QUEUED)})
            self.publish(channel, task_id)
        return True

    def create_tasks_if_absent(
        self,
        tasks: list[tuple],  # (task_id, fn_payload, params[, extra_fields])
        channel: str = TASKS_CHANNEL,
    ) -> list[bool]:
        """Batch ``create_task_if_absent``: the common case (every id
        fresh — the gateway's auto-keyed bulk submit) pays a BOUNDED
        number of pipelined rounds on RESP backends — one status-claim
        round (setnx_fields), one create round (create_tasks; its
        QUEUED-over-just-claimed-QUEUED rewrite is the protocol's
        idempotent-retry transition), one claim-loss recheck round —
        instead of several round trips per item. Items whose status claim
        LOST (dedup-adoption races, repairs) fall back to the per-item
        form, which carries the full repair ladder; losers are rare by
        construction. Returns created flags parallel to ``tasks``."""
        if not tasks:
            return []
        ids = [t[0] for t in tasks]
        claims = self.setnx_fields(
            [(tid, str(TaskStatus.QUEUED)) for tid in ids], FIELD_STATUS
        )
        created = [False] * len(tasks)
        winners = [i for i, (won, _cur) in enumerate(claims) if won]
        if winners:
            # winners' field writes carry NO status — exactly like the
            # per-item form: the setnx above already claimed QUEUED, and
            # rewriting it here would reopen the regression this method
            # exists to prevent (a winner stalled past the adoption wait
            # has its record adopted by a duplicate submit and possibly
            # dispatched; a late status=QUEUED write would then reset
            # RUNNING and run the task twice)
            items: list[tuple[str, dict[str, str]]] = []
            for i in winners:
                tid, fn_payload, param_payload = tasks[i][:3]
                extra = tasks[i][3] if len(tasks[i]) > 3 else None
                # index first (same ordering rationale as create_task)
                items.append((LIVE_INDEX_KEY, {tid: "1"}))
                items.append(
                    (
                        tid,
                        {
                            **(extra or {}),
                            FIELD_FN: fn_payload,
                            FIELD_PARAMS: param_payload,
                            FIELD_RESULT: "None",
                        },
                    )
                )
            self.hset_many(items)
            winner_ids = [ids[i] for i in winners]
            self.publish_many(channel, winner_ids)
            # claim-loss repair, batched (see create_task_if_absent): a
            # concurrent cancel's ghost cleanup can strip the status out
            # from under the create — re-claim and re-announce stragglers
            recheck = self.hget_many(winner_ids, FIELD_STATUS)
            for tid, status in zip(winner_ids, recheck):
                if status is None:
                    self.hset(tid, {FIELD_STATUS: str(TaskStatus.QUEUED)})
                    self.publish(channel, tid)
            for i in winners:
                created[i] = True
        for i, (won, _cur) in enumerate(claims):
            if not won:
                task = tasks[i]
                created[i] = self.create_task_if_absent(
                    task[0],
                    task[1],
                    task[2],
                    channel,
                    task[3] if len(task) > 3 else None,
                )
        return created

    def hexists(self, key: str, field: str) -> bool:
        """Field presence WITHOUT transferring the value (standard Redis
        HEXISTS). Default: an hget — correct everywhere; the RESP client
        overrides with the real command so a multi-MB payload field isn't
        dragged over the wire just to test existence (cancel_task's record-
        completeness probes)."""
        return self.hget(key, field) is not None

    def hmget(self, key: str, fields: list[str]) -> list[str | None]:
        """Several fields of one hash, None per missing field. Default: a
        loop; the RESP client sends one HMGET round trip — the dispatcher's
        reclaim path uses this so re-queuing a dead worker's task never
        drags the (possibly huge) result blob over the wire."""
        return [self.hget(key, f) for f in fields]

    def setnx_field(
        self, key: str, field: str, value: str
    ) -> tuple[bool, str]:
        """Set ``field`` on ``key`` only if absent; return (created,
        current_value) — the mutual-exclusion primitive behind idempotent
        submits. Exactly one of N concurrent callers creates the field, and
        EVERY caller walks away with the winning value, so losers can
        compare payloads without a not-yet-written window.

        Backends override with a genuinely atomic form: the RESP client
        sends HSETNX+HGET (safe because claimed fields are write-once —
        the winner's later full-record write repeats the same value), the
        memory store uses its lock. This base default is check-then-set and
        only single-thread safe — production stores override it."""
        existing = self.hget(key, field)
        if existing is not None:
            return False, existing
        self.hset(key, {field: value})
        return True, value

    def setnx_fields(
        self, items: list[tuple[str, str]], field: str
    ) -> list[tuple[bool, str]]:
        """setnx_field over many (key, value) pairs. Default: a loop; the
        RESP client pipelines everything into one round trip."""
        return [self.setnx_field(key, field, value) for key, value in items]

    def hsetnx_many(
        self, items: list[tuple[str, str, str]]
    ) -> list[bool]:
        """Set-if-absent over arbitrary (key, field, value) triples —
        unlike ``setnx_fields`` the FIELD varies per item. Returns created
        flags parallel to ``items`` (no value read-back: callers of this
        form only need to know whether their write stood). The span
        plane's first-write-wins record flush rides this. Default: a
        loop; the RESP client pipelines one HSETNX round."""
        return [
            self.setnx_field(key, field, value)[0]
            for key, field, value in items
        ]

    def delete_many(self, keys: list[str]) -> None:
        """Batch delete. Default: a loop; the RESP client sends one DEL
        with all keys (the TTL sweeper's backlog purge)."""
        for key in keys:
            self.delete(key)

    def hget_many(self, keys: list[str], field: str) -> list[str | None]:
        """One field from many hashes. Default: a loop (one round trip per
        key); the RESP client overrides with a pipelined single round trip —
        this is what keeps the dispatcher's stranded-task rescan cheap as
        task history grows."""
        return [self.hget(k, field) for k in keys]

    def hgetall_many(self, keys: list[str]) -> list[dict[str, str]]:
        """Full records of many hashes, one dict per key ({} for a missing
        key — same shape as hgetall). Default: a loop; the RESP client
        pipelines one round trip. This is the dispatcher's batched-intake
        primitive: one round fetches every announced task's record instead
        of one hgetall per announce."""
        return [self.hgetall(k) for k in keys]

    def hgetall_many_raw(self, keys: list[str]) -> list[list]:
        """Full records of many hashes as FLAT ``[field, value, ...]``
        lists, one per key ([] for a missing key) — the columnar intake's
        read form (dispatch/base.py): no per-record dict is materialized.
        Elements are ``bytes`` on the RESP client's negotiated binary-batch
        path and ``str`` everywhere else; columnar consumers must accept
        both. Default: re-flatten hgetall_many."""
        return [
            [p for kv in rec.items() for p in kv]
            for rec in self.hgetall_many(keys)
        ]

    # -- content-addressed blobs ------------------------------------------
    def put_blob(self, digest: str, data: str) -> bool:
        """Put-if-absent write of a payload body under its content address.

        The data field is CLAIMED with setnx — write-once, the create-once
        protocol the race monitor enforces — and the TTL stamp is
        refreshed on every attempt (a dedup hit means the content is hot;
        the GC must not age it out under active producers). Returns True
        when this call created the blob. Two round trips on the loop
        default; the RESP client pipelines one."""
        key = blob_key(digest)
        created, _ = self.setnx_field(key, BLOB_DATA_FIELD, data)
        self.hset(key, {BLOB_AT_FIELD: repr(time.time())})
        return created

    def get_blob(self, digest: str) -> str | None:
        """The payload body for ``digest``, or None when the blob was never
        written (or was GC'd). Read-only: resolution must not perturb the
        TTL stamp — pinning is the referencing records' job."""
        return self.hget(blob_key(digest), BLOB_DATA_FIELD)

    def get_blobs(self, digests: list[str]) -> list[str | None]:
        """Pipelined multi-get of payload bodies (one round trip on RESP
        backends) — the dispatcher's warm-up path for a mixed batch of
        digests resolves them all at once."""
        return self.hget_many([blob_key(d) for d in digests], BLOB_DATA_FIELD)

    def create_tasks(
        self,
        tasks: list[tuple],  # (task_id, fn_payload, params[, extra_fields])
        channel: str = TASKS_CHANNEL,
        status: TaskStatus = TaskStatus.QUEUED,
    ) -> None:
        """Batch create_task. Each tuple is (task_id, fn_payload,
        param_payload) with an optional 4th element of extra hash fields.
        Default: a loop; the RESP client pipelines all writes + announces
        into one round trip (the gateway's batch-submit path). ``status``
        as in create_task — the graph submit creates its WAITING children
        in one pipelined batch before announcing the QUEUED roots."""
        for task in tasks:
            task_id, fn_payload, param_payload = task[:3]
            extra = task[3] if len(task) > 3 else None
            self.create_task(
                task_id, fn_payload, param_payload, channel, extra,
                status=status,
            )

    def get_payloads(self, task_id: str) -> tuple[str, str]:
        """Fetch (fn_payload, param_payload) in one round-trip —
        dispatcher-side read (reference task_dispatcher.py:48-52 does two
        HGETs; HGETALL halves the store RTTs on the intake hot path)."""
        fields = self.hgetall(task_id)
        if FIELD_FN not in fields or FIELD_PARAMS not in fields:
            raise KeyError(f"unknown task {task_id!r}")
        return fields[FIELD_FN], fields[FIELD_PARAMS]

    def set_status(
        self,
        task_id: str,
        status: TaskStatus | str,
        extra_fields: Mapping[str, str] | None = None,
    ) -> None:
        """``extra_fields`` ride in the same hash write (one round trip) —
        the RUNNING mark uses this to stamp its ownership lease."""
        fields = {FIELD_STATUS: str(status)}
        if extra_fields:
            fields.update(extra_fields)
        self.hset(task_id, fields)

    def set_status_many(
        self,
        status: TaskStatus | str,
        items: list[tuple[str, Mapping[str, str] | None]],
    ) -> None:
        """ONE status across many tasks, each item (task_id, extra_fields).
        The single shared ``status`` argument (rather than a status per
        item) is deliberate: it keeps the written status a static literal
        at call sites, so the protocol checker
        (tpu_faas/analysis/protocol.py) can prove a batch call never
        writes a terminal status — exactly as it proves plain set_status.
        Per-item ``extra_fields`` carry the ownership lease stamps of the
        dispatcher's coalesced RUNNING flush. Default: a loop; the RESP
        client pipelines one round trip."""
        for task_id, extra in items:
            self.set_status(task_id, status, extra_fields=extra)

    def finish_task_many(
        self,
        items: list[tuple],
        inline_max: int = 0,
    ) -> None:
        """Batch finish_task, each item (task_id, status, result,
        first_wins[, result_digest, result_size]) — the two optional
        trailing elements are the result-blob plane's digest form (absent
        or None on every legacy item). Sequential per-item semantics are
        the contract — including INTRA-batch first_wins: an earlier item's
        terminal write freezes a later first_wins item for the same id,
        exactly as if the items were applied one by one. Default: a loop;
        the RESP client collapses the batch into one status pre-read for
        the first_wins slice plus one pipelined write+announce round — the
        dispatcher's result drain and its deferred-result replay ride
        this. ``inline_max`` as in finish_task (express result lane)."""
        for item in items:
            task_id, status, result, first_wins = item[:4]
            self.finish_task(
                task_id, status, result,
                first_wins=first_wins, inline_max=inline_max,
                result_digest=item[4] if len(item) > 4 else None,
                result_size=int(item[5]) if len(item) > 5 else 0,
            )

    def hset_many(self, items: list[tuple[str, Mapping[str, str]]]) -> None:
        """Field writes across many hashes. Default: a loop; the RESP client
        pipelines one round trip — the dispatcher's in-flight lease renewal
        touches every in-flight task each period and must not pay a round
        trip per task."""
        for key, fields in items:
            self.hset(key, fields)

    def get_status(self, task_id: str) -> str | None:
        return self.hget(task_id, FIELD_STATUS)

    def finish_task(
        self,
        task_id: str,
        status: TaskStatus | str,
        result: str,
        first_wins: bool = False,
        inline_max: int = 0,
        result_digest: str | None = None,
        result_size: int = 0,
    ) -> None:
        """Record a terminal status + serialized result in one write
        (reference task_dispatcher.py:153-156, 284-295).

        With ``first_wins`` the record is frozen once terminal: a second
        result cannot overwrite what a client may already have observed. The
        re-dispatch upgrade makes two results for one task possible (zombie
        worker + replacement both finish it), so dispatchers pass
        ``first_wins=True`` exactly on those suspicious paths — the common
        path (first result from the task's current worker) stays one write,
        one RTT. The read-then-write pair is not atomic, but all result
        writes flow through the single dispatcher process, so there is no
        concurrent writer to race with.

        After the write the task_id is announced on RESULTS_CHANNEL (after,
        so a woken subscriber always reads the terminal record). The write
        also stamps FIELD_FINISHED_AT (epoch seconds) so a result-TTL
        sweeper can age the record out.

        ``inline_max`` > 0 (the express result lane, opt-in at the
        producing dispatcher) makes the announce carry status + result
        inline up to that many result bytes (encode_result_announce) —
        oversized results fall back to the classic id-only payload. The
        record write above stays authoritative and still precedes the
        announce.

        ``result_digest`` (result-blob plane): the digest form — the write
        additionally records FIELD_RESULT_DIGEST/FIELD_RESULT_SIZE, and
        ``result`` is typically EMPTY (the body stays in the producing
        worker's cache until something materializes it); the announce then
        carries the digest instead of a body. None (every legacy caller)
        leaves the record and announce bytes untouched."""
        if first_wins and self._result_frozen(task_id):
            return
        now = repr(time.time())
        fields = {
            FIELD_STATUS: str(status),
            # redundant status + stamp copies, same write: let a racing
            # cancel that clobbers this terminal record restore it
            # exactly (see cancel_task's post-write repair)
            FIELD_FINAL_STATUS: str(status),
            FIELD_FINAL_AT: now,
            FIELD_RESULT: result,
            FIELD_FINISHED_AT: now,
        }
        if result_digest:
            fields[FIELD_RESULT_DIGEST] = result_digest
            fields[FIELD_RESULT_SIZE] = str(int(result_size))
        self.hset(task_id, fields)
        self.hdel(LIVE_INDEX_KEY, task_id)
        self.publish(
            RESULTS_CHANNEL,
            encode_result_announce(
                task_id, str(status), result, inline_max,
                result_digest=result_digest, result_size=result_size,
            ),
        )

    def cancel_task(
        self, task_id: str, channel: str = TASKS_CHANNEL
    ) -> str | None:
        """Best-effort queued-only cancellation: QUEUED -> CANCELLED.

        Returns the record's status AFTER the attempt — "CANCELLED" when
        this (or an earlier) call cancelled it, the unchanged status when
        the task is RUNNING or already terminal, None when unknown. Built
        from plain hash primitives so any Redis-compatible backend supports
        it; the read-then-write pair is not atomic, and both racy
        interleavings against a concurrent dispatch resolve to the truth:

        - dispatch wins, result lands AFTER this write: the finish_task
          overwrite replaces the stale CANCELLED — transiently wrong,
          converges forward;
        - dispatch wins, result lands INSIDE the read->write window (a
          sub-millisecond task): this write clobbers the landed terminal
          record, so the post-write repair below re-reads the redundant
          FIELD_FINAL_STATUS stamp (written by every finish_task in the
          same hash write as its status) and restores the record exactly —
          returning the true terminal status, not "CANCELLED".

        A record mid-create (idempotency path: status claimed by setnx,
        payload fields still in flight) is reported unknown rather than
        cancelled — there is nothing dispatchable to cancel yet, and
        writing into the creator's window could strand its record.

        Dispatchers honor the cancel through two independent signals,
        either of which suffices: intake skips any announce whose record is
        no longer QUEUED, and the "<CANCEL_ANNOUNCE_PREFIX><task_id>"
        control message published here evicts the task from pending
        structures already drained from the bus (dispatch/base.py
        note_cancelled).

        The terminal write stamps FIELD_FINISHED_AT (result-TTL sweeper
        ages cancelled records like any other terminal record), drops the
        live-index entry, and announces on RESULTS_CHANNEL so parked
        /result long-polls wake immediately."""
        current = self.get_status(task_id)
        if current is None:
            return None
        if current != str(TaskStatus.QUEUED):
            return current
        # presence probes only (hexists): the payload fields can be
        # multi-MB and must not ride the wire just to prove the record is
        # fully created
        if not self.hexists(task_id, FIELD_PARAMS):
            # status QUEUED but no payload: a claim-only hash mid-create
            # (create_task_if_absent claims status via setnx, then writes
            # the fields in a second command). Writing CANCELLED here would
            # race the creator's field write — and the ghost cleanup below
            # could strip the claimed status out from under it, leaving a
            # status-less stranded record. Nothing dispatchable exists yet:
            # report unknown; the caller may retry once the create lands.
            return None
        self.hset(
            task_id,
            {
                FIELD_STATUS: str(TaskStatus.CANCELLED),
                FIELD_FINISHED_AT: repr(time.time()),
            },
        )
        # both repair stamps in ONE round trip (small fields, never payload)
        final, final_at = self.hmget(
            task_id, [FIELD_FINAL_STATUS, FIELD_FINAL_AT]
        )
        if not self.hexists(task_id, FIELD_PARAMS):
            # the record was DELETEd inside the read->write window (ran,
            # finished, was consumed and forgotten — all sub-ms): this
            # write just resurrected it as a partial ghost, which would
            # poison a later idempotency-keyed resubmit of the same id
            # (create_task_if_absent would see the ghost and swallow the
            # new submission). Remove OUR OWN fields — not DEL the key —
            # and report unknown: a recreate requires the status field to
            # be absent (create_task_if_absent claims it with setnx), so
            # field-level removal cannot destroy a record a resubmit
            # managed to recreate, while a DELETE landing after this probe
            # removes the whole hash itself, ghost included. A concurrent
            # idempotency CLAIM landing between probe and removal survives
            # as a claim-only hash, which the gateway's adoption wait and
            # the TTL sweeper's stale-claim GC already handle. The inverse
            # order — a resubmit's claim landing BEFORE our CANCELLED write
            # so this hdel strips it — is repaired from the CREATOR's side:
            # create_task_if_absent re-checks its status after the field
            # write and re-claims (see its claim-loss repair). The residual
            # six-event interleaving (creator's re-check passing on OUR
            # CANCELLED an instant before this hdel) leaves a record a
            # client retry of the same key repairs via the same re-claim;
            # accepted: it needs three actors inside two store RTTs.
            self.hdel(task_id, FIELD_STATUS, FIELD_FINISHED_AT)
            return None
        if final is not None:
            # a result landed inside the read->write window and this write
            # just clobbered it: restore the true terminal status AND its
            # finish stamp (the result payload was never touched — our
            # write carries no FIELD_RESULT)
            restore = {FIELD_STATUS: final}
            if final_at is not None:
                restore[FIELD_FINISHED_AT] = final_at
            self.hset(task_id, restore)
            self.publish(RESULTS_CHANNEL, task_id)
            return final
        self.hdel(LIVE_INDEX_KEY, task_id)
        self.publish(channel, CANCEL_ANNOUNCE_PREFIX + task_id)
        self.publish(RESULTS_CHANNEL, task_id)
        # a cancelled graph parent never completes: poison its frontier
        # (one small-field probe for non-graph tasks, nothing more)
        self.complete_dep_many([(task_id, str(TaskStatus.CANCELLED))], channel)
        return str(TaskStatus.CANCELLED)

    def expire_task(
        self, task_id: str, channel: str = TASKS_CHANNEL
    ) -> str | None:
        """Queue-deadline shed: QUEUED -> EXPIRED (terminal).

        Returns the record's status AFTER the attempt — "EXPIRED" when this
        call (or an earlier one) shed it, the unchanged status when the
        task already left QUEUED, None when unknown. Called only by the
        dispatcher that owns the task's pending copy (claim-gated in
        shared fleets), so unlike cancel_task there is no cross-process
        writer racing the happy path — the residual interleavings are a
        concurrent gateway cancel (both write a never-ran terminal; either
        standing is truthful, and the race monitor reports it as a
        warning, not an error) and a result landing inside the
        read->write window from a zombie of a previous reclaim
        generation, repaired below exactly like cancel_task repairs it:
        the redundant FIELD_FINAL_STATUS stamp every finish_task writes
        restores the record, and the true terminal status is returned.

        The terminal write stamps FIELD_FINISHED_AT (the result-TTL
        sweeper ages EXPIRED records like any other terminal record),
        drops the live-index entry, and announces on RESULTS_CHANNEL so
        parked /result long-polls wake immediately. No cancel-style
        control message rides the tasks channel: the shedder IS the
        dispatcher holding the pending copy — there is nothing to evict
        anywhere else."""
        current = self.get_status(task_id)
        if current is None:
            return None
        if current != str(TaskStatus.QUEUED):
            return current
        self.hset(
            task_id,
            {
                FIELD_STATUS: str(TaskStatus.EXPIRED),
                FIELD_FINISHED_AT: repr(time.time()),
            },
        )
        final, final_at = self.hmget(
            task_id, [FIELD_FINAL_STATUS, FIELD_FINAL_AT]
        )
        if final is not None:
            # a result landed inside the read->write window and this write
            # clobbered it: restore the true terminal status + finish stamp
            # (the result payload was never touched — no FIELD_RESULT here)
            restore = {FIELD_STATUS: final}
            if final_at is not None:
                restore[FIELD_FINISHED_AT] = final_at
            self.hset(task_id, restore)
            self.publish(RESULTS_CHANNEL, task_id)
            return final
        self.hdel(LIVE_INDEX_KEY, task_id)
        self.publish(RESULTS_CHANNEL, task_id)
        # a shed graph parent never completes: poison its frontier
        self.complete_dep_many([(task_id, str(TaskStatus.EXPIRED))], channel)
        return str(TaskStatus.EXPIRED)

    # -- task-graph promotion plane (tpu_faas/graph) -----------------------
    def complete_dep_many(
        self,
        parents: list[tuple[str, str]],
        channel: str = TASKS_CHANNEL,
    ) -> tuple[list[str], list[str]]:
        """Walk the forward dependency edges of terminal parent writes that
        LANDED: ``parents`` is (task_id, terminal_status) pairs. Returns
        (promoted_child_ids, poisoned_child_ids).

        COMPLETED parents decrement each child's pending count — exactly
        once per edge (a write-once ``dep_done:<parent>`` claim gates the
        atomic hincrby, so a zombie's duplicate terminal write cannot
        double-count) — and a count hitting zero flips the child
        WAITING -> QUEUED and announces it on the ordinary task bus, so
        promoted children flow through intake/admission/shedding
        unchanged. A parent that reached FAILED/EXPIRED/CANCELLED instead
        POISONS its children: WAITING -> FAILED with a
        ``dep_failed:<parent>`` error payload, never dispatched — and the
        poison walks the TRANSITIVE frontier iteratively (no recursion:
        graph depth must not meet Python's stack limit).

        Either way the child's exit from WAITING is arbitrated by the
        write-once FIELD_DEP_RESOLVED claim, so a promote racing a poison
        (two parents finishing oppositely from two processes) resolves to
        exactly one writer. Non-graph parents (no FIELD_CHILDREN) cost one
        pipelined small-field read and nothing else — and dispatchers skip
        even that for tasks whose records never carried children. Built
        from pipelined primitives only, so RESP backends pay a bounded
        number of rounds per generation of the walk."""
        from tpu_faas_torch.core.serialize import serialize  # lazy: dill is heavy

        promoted: list[str] = []
        poisoned: list[str] = []
        work = [(pid, str(status)) for pid, status in parents]
        while work:
            batch, work = work, []
            kid_lists = self.hget_many([p for p, _ in batch], FIELD_CHILDREN)
            ok_edges: list[tuple[str, str]] = []  # (parent, child)
            bad_edges: list[tuple[str, str, str]] = []  # (+ parent status)
            for (pid, status), kids in zip(batch, kid_lists):
                if not kids:
                    continue
                for child in kids.split(","):
                    if not child:
                        continue
                    if status == str(TaskStatus.COMPLETED):
                        ok_edges.append((pid, child))
                    else:
                        bad_edges.append((pid, child, status))
            if ok_edges:
                claims = self.hsetnx_many(
                    [(c, dep_done_field(p), "1") for p, c in ok_edges]
                )
                dec = [c for (_p, c), won in zip(ok_edges, claims) if won]
                counts = self.hincrby_many(
                    [(c, FIELD_PENDING_DEPS, -1) for c in dec]
                )
                ready = [c for c, n in zip(dec, counts) if n <= 0]
                if ready:
                    res = self.hsetnx_many(
                        [(c, FIELD_DEP_RESOLVED, "promote") for c in ready]
                    )
                    to_promote = [c for c, won in zip(ready, res) if won]
                    if to_promote:
                        # one pipelined status round + one announce round;
                        # the claim above makes this the ONLY writer moving
                        # these children out of WAITING
                        self.set_status_many(
                            TaskStatus.QUEUED,
                            [(c, None) for c in to_promote],
                        )
                        self.publish_many(channel, to_promote)
                        promoted.extend(to_promote)
            if bad_edges:
                claims = self.hsetnx_many(
                    [
                        (child, FIELD_DEP_RESOLVED, f"poison:{pid}")
                        for pid, child, _status in bad_edges
                    ]
                )
                items: list[tuple[str, TaskStatus, str, bool]] = []
                for (pid, child, status), won in zip(bad_edges, claims):
                    if not won:
                        # promoted, or already poisoned via another parent
                        continue
                    items.append(
                        (
                            child,
                            TaskStatus.FAILED,
                            serialize(
                                RuntimeError(
                                    f"{DEP_FAILED_PREFIX}{pid}: parent "
                                    f"reached {status}; this node was "
                                    "never dispatched"
                                )
                            ),
                            True,  # first_wins: never clobber a real result
                        )
                    )
                    poisoned.append(child)
                    work.append((child, str(TaskStatus.FAILED)))
                if items:
                    # one pipelined terminal round per poison generation
                    self.finish_task_many(items)
        return promoted, poisoned

    def resolve_waiting(
        self,
        task_id: str,
        parent_statuses: dict[str, str | None],
        channel: str = TASKS_CHANNEL,
    ) -> str | None:
        """Orphan repair for a WAITING node whose promotion was lost (its
        resolver crashed between claim and status write, or the decrement
        stream died with a dispatcher): given the node's parents' current
        statuses (None = record gone), apply the fate the graph protocol
        implies — poison if any parent is a never-ran/failed terminal OR
        vanished, promote if every parent COMPLETED, nothing if any parent
        is still live. Honors an existing FIELD_DEP_RESOLVED claim by
        re-applying ITS action (idempotent: the claimed action's writes
        converge), claims otherwise. Returns "promoted", "poisoned", or
        None (left alone). Used by the gateway's result-TTL sweeper; safe
        against a concurrent live promotion because both go through the
        same write-once claim."""
        from tpu_faas_torch.core.serialize import serialize

        if self.hget(task_id, FIELD_STATUS) != str(TaskStatus.WAITING):
            return None
        bad_parent: str | None = None
        bad_status = "MISSING"
        all_done = True
        for pid, status in parent_statuses.items():
            if status == str(TaskStatus.COMPLETED):
                continue
            all_done = False
            if status is None or TaskStatus.terminal_str(status):
                bad_parent, bad_status = pid, status or "MISSING"
            else:
                return None  # a parent is still live: not orphaned
        claim = self.hget(task_id, FIELD_DEP_RESOLVED)
        if claim is None:
            action = "promote" if all_done else (
                f"poison:{bad_parent}" if bad_parent is not None else None
            )
            if action is None:
                return None
            created, claim = self.setnx_field(
                task_id, FIELD_DEP_RESOLVED, action
            )
        if claim == "promote":
            if self.hget(task_id, FIELD_STATUS) == str(TaskStatus.WAITING):
                self.set_status(task_id, TaskStatus.QUEUED)
                self.publish(channel, task_id)
            return "promoted"
        parent = claim.split(":", 1)[1] if ":" in claim else "?"
        self.finish_task(
            task_id,
            TaskStatus.FAILED,
            serialize(
                RuntimeError(
                    f"{DEP_FAILED_PREFIX}{parent}: parent reached "
                    f"{bad_status}; this node was never dispatched"
                )
            ),
            first_wins=True,
        )
        # the repaired node may itself have children: poison them too
        self.complete_dep_many(
            [(task_id, str(TaskStatus.FAILED))], channel
        )
        return "poisoned"

    def request_kill(
        self, task_id: str, channel: str = TASKS_CHANNEL
    ) -> None:
        """Publish the force-cancel control message for a RUNNING task
        (see KILL_ANNOUNCE_PREFIX). Fire-and-forget like every announce."""
        self.publish(channel, KILL_ANNOUNCE_PREFIX + task_id)

    def _result_frozen(self, task_id: str) -> bool:
        """first_wins guard: True when the record must not be overwritten —
        already terminal, or absent (a record the client consumed and
        DELETEd must not be resurrected as a partial status+result hash by a
        zombie's late write).

        CANCELLED/EXPIRED do NOT freeze: a result can only reach a
        never-ran terminal record when that write LOST its race and the
        task actually executed (a genuinely-cancelled or shed task never
        dispatches, so nothing can produce a result for it) — e.g. the
        lost-race task's worker was purged, the reclaimed copy correctly
        dropped, and the zombie then delivered the genuine result via a
        first_wins path. Truth wins: freezing would pin 'never ran' over
        real side effects."""
        current = self.get_status(task_id)
        if current in (str(TaskStatus.CANCELLED), str(TaskStatus.EXPIRED)):
            return False
        # unknown=True: absent records and foreign status strings are
        # frozen — never overwrite what can't be parsed
        return TaskStatus.terminal_str(current, unknown=True)

    def get_result(self, task_id: str) -> tuple[str | None, str | None]:
        """(status, result) in one round-trip — the client poll hot path."""
        fields = self.hgetall(task_id)
        return fields.get(FIELD_STATUS), fields.get(FIELD_RESULT)

    def declare_redispatch(self, task_id: str) -> None:
        """Protocol-checker hook: the caller is about to re-mark ``task_id``
        RUNNING because it was reclaimed from a purged worker. No-op on real
        stores; ``racecheck.RaceCheckStore`` overrides it so its monitor can
        tell deliberate re-dispatch from a double-dispatch bug."""

    def declare_replica(self, task_id: str) -> None:
        """Protocol-checker hook (speculation plane, tpu_faas/spec): the
        caller is about to dispatch a HEDGE replica of a still-running
        ``task_id`` — a deliberate second RUNNING mark whose result race
        is arbitrated by finish_task's first-wins contract. No-op on real
        stores; ``racecheck.RaceCheckStore`` overrides it so its monitor
        can tell a declared hedge from a double-dispatch bug and prove no
        double-completion at runtime."""

    def __enter__(self) -> "TaskStore":
        return self

    def __exit__(self, *exc: object) -> None:
        self.close()
