"""Push dispatch mode: ROUTER/DEALER with load balancing + failure handling.

Capability parity with reference PushDispatcher (task_dispatcher.py:189-472),
all three variants behind constructor flags instead of separate loops:

- worker-LRU balancing (default): least-recently-used worker with >= 1 free
  process gets the next task (reference :251-322; OrderedDict LRU like the
  heartbeat variant's :327);
- ``process_lb=True``: balancing at process granularity — the free list holds
  one entry per free process, shuffled each round (reference :421-472);
- ``heartbeat=True``: heartbeat timestamps on every message, periodic purge
  of silent workers (TIME_TO_EXPIRE, reference :241-249), ``reconnect``
  handshake for zombies (:356-367), new/reconnected workers at the LRU front
  ("more prone to have resources", reference README:196-197).

Deliberate upgrades over the reference (SURVEY §5.3, §7):

- **in-flight tracking + re-dispatch**: every dispatched task is recorded;
  purging a worker re-queues its in-flight tasks ahead of the announce bus,
  so a worker crash delays tasks instead of losing them (the reference
  drops them; its README admits this at 262-264). Exactly-once-ish: once a
  second result becomes possible (a zombie's task was reclaimed, or a task
  was re-dispatched at least once) the first terminal store write wins and
  the record is frozen, so a late duplicate can never flip a delivered
  result.
- **batched dispatch**: drains the announce bus up to the fleet's free
  capacity each round instead of the reference's one task per tick.
- the worker-side heartbeat timer bug (reference push_worker.py:61-62 sends
  every iteration) and the double register (:47+53) are not reproduced.
"""

from __future__ import annotations

import random
import time
from collections import OrderedDict, deque
from dataclasses import dataclass, field

import zmq

from tpu_faas_torch.dispatch.base import (
    STORE_OUTAGE_ERRORS,
    PendingTask,
    TaskDispatcher,
)
from tpu_faas_torch.worker import messages as m


@dataclass
class WorkerRecord:
    """Dispatcher-side view of one push worker (reference
    task_dispatcher.py:203-212)."""

    num_processes: int
    free_processes: int
    last_heartbeat: float
    inflight: set[str] = field(default_factory=set)
    #: prior reclaim count per in-flight task (nonzero only for tasks that
    #: already survived a worker death) — consulted by the poison guard
    inflight_retries: dict[str, int] = field(default_factory=dict)
    #: negotiated protocol capabilities (REGISTER/RECONNECT ``caps``):
    #: empty for reference-era workers — full inline ASCII contract
    caps: frozenset[str] = frozenset()

    def is_alive(self, now: float, time_to_expire: float) -> bool:
        return (now - self.last_heartbeat) <= time_to_expire


class PushDispatcher(TaskDispatcher):
    def __init__(
        self,
        ip: str = "0.0.0.0",
        port: int = 5555,
        store_url: str = "memory://",
        store=None,
        channel: str = "tasks",
        heartbeat: bool = False,
        process_lb: bool = False,
        time_to_expire: float = 10.0,
        poll_timeout_ms: int = 5,
        max_task_retries: int = 3,
        clock=time.monotonic,
        shared: bool = False,
        batch_max: int = 0,
    ) -> None:
        super().__init__(
            store_url=store_url, channel=channel, store=store, shared=shared
        )
        #: batched worker data plane (opt-in, like tpu-push's --batch-max):
        #: >= 2 groups one dispatch round's sends into one TASK_BATCH
        #: frame per CAP_BATCH worker; 0 keeps the per-task wire verbatim
        self.batch_max = max(0, int(batch_max))
        self.ctx = zmq.Context.instance()
        self.socket = self.ctx.socket(zmq.ROUTER)
        if port == 0:
            port = self.socket.bind_to_random_port(f"tcp://{ip}")
        else:
            self.socket.bind(f"tcp://{ip}:{port}")
        self.port = port
        self.poller = zmq.Poller()
        self.poller.register(self.socket, zmq.POLLIN)
        self.heartbeat = heartbeat
        self.process_lb = process_lb
        self.time_to_expire = time_to_expire
        self.poll_timeout_ms = poll_timeout_ms
        self.max_task_retries = max_task_retries
        self.clock = clock

        self.workers: dict[bytes, WorkerRecord] = {}
        # LRU of worker ids with free capacity (value unused; OrderedDict
        # gives O(1) move-to-front/pop like reference :327)
        self.free_lru: OrderedDict[bytes, None] = OrderedDict()
        # process-LB variant: one entry per free process slot
        # a LIST, not a deque: the per-round shuffle swaps by position
        # (O(n^2) on a deque), and because the order is random anyway,
        # O(1) push/pop at the END replace popleft/appendleft
        self.free_procs: list[bytes] = []
        # cached fleet capacity for the compaction guard; refreshed on
        # membership/capacity events only, so _add_free stays O(1)
        self._fleet_procs = 0
        # tasks reclaimed from purged workers; dispatched before new intake
        self.requeue: deque[PendingTask] = deque()
        self.n_dispatched = 0
        self.n_results = 0
        self.n_purged = 0

    def collect_metrics(self) -> None:
        super().collect_metrics()
        self.m_queue_depth.set(len(self.requeue))
        self.m_workers.set(len(self.workers))
        try:
            self.m_inflight.set(
                sum(len(rec.inflight) for rec in self.workers.values())
            )
        except RuntimeError:
            # scrape raced a register/purge resizing the dict (this runs
            # on the stats thread): keep the previous value, next scrape
            # will see the settled state
            pass

    def _refresh_fleet_procs(self) -> None:
        """Recompute cached total capacity; called on the rare membership /
        capacity events (register, reconnect, purge, drain-drop) so the
        per-dispatch compaction guard stays O(1)."""
        self._fleet_procs = sum(
            r.num_processes for r in self.workers.values()
        )

    # -- free-capacity bookkeeping ----------------------------------------
    def _add_free(self, wid: bytes, front: bool = False) -> None:
        if self.process_lb:
            rec = self.workers[wid]
            self.free_procs.extend([wid] * rec.free_processes)
            # stale tokens are deleted lazily (_remove_free); a reconnect
            # storm could pile them up, so compact — O(fleet) — only on the
            # rare occasions the deque outgrows real capacity several-fold
            if len(self.free_procs) > 4 * max(self._fleet_procs, 1):
                self.free_procs = [
                    w
                    for w, r in self.workers.items()
                    for _ in range(r.free_processes)
                ]
        else:
            if wid not in self.free_lru:
                self.free_lru[wid] = None
                if front:
                    self.free_lru.move_to_end(wid, last=False)

    def _remove_free(self, wid: bytes) -> None:
        self.free_lru.pop(wid, None)
        # process-LB tokens are removed LAZILY: _pick_worker re-validates
        # every popped token against the live record (worker gone, or no
        # free process left -> token discarded), so eagerly rebuilding the
        # deque here — O(fleet processes) on every result/purge/register —
        # buys nothing. Stale tokens are self-cleaning: each is consumed
        # the first time it is popped.

    def _pick_worker(self) -> bytes | None:
        """Next worker with a free process, per the active balancing mode."""
        if self.process_lb:
            while self.free_procs:
                wid = self.free_procs.pop()
                rec = self.workers.get(wid)
                if rec is not None and rec.free_processes > 0:
                    return wid
            return None
        while self.free_lru:
            wid, _ = self.free_lru.popitem(last=False)  # LRU pop
            rec = self.workers.get(wid)
            if rec is not None and rec.free_processes > 0:
                return wid
        return None

    # -- message handling --------------------------------------------------
    def _handle(self, wid: bytes, msg_type: str, data: dict) -> None:
        now = self.clock()
        rec = self.workers.get(wid)
        if msg_type == m.REGISTER:
            self.workers[wid] = WorkerRecord(
                num_processes=int(data["num_processes"]),
                free_processes=int(data["num_processes"]),
                last_heartbeat=now,
                caps=m.caps_of(data),
            )
            self._refresh_fleet_procs()
            self._remove_free(wid)
            self._add_free(wid, front=True)
            self.log.info("push worker registered: %r x%s", wid, data)
            return
        if rec is None:
            # unknown sender (e.g. we restarted, or it was purged): create a
            # zero-capacity record and ask it to re-announce itself
            # (reference :356-358); its RECONNECT reply below restores the
            # real capacity.
            if self.heartbeat:
                rec = self.workers[wid] = WorkerRecord(
                    num_processes=0, free_processes=0, last_heartbeat=now
                )
                self._send(wid, m.encode(m.RECONNECT))
                if msg_type not in (m.RECONNECT, m.RESULT, m.RESULT_BATCH):
                    return
            else:
                return
        rec.last_heartbeat = now
        if msg_type == m.DEREGISTER:
            # graceful drain: stop assigning to this worker; its in-flight
            # results still arrive below, and the record is dropped as soon
            # as the last one lands (or by purge if it dies mid-drain)
            rec.num_processes = 0
            rec.free_processes = 0
            self._refresh_fleet_procs()
            self._remove_free(wid)
            self.log.info(
                "worker %r draining (%d in flight)", wid, len(rec.inflight)
            )
            if not rec.inflight:
                self.workers.pop(wid, None)
                self.forget_worker_sender(wid)
            return
        if msg_type == m.RESULT:
            self.note_worker_misfires(wid, data)
            self._handle_result(wid, rec, data)
        elif msg_type == m.RESULT_BATCH:
            # batched result lane: K results in one frame, each running
            # the full per-task path (slot release, drain-drop, zombie
            # guards) exactly like K RESULT frames. A draining worker's
            # record can drop mid-batch (its last in-flight result
            # landed); later elements still get their store writes, as
            # unknown-sender results would.
            self.note_worker_misfires(wid, data)
            for item in data.get("results", ()):
                if isinstance(item, dict) and "task_id" in item:
                    self._handle_result(wid, self.workers.get(wid), item)
        elif msg_type == m.BLOB_MISS:
            # payload-plane resolution request (blob-capable workers only)
            self._serve_blob_miss(wid, rec, data)
        elif msg_type == m.RECONNECT:
            # zombie rejoining: trust its reported current capacity and put
            # it at the LRU front (reference :360-367)
            caps = m.caps_of(data)
            if caps:
                rec.caps = caps
            rec.free_processes = int(data.get("free_processes", 0))
            rec.num_processes = max(rec.num_processes, rec.free_processes)
            self._refresh_fleet_procs()
            self._remove_free(wid)
            if rec.free_processes > 0:
                self._add_free(wid, front=True)
        elif msg_type == m.HEARTBEAT:
            pass  # timestamp already refreshed above

    def _handle_result(
        self, wid: bytes, rec: WorkerRecord | None, data: dict
    ) -> None:
        """One result's full per-task path (shared by RESULT frames and
        RESULT_BATCH elements). ``rec`` may be None for a late batch
        element after a draining worker's record dropped mid-frame — the
        store write still lands (first-wins suspicious), there is just no
        slot to release."""
        task_id = data["task_id"]
        self.note_result_message(task_id, data)
        # suspicious = a second result is possible: the sender doesn't
        # hold the task (zombie whose task was reclaimed), or the task
        # was reclaimed at least once before reaching this worker
        suspicious = (
            rec is None
            or task_id not in rec.inflight
            or task_id in rec.inflight_retries
        )
        self.record_result_safe(
            task_id, data["status"], data["result"], first_wins=suspicious
        )
        self.n_results += 1
        # Only a result for a task this worker actually holds releases a
        # process slot: a zombie's stale result (its task was reclaimed
        # and it re-registered) must not over-commit its pool.
        if rec is not None and task_id in rec.inflight:
            rec.inflight.discard(task_id)
            rec.inflight_retries.pop(task_id, None)
            if rec.num_processes == 0:
                # draining worker: last in-flight result drops the record
                if not rec.inflight:
                    self.workers.pop(wid, None)
                    self._refresh_fleet_procs()
                    self.forget_worker_sender(wid)
                return
            rec.free_processes = min(
                rec.free_processes + 1, rec.num_processes
            )
            if self.process_lb:
                self.free_procs.append(wid)
            else:
                self._add_free(wid)

    def _send(self, wid: bytes, payload: bytes) -> None:
        self.send_wire(wid, payload)  # one send point: base.send_wire

    def _serve_blob_miss(self, wid: bytes, rec: WorkerRecord, data: dict) -> None:
        """Answer a worker's payload-cache miss (same contract as
        tpu_push's: outage drops the request — the worker re-asks on its
        parked-task timer; a definitively-gone blob is ``missing=True``)."""
        digest = data.get("digest")
        if not isinstance(digest, str) or not digest:
            return
        try:
            payload = self.blob_lookup(digest)
        except STORE_OUTAGE_ERRORS as exc:
            self.note_store_outage(exc, pause=0)
            return
        bin_cap = m.CAP_BIN in rec.caps
        if payload is None:
            self._send(
                wid, m.encode_for(bin_cap, m.BLOB_FILL, digest=digest, missing=True)
            )
            return
        self.m_blob_fills.inc()
        self._send(
            wid, m.encode_for(bin_cap, m.BLOB_FILL, digest=digest, data=payload)
        )

    # -- purge + re-dispatch (the recovery the reference lacks) ------------
    def purge_workers(self) -> list[bytes]:
        now = self.clock()
        dead = [
            wid
            for wid, rec in self.workers.items()
            if not rec.is_alive(now, self.time_to_expire)
        ]
        for wid in dead:
            rec = self.workers[wid]
            # phase 1 — store I/O only: a store outage raises out of here
            # with the worker record untouched, so the next purge round
            # simply retries it (nothing reclaimed is lost half-way)
            reclaims: list[PendingTask] = []
            for task_id in rec.inflight:
                # shared poison-guard + full hint rebuild (a re-dispatched
                # runaway keeps its timeout budget, a high-priority task its
                # admission class); None = failed or payloads vanished
                pt = self.reclaim_or_fail(
                    task_id,
                    rec.inflight_retries.get(task_id, 0),
                    self.max_task_retries,
                )
                if pt is not None:
                    reclaims.append(pt)
            # phase 2 — bookkeeping only, cannot raise
            self.workers.pop(wid)
            self._refresh_fleet_procs()
            self._remove_free(wid)
            # fold the purged sender's cumulative misfire total into the
            # scalar; the identity is never seen again, and keeping the
            # entry leaked one dict slot per purge forever
            self.forget_worker_sender(wid)
            self.requeue.extend(reclaims)
            self.n_purged += 1
            self.m_purged.inc()
            if rec.inflight:
                self.log.warning(
                    "purged %r; re-queued %d in-flight tasks",
                    wid,
                    len(rec.inflight),
                )
        return dead

    # -- dispatch ----------------------------------------------------------
    def _next_task(self) -> PendingTask | None:
        while self.requeue:
            # peek, don't pop: the status check can raise mid store outage,
            # and a popped reclaimed task would be lost forever (its record
            # is RUNNING — no rescan ever re-adopts it)
            task = self.requeue[0]
            if self.drop_if_cancelled(task.task_id):
                self.requeue.popleft()
                continue
            # a reclaimed task may have been finished meanwhile by its zombie
            # worker; re-dispatching it would mark a terminal record RUNNING
            # and re-run it — drop it instead
            if self.task_is_finished(task.task_id):
                self.requeue.popleft()
                continue
            self.requeue.popleft()
            return task
        # bus tasks must be CLAIMED in shared mode (requeued ones above
        # are already ours) and deadline-shed if they lapsed while queued;
        # outage-safe via the base parking helpers. (Requeued tasks carry
        # retries > 0 and are exempt from shedding by protocol.)
        return self.poll_next_admitted()

    def _relay_kills(self) -> None:
        def owner(tid: str):
            return next(
                (
                    wid
                    for wid, rec in self.workers.items()
                    if tid in rec.inflight
                ),
                None,
            )

        self.relay_kills(
            owner,
            lambda wid, tid: self._send(
                wid, m.encode(m.CANCEL, task_id=tid)
            ),
        )

    def _dispatch_round(self) -> int:
        """Hand out tasks while there is free capacity and pending work.
        With batching on, a round's sends to each CAP_BATCH worker group
        into one TASK_BATCH frame (flushed in the finally — a task is
        tracked in its record's inflight set the moment it is buffered,
        so the frame must reach the wire even on an outage abort)."""
        sent = 0
        task_frames: dict = {}
        try:
            sent = self._dispatch_round_inner(task_frames)
        finally:
            self.flush_task_frames(task_frames)
        if self.process_lb:
            random.shuffle(self.free_procs)  # reference :469-472
        return sent

    def _dispatch_round_inner(self, task_frames: dict) -> int:
        sent = 0
        while True:
            wid = self._pick_worker()
            if wid is None:
                break
            try:
                task = self._next_task()
            except STORE_OUTAGE_ERRORS:
                # restore the picked worker before surfacing the outage, or
                # an idle worker vanishes from rotation until its next message
                if self.process_lb:
                    self.free_procs.append(wid)
                else:
                    self._add_free(wid, front=True)
                raise
            if task is None:
                # nothing pending: put back exactly what was popped
                if self.process_lb:
                    self.free_procs.append(wid)
                else:
                    self._add_free(wid, front=True)
                break
            rec = self.workers[wid]
            blob = m.CAP_BLOB in rec.caps and task.fn_digest is not None
            if not blob:
                # legacy hop: materialize the body before any bookkeeping
                try:
                    inline_ok = self.ensure_inline_payload(task)
                except STORE_OUTAGE_ERRORS:
                    # park the task (its announce is spent) and restore
                    # the picked worker before surfacing the outage
                    self.requeue.appendleft(task)
                    if self.process_lb:
                        self.free_procs.append(wid)
                    else:
                        self._add_free(wid, front=True)
                    raise
                if not inline_ok:
                    # blob vanished: task FAILed in place; worker returns
                    # to rotation and the round moves on
                    if self.process_lb:
                        self.free_procs.append(wid)
                    else:
                        self._add_free(wid, front=True)
                    continue
            self.note_dispatch(task)
            self.send_task_frame(task_frames, wid, rec.caps, task, blob)
            self.note_payload_sent(task, blob)
            self.traces.note(
                task.task_id, "sent", count_dup=task.retries == 0
            )
            self.mark_running_safe(
                task.task_id,
                redispatch=bool(task.retries),
                retries=task.retries,
            )
            rec.inflight.add(task.task_id)
            if task.retries:
                rec.inflight_retries[task.task_id] = task.retries
            rec.free_processes -= 1
            sent += 1
            self.n_dispatched += 1
            self.m_dispatched.inc()
            # LRU mode re-appends the worker at the back while it still has
            # capacity; in process-LB mode its remaining slots are already
            # individually present in free_procs (one entry was popped per
            # dispatch), so re-adding would duplicate entries without bound.
            if not self.process_lb and rec.free_processes > 0:
                self._add_free(wid)  # back of the LRU
        return sent

    def start(self, max_results: int | None = None) -> int:
        last_renew = time.monotonic()
        try:
            while not self.stopping:
                self.flush_chaos_wire()  # no-op unless wire.delay armed
                events = dict(self.poller.poll(self.poll_timeout_ms))
                if self.socket in events:
                    # bounded drain (base.drain_worker_messages): a
                    # flooding worker must not starve purge + dispatch
                    self.drain_worker_messages(self.socket, self._handle)
                # store ops degrade (and retry next round) during an outage
                # instead of crashing the dispatcher
                try:
                    if self.heartbeat:
                        self.purge_workers()
                    if self.deferred_results or self.deferred_dep_completions:
                        self.flush_deferred_results()
                    # store failover: replay the announce ring so tasks
                    # announced on the dead primary re-enter intake (the
                    # push mode has no rescan; the replay is its re-arm)
                    self.maybe_rearm_after_failover()
                    now = time.monotonic()
                    if now - last_renew >= self.lease_renew_period:
                        inflight = [
                            tid
                            for rec in self.workers.values()
                            for tid in rec.inflight
                        ]
                        self.renew_leases(inflight)
                        last_renew = now
                    self._dispatch_round()
                    # a saturated fleet stops polling the bus for tasks;
                    # control messages must still flow
                    self.drain_control_messages()
                    self._relay_kills()
                    # saturation signal for gateway admission control
                    self.maybe_publish_capacity(
                        pending=len(self.requeue)
                        + len(self._announce_backlog),
                        inflight=sum(
                            len(rec.inflight)
                            for rec in self.workers.values()
                        ),
                        capacity=sum(
                            rec.num_processes
                            for rec in self.workers.values()
                        ),
                        results=self.n_results,
                    )
                except STORE_OUTAGE_ERRORS as exc:
                    self.note_store_outage(exc)
                if max_results is not None and self.n_results >= max_results:
                    break
        finally:
            self.socket.close(linger=0)
        return self.n_results
