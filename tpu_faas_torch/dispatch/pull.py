"""Pull dispatch mode: demand-driven REP/REQ.

Capability parity with reference PullDispatcher (task_dispatcher.py:105-187):
a REP socket where workers come asking for work; the defining constraint is
the REP/REQ lockstep — every received message MUST be answered in the same
cycle (reference comment at 163-167) — so each worker request is answered
with either a ``task`` or a ``wait``. TASKS are read off the announce bus
only when there is a requester to hand them to — the pull mode's implicit
back-pressure (SURVEY §2.3); CONTROL messages (cancel/kill) are drained
every loop regardless, with any task announces encountered parked in the
intake backlog (a saturated fleet must still honor cancellation, and
force-cancels ride the next mandatory reply as ``cancel_ids``).

Differences from the reference: the poll has a timeout so ``stop()`` works;
``result`` messages are answered with another task when one is pending (the
reference does this too via its inline re-listen — pull_worker.py:108-111 —
here it falls out of the uniform reply rule); and tasks handed out are
TRACKED per worker. The reference's pull mode keeps only a worker-id list
(task_dispatcher.py:150-151) — a pull worker that dies mid-task loses the
task exactly like its push mode does (README:262-264). Here every request
doubles as a liveness signal (workers poll on a delay cadence, and send a
keepalive even when saturated): a worker silent past ``time_to_expire`` is
presumed dead and its in-flight tasks are re-queued ahead of the bus, with
the same poison guard and first-wins result freezing as the push modes.
"""

from __future__ import annotations

import time
from collections import deque

import zmq

from tpu_faas_torch.dispatch.base import (
    STORE_OUTAGE_ERRORS,
    PendingTask,
    TaskDispatcher,
)
from tpu_faas_torch.worker import messages as m


class PullDispatcher(TaskDispatcher):
    def __init__(
        self,
        ip: str = "0.0.0.0",
        port: int = 5555,
        store_url: str = "memory://",
        store=None,
        channel: str = "tasks",
        poll_timeout_ms: int = 100,
        time_to_expire: float = 10.0,
        max_task_retries: int = 3,
        clock=time.monotonic,
        shared: bool = False,
    ) -> None:
        super().__init__(
            store_url=store_url, channel=channel, store=store, shared=shared
        )
        self.ctx = zmq.Context.instance()
        self.socket = self.ctx.socket(zmq.REP)
        if port == 0:
            port = self.socket.bind_to_random_port(f"tcp://{ip}")
        else:
            self.socket.bind(f"tcp://{ip}:{port}")
        self.port = port
        self.poll_timeout_ms = poll_timeout_ms
        self.poller = zmq.Poller()
        self.poller.register(self.socket, zmq.POLLIN)
        self.clock = clock
        self.time_to_expire = time_to_expire
        self.max_task_retries = max_task_retries
        self.workers: set[str] = set()
        #: worker_id -> negotiated capabilities (REGISTER ``caps``); empty
        #: (reference-era pull workers) keeps the inline ASCII contract
        self.worker_caps: dict[str, frozenset[str]] = {}
        #: liveness: every request stamps its sender (demand IS the
        #: heartbeat in pull mode — a healthy worker polls constantly)
        self.last_seen: dict[str, float] = {}
        #: in-flight tracking, the capability the reference's pull mode
        #: lacks entirely: task_id -> (owner worker_id, PendingTask)
        self.inflight: dict[str, tuple[str, PendingTask]] = {}
        self.worker_tasks: dict[str, set[str]] = {}
        #: tasks reclaimed from dead workers, served ahead of the bus
        self.requeued: deque[PendingTask] = deque()
        self.task_retries: dict[str, int] = {}
        self.n_reclaimed = 0

    def stats(self) -> dict:
        return {
            **super().stats(),
            "workers_registered": len(self.workers),
            "inflight": len(self.inflight),
            "requeued": len(self.requeued),
            "n_reclaimed": self.n_reclaimed,
        }

    def collect_metrics(self) -> None:
        super().collect_metrics()
        self.m_queue_depth.set(len(self.requeued))
        self.m_workers.set(len(self.workers))
        self.m_inflight.set(len(self.inflight))

    # -- dead-worker reclaim ----------------------------------------------
    def _purge_dead_workers(self) -> None:
        """Re-queue the in-flight tasks of workers silent past
        ``time_to_expire``. Store I/O first (fetch_reclaim raises on an
        outage), bookkeeping after, so an aborted purge simply retries."""
        now = self.clock()
        # every silent worker is purged, including ones holding nothing —
        # skipping idle deaths would leak a last_seen/workers entry per
        # autoscaler churn cycle forever
        dead = [
            wid
            for wid, seen in self.last_seen.items()
            if now - seen > self.time_to_expire
        ]
        for wid in dead:
            tasks = self.worker_tasks.get(wid, set())
            # phase 1 — store I/O only (poison-fail writes + payload
            # refetches, via the shared reclaim helper): an outage raises
            # out of here with every dict untouched, so the next purge
            # round retries the whole worker cleanly
            reclaims: list[PendingTask] = []
            for task_id in tasks:
                pt = self.reclaim_or_fail(
                    task_id,
                    self.task_retries.get(task_id, 0),
                    self.max_task_retries,
                )
                if pt is not None:
                    reclaims.append(pt)
            # phase 2 — bookkeeping only, cannot raise
            self.log.warning(
                "pull worker %s silent for %.1fs: re-queueing %d tasks",
                wid,
                now - self.last_seen.get(wid, now),
                len(reclaims),
            )
            for pt in reclaims:
                self.task_retries[pt.task_id] = pt.retries
                self.requeued.append(pt)
                self.n_reclaimed += 1
            for task_id in tasks:
                # incl. poison-failed + vanished records: drop tracking
                self.inflight.pop(task_id, None)
                if not any(p.task_id == task_id for p in reclaims):
                    self.task_retries.pop(task_id, None)
            self.worker_tasks.pop(wid, None)
            self.last_seen.pop(wid, None)
            self.worker_caps.pop(wid, None)
            self.workers.discard(wid)
            # fold the purged sender's cumulative misfire total into the
            # scalar (same per-worker bookkeeping bound as push/tpu-push)
            self.forget_worker_sender(wid)

    def _next_task(self) -> PendingTask | None:
        """Reclaimed tasks first (they have already waited once), then the
        bus. A reclaimed task that meanwhile finished (zombie worker beat
        the purge) is skipped — re-dispatching would regress its record."""
        while self.requeued:
            # peek, don't pop: task_is_finished is a store read that can
            # raise mid-outage — a popped task would be gone forever (pull
            # mode has no rescanner to find it again); peeked, it simply
            # waits for the next request (same pattern as push.py)
            pt = self.requeued[0]
            if self.drop_if_cancelled(pt.task_id):
                self.requeued.popleft()
                self.task_retries.pop(pt.task_id, None)
                continue
            if self.task_is_finished(pt.task_id):
                self.requeued.popleft()
                self.task_retries.pop(pt.task_id, None)
                continue
            self.requeued.popleft()
            return pt
        # bus tasks must be CLAIMED in shared mode (requeued ones above
        # are already ours) and deadline-shed if they lapsed while queued;
        # outage-safe via the base parking helpers
        return self.poll_next_admitted()

    def _kills_for(self, wid) -> list[str]:
        """Force-cancel ids among THIS worker's in-flight tasks, consumed
        from the kill notes. Pull workers cannot be pushed to (REQ/REP),
        so kills ride the next mandatory reply — TASK or WAIT — via the
        ``cancel_ids`` field."""
        if not self.kill_requested or wid is None:
            return []
        mine = self.worker_tasks.get(wid)
        if not mine:
            return []
        # iterate the worker's small in-flight set, not the note dict: a
        # shared fleet (or a '!kill:' flood) can hold up to the note cap
        # of unmatched sibling entries, and an O(notes) walk per REQ/REP
        # message is exactly the hazard base.relay_kills throttles against
        now = time.monotonic()
        hits: list[str] = []
        for t in mine:
            ts = self.kill_requested.get(t)
            if ts is None:
                continue
            self.kill_requested.pop(t, None)
            if now - ts > self.CANCEL_NOTE_TTL:
                # expired note (same TTL as base.relay_kills' age-out): an
                # idempotency-keyed resubmission reuses the SAME task id,
                # and a stale kill from a long-gone incarnation must never
                # interrupt the fresh one
                continue
            hits.append(t)
            self.log.info(
                "relayed force-cancel for task %s", t,
                extra={"task_id": t, "worker_id": wid},
            )
        return hits

    def start(self, max_results: int | None = None) -> int:
        """Serve worker requests; returns results recorded (for tests)."""
        n_results = 0
        last_renew = self.clock()
        try:
            while not self.stopping:
                if self.deferred_results or self.deferred_dep_completions:
                    self.flush_deferred_results()
                # control messages must flow even while no worker is
                # asking for tasks (saturated fleet mid-long-tasks)
                self.drain_control_messages()
                try:
                    # store failover: replay the announce ring so tasks
                    # announced on the dead primary re-enter intake
                    self.maybe_rearm_after_failover()
                    self._purge_dead_workers()
                    if self.clock() - last_renew >= self.lease_renew_period and (
                        self.inflight or self.shared
                    ):
                        # shared mode renews even while idle: the liveness
                        # heartbeat rides this write, and a silent sibling
                        # gets its claims adopted out from under it
                        self.renew_leases(self.inflight)
                        last_renew = self.clock()
                    # saturation signal for gateway admission control
                    self.maybe_publish_capacity(
                        pending=len(self.requeued)
                        + len(self._announce_backlog),
                        inflight=len(self.inflight),
                        capacity=max(len(self.workers), 1),
                        results=n_results,
                    )
                except STORE_OUTAGE_ERRORS as exc:
                    self.note_store_outage(exc, pause=0)
                events = dict(self.poller.poll(self.poll_timeout_ms))
                if self.socket not in events:
                    continue
                msg_type, data = m.decode(self.socket.recv())
                wid = data.get("worker_id")
                if wid is not None:
                    self.last_seen[wid] = self.clock()
                if msg_type == m.REGISTER:
                    self.workers.add(wid or "?")
                    caps = m.caps_of(data)
                    if wid is not None and caps:
                        self.worker_caps[wid] = caps
                    self.log.info("pull worker registered: %s", data)
                elif msg_type == m.BLOB_MISS:
                    # the mandatory reply IS the fill: resolve from the
                    # blob cache/store; an outage replies an EMPTY fill
                    # (no data, no missing) — "retry later" — because the
                    # REP socket must answer every request regardless
                    digest = data.get("digest")
                    fill: dict = {"digest": digest}
                    if isinstance(digest, str) and digest:
                        try:
                            payload = self.blob_lookup(digest)
                        except STORE_OUTAGE_ERRORS as exc:
                            self.note_store_outage(exc, pause=0)
                        else:
                            if payload is None:
                                fill["missing"] = True
                            else:
                                self.m_blob_fills.inc()
                                fill["data"] = payload
                    self.socket.send(
                        m.encode_for(
                            m.CAP_BIN
                            in self.worker_caps.get(wid or "", frozenset()),
                            m.BLOB_FILL,
                            **fill,
                        )
                    )
                    continue
                elif msg_type == m.RESULT:
                    task_id = data["task_id"]
                    self.note_worker_misfires(wid, data)
                    self.note_result_message(task_id, data)
                    owner_entry = self.inflight.get(task_id)
                    owner = owner_entry[0] if owner_entry else None
                    # a second result is possible when the task was ever
                    # re-dispatched, or this sender is not the tracked owner
                    # (zombie worker that outlived its purge)
                    suspicious = task_id in self.task_retries or (
                        owner is not None and owner != wid
                    )
                    self.record_result_safe(
                        data["task_id"],
                        data["status"],
                        data["result"],
                        first_wins=suspicious,
                    )
                    n_results += 1
                    if owner is None or owner == wid:
                        # the OWNER's result makes a pending kill moot; a
                        # zombie's stale result must NOT eat the kill for
                        # the live re-dispatched copy
                        self.kill_requested.pop(task_id, None)
                        self.inflight.pop(task_id, None)
                        self.task_retries.pop(task_id, None)
                        if owner is not None:
                            self.worker_tasks.get(owner, set()).discard(
                                task_id
                            )
                # READY carries no state; any message type falls through to
                # the mandatory reply — which MUST go out even mid-outage,
                # or the REP/REQ state machine wedges every worker. A
                # draining (or merely keepalive-ing) worker flags no_task:
                # its reply must be WAIT.
                if data.get("no_task"):
                    task = None
                else:
                    try:
                        task = self._next_task()
                    except STORE_OUTAGE_ERRORS as exc:
                        self.note_store_outage(exc, pause=0)
                        task = None
                caps = (
                    self.worker_caps.get(wid, frozenset())
                    if wid is not None
                    else frozenset()
                )
                blob = (
                    task is not None
                    and m.CAP_BLOB in caps
                    and task.fn_digest is not None
                )
                if task is not None and not blob:
                    # legacy hop: materialize the body; an outage parks
                    # the task back at the requeue head (its announce is
                    # spent) and the mandatory reply degrades to WAIT
                    try:
                        if not self.ensure_inline_payload(task):
                            task = None  # blob vanished: FAILed in place
                    except STORE_OUTAGE_ERRORS as exc:
                        self.note_store_outage(exc, pause=0)
                        self.requeued.appendleft(task)
                        task = None
                kill_ids = self._kills_for(wid)
                extra = {"cancel_ids": kill_ids} if kill_ids else {}
                if task is not None:
                    self.note_dispatch(task)
                    self.mark_running_safe(
                        task.task_id,
                        redispatch=bool(task.retries),
                        retries=task.retries,
                    )
                    if wid is not None:
                        self.inflight[task.task_id] = (wid, task)
                        self.worker_tasks.setdefault(wid, set()).add(
                            task.task_id
                        )
                    self.socket.send(
                        m.encode_for(
                            m.CAP_BIN in caps,
                            m.TASK,
                            **task.task_message_kwargs(
                                blob=blob, trace=m.CAP_TRACE in caps
                            ),
                            **extra,
                        )
                    )
                    self.note_payload_sent(task, blob)
                    self.traces.note(
                        task.task_id, "sent", count_dup=task.retries == 0
                    )
                    self.m_dispatched.inc()
                else:
                    self.socket.send(m.encode_for(m.CAP_BIN in caps, m.WAIT, **extra))
                if max_results is not None and n_results >= max_results:
                    break
        finally:
            self.socket.close(linger=0)
        return n_results
