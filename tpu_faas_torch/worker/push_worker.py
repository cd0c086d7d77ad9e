"""Push worker: DEALER socket + local process pool.

Capability parity with reference PushWorker (push_worker.py:10-140): register
with ``num_processes`` (the dispatcher does admission control — the worker
never refuses a task, reference README:231), execute whatever arrives, ship
results as they finish. With ``--hb``: send a heartbeat every
``heartbeat_period`` seconds and answer the dispatcher's ``reconnect``
request with the current free-process count (reference push_worker.py:76-82).

Reference bugs fixed, not copied (SURVEY §7.5): the heartbeat timestamp is
actually updated after sending (the reference never updates
``last_sent_heartbeat`` so it spams one per loop iteration,
push_worker.py:61-62), and registration happens exactly once
(the reference's start_heartbeat registers twice, :47+53).

CLI: ``python -m tpu_faas.worker.push_worker N tcp://host:port [--hb]``
(reference push_worker.py:143-166).
"""

from __future__ import annotations

import argparse
import time
import uuid

import zmq

from tpu_faas_torch.core.payload import PayloadLRU, payload_digest
from tpu_faas_torch.core.serialize import serialize
from tpu_faas_torch.core.task import TaskStatus
from tpu_faas_torch.utils.logging import get_logger, log_ctx
from tpu_faas_torch.worker import messages as m
from tpu_faas_torch.worker.pool import (
    FN_CACHE_HITS,
    FN_CACHE_MISSES,
    RESULT_CACHE_HITS,
    RESULT_CACHE_MISSES,
    TaskPool,
)

log = get_logger("push_worker")

#: How long a parked task waits on an unanswered BLOB_MISS before the
#: worker re-asks (fills ride the same lossy transport as everything else).
_MISS_RESEND_S = 2.0


class PushWorker:
    def __init__(
        self,
        num_processes: int,
        dispatcher_url: str,
        heartbeat: bool = False,
        heartbeat_period: float = 1.0,
        poll_timeout_ms: int = 10,
        token: str | None = None,
        caps: tuple[str, ...] = m.WORKER_CAPS,
        fn_cache_bytes: int = 256 * 1024 * 1024,
        result_cache_bytes: int = 256 * 1024 * 1024,
    ) -> None:
        self.num_processes = num_processes
        #: stable identity for the estimator's speed grades: carried on
        #: REGISTER and RECONNECT so the grade survives socket churn and
        #: dispatcher restarts; a supervisor (worker/deploy.py) passes a
        #: slot-stable token so even a crash-respawned worker keeps the
        #: machine's grade. A self-minted uuid default is flagged EPHEMERAL
        #: on the wire: it will never be presented again after this
        #: process dies, so the dispatcher grades it in memory only (no
        #: store persistence, forgotten on purge) — otherwise every ad-hoc
        #: restart leaks one WORKER_STATS_KEY entry forever
        self.token_is_ephemeral = token is None
        self.token = token or uuid.uuid4().hex
        self.heartbeat = heartbeat
        self.heartbeat_period = heartbeat_period
        self.poll_timeout_ms = poll_timeout_ms
        #: protocol capabilities advertised on REGISTER/RECONNECT (payload
        #: plane); () runs the pure reference contract — used by tests and
        #: as an operator escape hatch
        self.caps: tuple[str, ...] = tuple(caps)
        #: digest -> serialized body: the parent-side half of the codec
        #: cache (the child-side half caches DESERIALIZED functions,
        #: core/executor.py). Filled by BLOB_FILLs and by inline payloads
        #: seen with a digest attached.
        self.fn_cache = PayloadLRU(fn_cache_bytes)
        #: digest -> serialized RESULT body (result-blob plane): filled by
        #: this worker's own completed results that shipped digest-only,
        #: and by BLOB_FILLs answering a dep-digest miss. The dispatcher's
        #: locality lane steers graph children here, and dispatcher->worker
        #: BLOB_MISS pulls materialize store copies from it on demand.
        self.result_cache = PayloadLRU(result_cache_bytes)
        #: task_id -> rblob_min carried on that task's TASK frame: the
        #: dispatcher's per-task proof + threshold that ITS completed
        #: result may ship digest-only (set only for graph-consumed tasks)
        self._task_rblob: dict[str, int] = {}
        #: digest -> which cache a BLOB_FILL for it belongs to ("result"
        #: for dep-digest misses; absent = "fn", the historical default)
        self._miss_kind: dict[str, str] = {}
        #: task_id -> distributed trace id (TASK ``trace_id``, present only
        #: when this worker advertised CAP_TRACE to a tracing dispatcher):
        #: stamped into logs and echoed on the matching RESULT; entries
        #: live exactly as long as the task is held here
        self._task_trace: dict[str, str] = {}
        #: digest -> TASK payload dicts parked on an outstanding miss
        self._awaiting: dict[str, list[dict]] = {}
        #: digest -> monotonic time the last BLOB_MISS went out
        self._miss_sent: dict[str, float] = {}
        #: True once a binary frame arrived from the dispatcher — proof it
        #: decodes them; our own sends switch to binary from then on
        self._peer_bin = False
        #: True once a TASK_BATCH frame arrived — proof the dispatcher
        #: speaks the batched data plane; the result drain then coalesces
        #: multi-result shipments into RESULT_BATCH frames (same
        #: asymmetric negotiation as binary framing: advertising CAP_BATCH
        #: alone never changes this worker's sends)
        self._peer_batch = False
        self.pool = TaskPool(num_processes)
        self.ctx = zmq.Context.instance()
        self.socket = self.ctx.socket(zmq.DEALER)
        self.socket.setsockopt(zmq.LINGER, 0)
        self.socket.connect(dispatcher_url)
        self.poller = zmq.Poller()
        self.poller.register(self.socket, zmq.POLLIN)
        # pool-completion wakeup: a finished task pokes this fd, so the
        # serving loop drains + ships results the moment they land instead
        # of waiting out poll_timeout — the worker-side analog of the
        # dispatcher's event-driven (express) intake
        self.poller.register(self.pool.wakeup_fd, zmq.POLLIN)
        self._stopping = False
        self._draining = False
        #: fault-injection seams (tpu_faas/chaos), None when
        #: TPU_FAAS_CHAOS is unset: the wire seam wraps _send (drop/dup/
        #: delay on this worker's frames — heartbeats included, which is
        #: how gray network paths are modeled), the exec seam runs
        #: before pool submission (slow / crash_before) and after
        #: results ship (crash_after). REGISTER stays un-injected: it is
        #: the instance's birth certificate, and a scenario that wants a
        #: never-registering worker simply doesn't start one.
        from tpu_faas_torch import chaos as _chaos

        _plan = _chaos.from_env()
        self._chaos_wire = _plan.wire() if _plan is not None else None
        self._chaos_exec = _plan.execution() if _plan is not None else None

    def stop(self) -> None:
        self._stopping = True

    def drain(self) -> None:
        """Graceful shutdown: deregister (dispatcher stops assigning), keep
        serving until every in-flight task's result has shipped, then exit.
        Contrast with a hard kill, where in-flight tasks are recovered only
        by heartbeat-timeout purge + re-dispatch."""
        self._draining = True

    def _send(self, msg_type: str, **data: object) -> None:
        """Frame per the negotiated state: binary once the dispatcher has
        proven (by sending one) that it decodes binary frames, ASCII until
        then — so a reference-style dispatcher never sees a frame it can't
        decode. The one worker->dispatcher send point: the chaos wire
        seam lives here (dup is safe — results are at-least-once and the
        dispatcher's from_owner/terminal checks already tolerate
        replays)."""
        payload = m.encode_for(self._peer_bin, msg_type, **data)
        if self._chaos_wire is not None:
            self._chaos_wire.send(payload, self.socket.send)
            return
        self.socket.send(payload)

    def register(self) -> None:
        # REGISTER always rides the ASCII contract (first contact: the
        # peer's decoder is unknown); the caps list inside it is what
        # unlocks digest shipping + binary framing from the other side
        self.socket.send(
            m.encode(
                m.REGISTER,
                num_processes=self.num_processes,
                token=self.token,
                ephemeral=self.token_is_ephemeral,
                caps=list(self.caps),
            )
        )

    # -- payload plane -----------------------------------------------------
    def _submit_task(
        self, data: dict, from_fill: bool = False, collect: list | None = None
    ) -> bool:
        """Resolve one TASK message's function body and put it on the
        pool. Digest-only tasks (payload plane) hit the parent cache; a
        miss parks the task and asks the dispatcher with BLOB_MISS —
        False means parked, not submitted. ``from_fill`` (the fill
        handler resubmitting a parked task) skips the hit/miss counters:
        that resolution was already counted as its original miss.
        ``collect`` (the TASK_BATCH path): a resolved task is appended as
        a pool-submit tuple instead of submitted, so the caller can bundle
        the whole batch into O(1) pool IPC messages — parking semantics
        are unchanged (a parked task misses its bundle and rides a
        classic submit when its fill lands)."""
        digest = data.get("fn_digest")
        trace_id = data.get("trace_id")
        if isinstance(trace_id, str) and trace_id:
            self._task_trace[data["task_id"]] = trace_id
            log.debug(
                "task received", extra=log_ctx(
                    task_id=data["task_id"], trace_id=trace_id
                ),
            )
        payload = data.get("fn_payload")
        if payload is None:
            payload = self.fn_cache.get(digest) if digest else None
            if payload is None:
                if not from_fill:
                    FN_CACHE_MISSES.inc()
                self._awaiting.setdefault(digest, []).append(data)
                if digest not in self._miss_sent:
                    self._send(m.BLOB_MISS, digest=digest)
                    self._miss_sent[digest] = time.monotonic()
                return False
            if not from_fill:
                FN_CACHE_HITS.inc()
        elif digest:
            # inline body with a digest attached: warm the cache so a
            # later digest-only TASK (dispatcher upgraded mid-stream)
            # needs no fill round
            self.fn_cache.put(digest, payload)
        ok, deps = self._resolve_deps(data, from_fill)
        if not ok:
            return False
        rb = data.get("rblob_min")
        if isinstance(rb, int) and rb > 0 and m.CAP_RESULT_BLOB in self.caps:
            # the dispatcher's per-task digest-ship permission: remember it
            # until this task's result is framed
            self._task_rblob[data["task_id"]] = rb
        if self._chaos_exec is not None:
            # exec chaos (slow / crash_before) runs in the serve thread,
            # ahead of pool handoff: a gray worker stalls its whole
            # intake (the failure shape the health plane must catch),
            # and a crash kills the WORKER — the dispatcher's liveness
            # machinery reclaims, so no task reaches a terminal FAILED
            self._chaos_exec.before_task(data["task_id"])
        if collect is not None:
            item = (
                data["task_id"],
                payload,
                data["param_payload"],
                data.get("timeout"),
                digest,
            )
            # 6th element only when parents were delivered: flat tasks keep
            # the historical 5-tuple shape
            collect.append(item if deps is None else item + (deps,))
            return True
        self.pool.submit(
            data["task_id"],
            payload,
            data["param_payload"],
            timeout=data.get("timeout"),
            fn_digest=digest,
            dep_results=deps,
        )
        return True

    def _resolve_deps(self, data: dict, from_fill: bool):
        """Resolve a graph child's delivered parent results (result-blob
        plane): ``dep_results`` bodies ride the frame as-is;
        ``dep_digests`` hit the result cache, and the FIRST missing digest
        parks the task (BLOB_MISS with kind=result) — fills re-resolve
        incrementally, so a multi-miss child serializes its fetches (rare
        by construction: the dispatcher only ships digests it believes
        this cache already holds). Returns (ok, deps); ok False = parked.
        """
        bodies = data.get("dep_results")
        digests = data.get("dep_digests")
        if not bodies and not digests:
            return True, None
        deps: dict[str, str] = dict(bodies) if isinstance(bodies, dict) else {}
        if isinstance(digests, dict):
            for pid, dg in digests.items():
                if not isinstance(dg, str) or not dg:
                    continue
                body = self.result_cache.get(dg)
                if body is None:
                    if not from_fill:
                        RESULT_CACHE_MISSES.inc()
                    self._miss_kind[dg] = "result"
                    self._awaiting.setdefault(dg, []).append(data)
                    if dg not in self._miss_sent:
                        self._send(m.BLOB_MISS, digest=dg)
                        self._miss_sent[dg] = time.monotonic()
                    return False, None
                if not from_fill:
                    RESULT_CACHE_HITS.inc()
                deps[pid] = body
        return True, deps or None

    # -- batched data plane ------------------------------------------------
    def _on_task_batch(self, data: dict) -> None:
        """One TASK_BATCH frame: resolve every element (identical per-task
        semantics — digest cache, BLOB_MISS parking, trace stamping), then
        spread the ready set over the pool's free children as bundles, so
        K tasks cost ~min(K, free) pool IPC messages instead of K.
        Receiving this frame is also the negotiation proof that flips this
        worker's own result drain to RESULT_BATCH framing."""
        self._peer_batch = True
        ready: list[tuple] = []
        for item in data.get("tasks", ()):
            if isinstance(item, dict) and "task_id" in item:
                self._submit_task(item, collect=ready)
        self._submit_bundles(ready)

    #: floor on bundle size when chunking a TASK_BATCH across free pool
    #: children: below this, per-task pool IPC dominates sub-ms execution
    #: and splitting buys nothing — the dispatcher already bounds a frame
    #: at the worker's free slots, so free-proportional chunking alone
    #: would degenerate every frame into singletons
    _MIN_BUNDLE = 4

    def _submit_bundles(self, ready: list[tuple]) -> None:
        """Chunk resolved tasks into bundles balancing the two costs:
        bundling amortizes pool IPC (the batched plane's point), while
        one huge bundle would serialize everything through a single child.
        The batch splits into min(free_children, K // _MIN_BUNDLE)
        contiguous bundles (at least one) — large frames still fan out
        across children in >= _MIN_BUNDLE chunks, small frames ride one
        bundle whose sequential execution is cheaper than per-task IPC.
        Sequential-in-child is the deliberate tradeoff batching buys its
        throughput with: for the sub-ms functions the plane targets, a
        bundle's serial execution is noise next to the saved per-task
        overhead, while long-running functions should keep --batch-max
        off/small dispatcher-side (documented in OPERATIONS.md)."""
        if not ready:
            return
        n_bundles = max(
            1, min(self.pool.free, len(ready) // self._MIN_BUNDLE)
        )
        size = -(-len(ready) // n_bundles)  # ceil
        for lo in range(0, len(ready), size):
            self.pool.submit_bundle(ready[lo:lo + size])

    def _on_blob_fill(self, data: dict) -> None:
        digest = data.get("digest")
        if not isinstance(digest, str) or not digest:
            return
        kind = self._miss_kind.get(digest, "fn")
        body = data.get("data")
        if isinstance(body, str):
            cache = self.result_cache if kind == "result" else self.fn_cache
            cache.put(digest, body)
            self._miss_kind.pop(digest, None)
            self._miss_sent.pop(digest, None)
            for parked in self._awaiting.pop(digest, ()):
                self._submit_task(parked, from_fill=True)
        elif data.get("missing"):
            # the blob is gone from the store too: nothing will ever fill
            # this digest — FAIL the parked tasks so their records
            # converge instead of waiting forever
            what = "parent result" if kind == "result" else "function"
            self._miss_kind.pop(digest, None)
            self._miss_sent.pop(digest, None)
            for parked in self._awaiting.pop(digest, ()):
                self._task_rblob.pop(parked["task_id"], None)
                extra: dict = {}
                trace_id = self._task_trace.pop(parked["task_id"], None)
                if trace_id:
                    extra["trace_id"] = trace_id
                self._send(
                    m.RESULT,
                    task_id=parked["task_id"],
                    status=str(TaskStatus.FAILED),
                    result=serialize(
                        RuntimeError(
                            f"{what} blob {digest[:16]}... missing from "
                            "the store"
                        )
                    ),
                    **extra,
                )
        # an empty fill (no data, no missing) means "store outage, retry":
        # the parked tasks stay and the resend timer re-asks

    def _result_item(self, res) -> dict:
        """One result's wire fields (shared by the per-task RESULT form
        and the RESULT_BATCH elements). A COMPLETED result at least
        ``rblob_min`` bytes whose TASK frame carried that marker ships
        DIGEST-ONLY (result-blob plane): the body stays in the result
        cache, keyed by content digest, until someone pulls it — failures
        always carry their body (error payloads must stay materializable
        without this worker)."""
        rb = self._task_rblob.pop(res.task_id, None)
        if (
            rb
            and res.status == str(TaskStatus.COMPLETED)
            and isinstance(res.result, str)
            and len(res.result) >= rb
        ):
            digest = payload_digest(res.result)
            self.result_cache.put(digest, res.result)
            item = {
                "task_id": res.task_id,
                "status": res.status,
                "result_digest": digest,
                "result_size": len(res.result),
                "elapsed": res.elapsed,
                "started_at": res.started_at,
            }
        else:
            item = {
                "task_id": res.task_id,
                "status": res.status,
                "result": res.result,
                "elapsed": res.elapsed,
                "started_at": res.started_at,
            }
        trace_id = self._task_trace.pop(res.task_id, None)
        if trace_id:
            item["trace_id"] = trace_id
        log.debug(
            "shipped result %s", res.status,
            extra=log_ctx(task_id=res.task_id, trace_id=trace_id),
        )
        return item

    def _ship_results(self, results) -> int:
        """Ship one drain's results: a multi-result drain toward a
        batch-negotiated dispatcher coalesces into ONE RESULT_BATCH frame
        (misfires total rides once at the top level); everything else —
        single results, and every peer that never sent a TASK_BATCH —
        keeps the per-task RESULT wire byte for byte."""
        if not results:
            return 0
        if self._peer_batch and len(results) > 1:
            self._send(
                m.RESULT_BATCH,
                results=[self._result_item(res) for res in results],
                misfires=self.pool.n_misfires,
            )
        else:
            for res in results:
                # field order matches the historical per-task send exactly
                # (trace_id last, after misfires): the serialized frame
                # must stay byte-identical for non-batch peers
                item = self._result_item(res)
                trace_id = item.pop("trace_id", None)
                item["misfires"] = self.pool.n_misfires
                if trace_id:
                    item["trace_id"] = trace_id
                self._send(m.RESULT, **item)
        if self._chaos_exec is not None:
            # crash_after fires once results are on the wire: the
            # dispatcher must tolerate the purge racing already-shipped
            # (possibly duplicated) results
            self._chaos_exec.after_result(results[-1].task_id)
        return len(results)

    def _on_blob_pull(self, data: dict) -> None:
        """Dispatcher->worker BLOB_MISS (result-blob plane, the REVERSE of
        the function-blob flow): serve a result body out of the result
        cache so the dispatcher can materialize it — into the store for a
        legacy reader, or onward to a cache-cold child worker.
        ``missing=True`` when the entry was evicted: the dispatcher
        surfaces that as the documented result-gone failure mode."""
        digest = data.get("digest")
        if not isinstance(digest, str) or not digest:
            return
        body = self.result_cache.get(digest)
        if body is not None:
            self._send(m.BLOB_FILL, digest=digest, data=body)
        else:
            self._send(m.BLOB_FILL, digest=digest, missing=True)

    def _resend_stale_misses(self, now: float) -> None:
        for digest in list(self._awaiting):
            if now - self._miss_sent.get(digest, 0.0) >= _MISS_RESEND_S:
                self._send(m.BLOB_MISS, digest=digest)
                self._miss_sent[digest] = now

    def run(self, max_tasks: int | None = None) -> int:
        shipped = 0
        # spawn pool children BEFORE announcing capacity: the first pool use
        # otherwise blocks the loop for seconds and the heartbeat silence
        # gets the worker falsely purged
        self.pool.warmup()
        self.register()
        last_heartbeat = time.monotonic()
        deregistered = False
        quiet_since: float | None = None
        try:
            while not self._stopping:
                if self._draining and not deregistered:
                    self._send(m.DEREGISTER)
                    deregistered = True
                    log.info(
                        "draining: %d task(s) in flight", self.pool.busy
                    )
                now = time.monotonic()
                # Keep heartbeating WHILE TASKS ARE IN FLIGHT even after
                # deregistering — going silent would let a drain longer than
                # time_to_expire trigger a false purge + duplicate execution
                # (the dispatcher's record still exists until the last
                # result lands, so these heartbeats only refresh it). Only
                # once the pool is empty do heartbeats stop: the record is
                # dropped with the final result, and a further heartbeat
                # would make the unknown-sender handshake resurrect it.
                if (
                    self.heartbeat
                    and (not deregistered or self.pool.busy > 0)
                    and now - last_heartbeat >= self.heartbeat_period
                ):
                    self._send(m.HEARTBEAT)
                    last_heartbeat = now  # the fix for reference :61-62
                if self._awaiting:
                    self._resend_stale_misses(now)
                if self._chaos_wire is not None:
                    # chaos-delayed frames whose hold expired go out now
                    self._chaos_wire.flush(self.socket.send)
                events = dict(self.poller.poll(self.poll_timeout_ms))
                if self.socket in events:
                    while True:
                        try:
                            raw = self.socket.recv(flags=zmq.NOBLOCK)
                        except zmq.Again:
                            break
                        if not self._peer_bin and m.is_binary(raw):
                            # the dispatcher frames in binary: negotiation
                            # complete — our sends switch too
                            self._peer_bin = True
                        msg_type, data = m.decode(raw)
                        if msg_type == m.TASK:
                            # no admission gate: dispatcher controls load
                            self._submit_task(data)
                        elif msg_type == m.TASK_BATCH:
                            self._on_task_batch(data)
                        elif msg_type == m.BLOB_FILL:
                            self._on_blob_fill(data)
                        elif msg_type == m.BLOB_MISS:
                            # reverse pull: the dispatcher wants a result
                            # body this worker's cache holds
                            self._on_blob_pull(data)
                        elif msg_type == m.CANCEL:
                            # force-cancel: interrupt mid-run or drop
                            # pre-start; the CANCELLED result ships via the
                            # normal drain below. False = task not held
                            # here (already finished — its real result
                            # shipped or is about to; nothing to do)
                            tid = data.get("task_id", "")
                            if self.pool.cancel(tid):
                                log.info(
                                    "force-cancelling task %s", tid,
                                    extra={"task_id": tid},
                                )
                        elif msg_type == m.RECONNECT:
                            # a draining worker reports zero capacity: it
                            # must not be handed new work. rblob workers
                            # also advertise their result-cache occupancy:
                            # rcache_n == 0 tells a (re)connecting
                            # dispatcher to clear any stale holdings
                            # mirror it kept for this worker (restart
                            # detection for the locality lane).
                            rc: dict = {}
                            if m.CAP_RESULT_BLOB in self.caps:
                                rc = {
                                    "rcache_n": len(self.result_cache),
                                    "rcache_bytes":
                                        self.result_cache.n_bytes,
                                }
                            self._send(
                                m.RECONNECT,
                                free_processes=(
                                    0 if self._draining else self.pool.free
                                ),
                                token=self.token,
                                ephemeral=self.token_is_ephemeral,
                                caps=list(self.caps),
                                **rc,
                            )
                shipped += self._ship_results(self.pool.drain())
                if max_tasks is not None and shipped >= max_tasks:
                    break
                if deregistered and self.pool.busy == 0:
                    # linger briefly: a TASK dispatched before the
                    # dispatcher processed our DEREGISTER may still be on
                    # the wire (anything later falls back to the normal
                    # purge + re-dispatch recovery)
                    if quiet_since is None:
                        quiet_since = now
                    elif now - quiet_since >= 0.25:
                        break
                else:
                    quiet_since = None
        finally:
            self.pool.close()
            self.socket.close(linger=0)
        return shipped


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description="tpu-faas push worker")
    ap.add_argument("num_processes", type=int)
    ap.add_argument("dispatcher_url")
    ap.add_argument("--hb", action="store_true", help="enable heartbeats")
    ap.add_argument(
        "--hb-period", type=float, default=1.0, help="heartbeat period (s)"
    )
    ap.add_argument(
        "--token",
        default=None,
        help="stable worker identity for persisted speed grades "
        "(default: minted per process)",
    )
    ns = ap.parse_args(argv)
    log.info(
        "push worker: %d processes -> %s (hb=%s)",
        ns.num_processes,
        ns.dispatcher_url,
        ns.hb,
    )
    from tpu_faas_torch.worker.drain import install_drain_signals

    worker = PushWorker(
        ns.num_processes, ns.dispatcher_url, ns.hb, ns.hb_period,
        token=ns.token,
    )
    install_drain_signals(worker)
    worker.run()


if __name__ == "__main__":
    main()
