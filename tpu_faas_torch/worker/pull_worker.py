"""Pull worker: REQ socket + local process pool.

Capability parity with reference PullWorker (pull_worker.py:10-123): register
with the dispatcher, then loop — pace by ``delay`` (load-bearing for REP/REQ
fairness across many workers, reference :131-132), ask for work when a pool
slot is free, ship finished results. Every request is answered with ``task``
or ``wait`` (the REP/REQ lockstep), and a reply to a ``result`` message may
itself carry the next task, so a busy fleet never wastes a round trip
(the reference's inline re-listen trick, pull_worker.py:108-111, made
structural here: every transaction handles its reply uniformly).

CLI: ``python -m tpu_faas.worker.pull_worker N tcp://host:port [--delay s]``
(reference pull_worker.py:126-137).
"""

from __future__ import annotations

import argparse
import time
import uuid

import zmq

from tpu_faas_torch.core.payload import PayloadLRU, payload_digest
from tpu_faas_torch.core.serialize import serialize
from tpu_faas_torch.core.task import TaskStatus
from tpu_faas_torch.utils.backoff import BackoffPolicy
from tpu_faas_torch.utils.logging import get_logger, log_ctx
from tpu_faas_torch.worker import messages as m
from tpu_faas_torch.worker.pool import (
    FN_CACHE_HITS,
    FN_CACHE_MISSES,
    RESULT_CACHE_HITS,
    RESULT_CACHE_MISSES,
    TaskPool,
)

log = get_logger("pull_worker")

#: Blob-fetch retry schedule: gentle growth capped at 1 s — the loop is
#: also this worker's liveness traffic during an outage, so sleeps must
#: stay short enough that request-stamped last_seen never ages past tte.
_BLOB_BACKOFF = BackoffPolicy(floor_s=0.2, factor=1.5, cap_s=1.0)


class PullWorker:
    def __init__(
        self,
        num_processes: int,
        dispatcher_url: str,
        delay: float = 0.01,
        recv_timeout_ms: int = 10_000,
        keepalive_period: float = 1.0,
        caps: tuple[str, ...] = m.WORKER_CAPS,
        fn_cache_bytes: int = 256 * 1024 * 1024,
        result_cache_bytes: int = 256 * 1024 * 1024,
    ) -> None:
        self.worker_id = str(uuid.uuid4())
        #: max silence while saturated before sending a WAIT-bound keepalive
        #: (must be well under the dispatcher's time_to_expire)
        self.keepalive_period = keepalive_period
        self.num_processes = num_processes
        self.delay = delay
        #: payload-plane capabilities advertised on REGISTER; () = pure
        #: reference contract
        self.caps: tuple[str, ...] = tuple(caps)
        #: digest -> serialized body (parent-side codec cache; REQ/REP
        #: resolves misses synchronously with a BLOB_MISS transaction)
        self.fn_cache = PayloadLRU(fn_cache_bytes)
        #: digest -> serialized RESULT body (result-blob plane): this
        #: worker's own digest-shipped results plus dep-digest fills.
        #: REQ/REP resolves result-digest misses synchronously, exactly
        #: like fn blobs — there is no reverse-pull lane on this transport
        #: (the dispatcher can only answer, never ask).
        self.result_cache = PayloadLRU(result_cache_bytes)
        #: task_id -> rblob_min from that task's TASK reply (per-task
        #: digest-ship permission + threshold)
        self._task_rblob: dict[str, int] = {}
        #: True after the dispatcher's first binary reply — sends switch
        self._peer_bin = False
        #: task_id -> distributed trace id (TASK ``trace_id``): stamped
        #: into logs and echoed on the matching RESULT
        self._task_trace: dict[str, str] = {}
        self.pool = TaskPool(num_processes)
        self.ctx = zmq.Context.instance()
        self.socket = self.ctx.socket(zmq.REQ)
        self.socket.setsockopt(zmq.RCVTIMEO, recv_timeout_ms)
        self.socket.setsockopt(zmq.LINGER, 0)
        # survive a dropped reply (dispatcher restart) without wedging the
        # REQ state machine
        self.socket.setsockopt(zmq.REQ_RELAXED, 1)
        self.socket.setsockopt(zmq.REQ_CORRELATE, 1)
        self.socket.connect(dispatcher_url)
        self._stopping = False
        self._draining = False
        #: fault-injection seams (tpu_faas/chaos), None when
        #: TPU_FAAS_CHAOS is unset. The REQ/REP lockstep constrains the
        #: wire seam: only wire.delay is expressible here (as a blocking
        #: sleep before the request) — drop would wedge the mandatory
        #: recv, dup would desync reply correlation.
        from tpu_faas_torch import chaos as _chaos

        _plan = _chaos.from_env()
        self._chaos_wire = _plan.wire() if _plan is not None else None
        self._chaos_exec = _plan.execution() if _plan is not None else None

    def stop(self) -> None:
        self._stopping = True

    def drain(self) -> None:
        """Graceful shutdown: stop asking for work (and flag result messages
        ``no_task`` so their mandatory replies are WAIT, never a new task),
        ship what's in flight, then exit."""
        self._draining = True

    # -- one REQ/REP transaction ------------------------------------------
    def _transact(self, msg_type: str, **data: object) -> tuple[str, dict]:
        """Send one message, receive the mandatory reply, and if the reply
        carries a task, put it on the pool. Force-cancels ride the reply
        too (``cancel_ids``): a pull worker cannot be pushed to, so the
        dispatcher piggy-backs kill requests for tasks THIS worker runs on
        whatever reply goes out next — TASK or WAIT. Returns the reply."""
        payload = m.encode_for(self._peer_bin, msg_type, **data)
        if self._chaos_wire is not None:
            # lockstep socket: delay-as-sleep only (see __init__)
            self._chaos_wire.send(
                payload, self.socket.send,
                dup_ok=False, defer_ok=False, drop_ok=False,
            )
        else:
            self.socket.send(payload)
        raw = self.socket.recv()
        if not self._peer_bin and m.is_binary(raw):
            self._peer_bin = True  # binary negotiation complete
        reply_type, reply = m.decode(raw)
        for tid in reply.get("cancel_ids", ()):
            if self.pool.cancel(tid):
                log.info(
                    "force-cancelling task %s", tid,
                    extra={"task_id": tid, "worker_id": self.worker_id},
                )
        if reply_type == m.TASK:
            self._submit_task(reply)
        # WAIT: nothing to do
        return reply_type, reply

    def _submit_task(self, reply: dict) -> None:
        """Resolve the function body (payload plane: digest-only TASKs hit
        the cache, a miss is resolved SYNCHRONOUSLY with a BLOB_MISS
        transaction — REQ/REP gives us a mandatory reply to ride) and
        submit to the pool."""
        digest = reply.get("fn_digest")
        trace_id = reply.get("trace_id")
        if isinstance(trace_id, str) and trace_id:
            self._task_trace[reply["task_id"]] = trace_id
            log.debug(
                "task received", extra=log_ctx(
                    task_id=reply["task_id"],
                    worker_id=self.worker_id,
                    trace_id=trace_id,
                ),
            )
        payload = reply.get("fn_payload")
        if payload is None and digest:
            payload = self.fn_cache.get(digest)
            if payload is None:
                FN_CACHE_MISSES.inc()
                payload = self._fetch_blob(digest)
            else:
                FN_CACHE_HITS.inc()
            if payload is None:
                # unfillable (blob gone) or store outage at the
                # dispatcher: FAIL the task via the ordinary result path
                # rather than dropping it silently — REQ/REP has no
                # parked-task structure to wait in
                fail_extra: dict = {}
                fail_trace = self._task_trace.pop(reply["task_id"], None)
                if fail_trace:
                    fail_extra["trace_id"] = fail_trace
                self._transact(
                    m.RESULT,
                    worker_id=self.worker_id,
                    task_id=reply["task_id"],
                    status=str(TaskStatus.FAILED),
                    result=serialize(
                        RuntimeError(
                            f"function blob {str(digest)[:16]}... "
                            "unresolvable at dispatch"
                        )
                    ),
                    no_task=True,
                    **fail_extra,
                )
                return
        elif payload is not None and digest:
            self.fn_cache.put(digest, payload)
        deps = self._resolve_deps(reply)
        if deps is False:
            return  # a parent body was unresolvable; the task FAILED above
        rb = reply.get("rblob_min")
        if isinstance(rb, int) and rb > 0 and m.CAP_RESULT_BLOB in self.caps:
            self._task_rblob[reply["task_id"]] = rb
        if self._chaos_exec is not None:
            # slow / crash_before ahead of pool handoff (same seam shape
            # as the push worker — see its _submit_task comment)
            self._chaos_exec.before_task(reply["task_id"])
        self.pool.submit(
            reply["task_id"],
            payload,
            reply["param_payload"],
            timeout=reply.get("timeout"),
            fn_digest=digest,
            dep_results=deps or None,
        )

    def _resolve_deps(self, reply: dict):
        """Resolve a graph child's delivered parent results (result-blob
        plane): ``dep_results`` bodies ride the reply as-is;
        ``dep_digests`` hit the result cache, with misses fetched
        SYNCHRONOUSLY via BLOB_MISS transactions like fn blobs (REQ/REP
        has no parking structure). Returns the deps dict (None when the
        task carries none) or False after FAILing the task on an
        unresolvable parent body."""
        bodies = reply.get("dep_results")
        digests = reply.get("dep_digests")
        if not bodies and not digests:
            return None
        deps: dict[str, str] = dict(bodies) if isinstance(bodies, dict) else {}
        if isinstance(digests, dict):
            for pid, dg in digests.items():
                if not isinstance(dg, str) or not dg:
                    continue
                body = self.result_cache.get(dg)
                if body is None:
                    RESULT_CACHE_MISSES.inc()
                    body = self._fetch_blob(dg, cache=self.result_cache)
                else:
                    RESULT_CACHE_HITS.inc()
                if body is None:
                    self._task_rblob.pop(reply["task_id"], None)
                    fail_extra: dict = {}
                    fail_trace = self._task_trace.pop(reply["task_id"], None)
                    if fail_trace:
                        fail_extra["trace_id"] = fail_trace
                    self._transact(
                        m.RESULT,
                        worker_id=self.worker_id,
                        task_id=reply["task_id"],
                        status=str(TaskStatus.FAILED),
                        result=serialize(
                            RuntimeError(
                                f"parent result blob {dg[:16]}... "
                                "unresolvable at dispatch"
                            )
                        ),
                        no_task=True,
                        **fail_extra,
                    )
                    return False
                deps[pid] = body
        return deps

    def _fetch_blob(
        self, digest: str, retries: int = 40, cache: PayloadLRU | None = None
    ) -> str | None:
        """One or more BLOB_MISS transactions; an EMPTY fill (dispatcher
        store outage) backs off and retries — the ``_BLOB_BACKOFF``
        budget (~37 s at the default, sleeps capped at 1 s) rides out
        the store blips the rest of the system parks through, since
        REQ/REP has no parked-task structure to wait in asynchronously.
        ``missing`` (the blob is gone from the store too) gives up
        immediately."""
        for attempt in range(retries):
            # worker_id rides along: pull-mode liveness is request-stamped
            # (demand IS the heartbeat), and during an outage this retry
            # loop is the only traffic this worker emits — an anonymous
            # MISS would let last_seen age past tte and get the live
            # worker purged mid-resolution (its in-flight tasks would
            # re-dispatch and double-execute)
            self.socket.send(
                m.encode_for(
                    self._peer_bin,
                    m.BLOB_MISS,
                    digest=digest,
                    worker_id=self.worker_id,
                )
            )
            raw = self.socket.recv()
            if not self._peer_bin and m.is_binary(raw):
                self._peer_bin = True
            reply_type, reply = m.decode(raw)
            if reply_type != m.BLOB_FILL:
                return None  # protocol surprise: treat as unresolvable
            body = reply.get("data")
            if isinstance(body, str):
                (cache if cache is not None else self.fn_cache).put(
                    digest, body
                )
                return body
            if reply.get("missing"):
                return None
            time.sleep(_BLOB_BACKOFF.delay(attempt))  # dispatcher outage
        return None

    def run(self, max_tasks: int | None = None) -> int:
        """Main loop; returns number of results shipped (for tests)."""
        shipped = 0
        self.pool.warmup()  # pay the child-spawn cost before taking work
        self._transact(
            m.REGISTER, worker_id=self.worker_id, caps=list(self.caps)
        )
        last_transact = time.monotonic()
        try:
            while not self._stopping:
                time.sleep(self.delay)
                # ship every finished result; each reply may carry new work
                # (unless draining, where no_task forces a WAIT reply)
                for res in self.pool.drain():
                    extra_kw: dict = {}
                    trace_id = self._task_trace.pop(res.task_id, None)
                    if trace_id:
                        extra_kw["trace_id"] = trace_id
                    # digest-only ship (result-blob plane): COMPLETED
                    # results >= the task's rblob_min marker keep their
                    # body in the result cache and send the digest
                    rb = self._task_rblob.pop(res.task_id, None)
                    if (
                        rb
                        and res.status == str(TaskStatus.COMPLETED)
                        and isinstance(res.result, str)
                        and len(res.result) >= rb
                    ):
                        dg = payload_digest(res.result)
                        self.result_cache.put(dg, res.result)
                        body_kw: dict = {
                            "result_digest": dg,
                            "result_size": len(res.result),
                        }
                    else:
                        body_kw = {"result": res.result}
                    self._transact(
                        m.RESULT,
                        worker_id=self.worker_id,
                        task_id=res.task_id,
                        status=res.status,
                        **body_kw,
                        elapsed=res.elapsed,
                        started_at=res.started_at,
                        misfires=self.pool.n_misfires,
                        no_task=self._draining,
                        **extra_kw,
                    )
                    shipped += 1
                    last_transact = time.monotonic()
                    if self._chaos_exec is not None:
                        # crash_after: the result (and its mandatory
                        # reply) is done — the worker dies holding
                        # nothing the dispatcher hasn't seen
                        self._chaos_exec.after_result(res.task_id)
                # ask for work while slots are free
                if not self._draining and self.pool.free > 0:
                    self._transact(m.READY, worker_id=self.worker_id)
                    last_transact = time.monotonic()
                elif (
                    time.monotonic() - last_transact > self.keepalive_period
                ):
                    # saturated on long tasks: demand is the liveness signal
                    # in pull mode, so a worker that stops asking looks dead
                    # and would get its in-flight tasks re-queued under it.
                    # no_task forces a WAIT reply (we have no free slot).
                    self._transact(
                        m.READY, worker_id=self.worker_id, no_task=True
                    )
                    last_transact = time.monotonic()
                if max_tasks is not None and shipped >= max_tasks:
                    break
                if self._draining and self.pool.busy == 0:
                    break  # REQ/REP is synchronous: nothing can be in flight
        finally:
            self.pool.close()
            self.socket.close(linger=0)
        return shipped


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description="tpu-faas pull worker")
    ap.add_argument("num_processes", type=int)
    ap.add_argument("dispatcher_url")
    ap.add_argument("-d", "--delay", type=float, default=0.01)
    ns = ap.parse_args(argv)
    log.info(
        "pull worker: %d processes -> %s", ns.num_processes, ns.dispatcher_url
    )
    from tpu_faas_torch.worker.drain import install_drain_signals

    worker = PullWorker(ns.num_processes, ns.dispatcher_url, ns.delay)
    install_drain_signals(worker)
    worker.run()


if __name__ == "__main__":
    main()
