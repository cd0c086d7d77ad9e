"""Worker-side process pool with broken-pool recovery and force-cancel.

Wraps a ProcessPoolExecutor (forkserver context) around `execute_fn` with the
same failure semantics the local dispatcher has: a child killed by user code
surfaces as a FAILED result for that task and the pool is rebuilt, instead of
the reference's silent slot leak (its workers count busy slots in the parent
and a vanished child never decrements, pull_worker.py:63-72).

Force-cancel (:meth:`TaskPool.cancel`): interrupt a task MID-RUN without
killing its child process, by reusing the shape of the per-task SIGALRM
timeout (core/executor.py) with SIGUSR1. Children report (task_id, pid)
start/end events on a queue; the parent signals the pid its bookkeeping says
runs the target, and the child's handler raises
:class:`~tpu_faas.core.executor.TaskCancelledInterrupt` into whatever is
currently running — producing a terminal CANCELLED result and freeing the
slot in place (no pool rebuild). The event queue is necessarily a little
stale, so a signal CAN land after the child switched tasks; the handler
cannot know the parent's intent (signals carry no payload), so
:meth:`TaskPool.drain` repairs misfires internally: a CANCELLED result
for a task nobody asked to cancel is resubmitted — it never reported
anything externally, so re-running it is invisible. Same reach limits as
the timeout: POSIX main-thread children; C code that never yields can't
be interrupted.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue
import signal as _signal
import threading
from concurrent.futures import Future, ProcessPoolExecutor, wait
from concurrent.futures.process import BrokenProcessPool

from tpu_faas_torch.core.executor import (
    ExecutionResult,
    TaskCancelledInterrupt,
    execute_fn,
)
from tpu_faas_torch.core.serialize import serialize
from tpu_faas_torch.core.task import TaskStatus
from tpu_faas_torch.obs import REGISTRY
from tpu_faas_torch.utils.logging import get_logger, log_ctx

log = get_logger("worker.pool")

#: Process-wide pool counters (the worker process's share of the unified
#: metric catalog): every drained result by terminal status, plus the
#: misfire repairs — the one at-least-once execution in the system — as a
#: first-class series instead of a buried log line.
_TASKS_TOTAL = REGISTRY.counter(
    "tpu_faas_worker_pool_tasks_total",
    "Results drained from this process's task pools, by terminal status",
    ("status",),
)
_MISFIRES_TOTAL = REGISTRY.counter(
    "tpu_faas_worker_pool_misfires_total",
    "Cancel interrupts that landed on a bystander task and were repaired "
    "by resubmission (at-least-once executions)",
)

#: Parent-side blob-cache counters, shared by both worker kinds (they
#: both import the pool) and split by cache KIND — ``fn`` is the payload
#: cache (digest-shipped TASK functions), ``result`` the result cache
#: (digest-shipped parent results, ``--result-blobs``): the
#: operator-visible proof that steady state ships digests, not bodies,
#: with the two planes separately triageable.
BLOB_CACHE_HITS = REGISTRY.counter(
    "tpu_faas_worker_blob_cache_hit_total",
    "Digest resolutions served from this worker's blob caches, by cache "
    "kind (fn = payload cache, result = result cache)",
    ("kind",),
)
BLOB_CACHE_MISSES = REGISTRY.counter(
    "tpu_faas_worker_blob_cache_miss_total",
    "Digest resolutions that needed a BLOB_MISS/BLOB_FILL round, by "
    "cache kind (fn = payload cache, result = result cache)",
    ("kind",),
)
#: the function-cache children, under their historical import names (both
#: workers increment these on the TASK fn_digest path)
FN_CACHE_HITS = BLOB_CACHE_HITS.labels(kind="fn")
FN_CACHE_MISSES = BLOB_CACHE_MISSES.labels(kind="fn")
#: the result-cache children (rblob workers, dep_digests resolution)
RESULT_CACHE_HITS = BLOB_CACHE_HITS.labels(kind="result")
RESULT_CACHE_MISSES = BLOB_CACHE_MISSES.labels(kind="result")

#: Batched data plane (worker side): bundle sizes and pool IPC volume.
#: ipc_total / tasks_total is the O(1)-pool-wakeups-per-bundle proof the
#: bench asserts on — a K-task bundle pays ONE executor submit.
BUNDLE_SIZE = REGISTRY.histogram(
    "tpu_faas_worker_bundle_size",
    "Tasks per pool submission (1 = the classic per-task path; larger "
    "values are TASK_BATCH bundles executing K tasks on one pool IPC "
    "message)",
    buckets=(1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0),
)
POOL_IPC = REGISTRY.counter(
    "tpu_faas_worker_pool_ipc_total",
    "Pool IPC submissions (executor round trips): a K-task bundle "
    "counts 1, so ipc/tasks << 1 is the bundling win",
)

#: done-queue key marking a bundle future's completion (the payload is a
#: list of ExecutionResults, one per member)
_BUNDLE = object()

#: child-side: the task id currently executing in THIS child (None between
#: tasks) — consulted by the SIGUSR1 handler, plain memory only (a signal
#: handler must never do IPC)
_CURRENT_TASK: str | None = None
#: child-side: the start/end event queue back to the parent
_EVENTS = None


def _on_cancel_signal(signum, frame):
    global _CURRENT_TASK
    tid = _CURRENT_TASK
    if tid is not None:
        # close the window BEFORE raising: a duplicate signal (client
        # retry, two relays racing) landing while the first interrupt is
        # still unwinding must no-op — a raise inside _run_reported's
        # except block would escape as the future's exception and turn a
        # deliberate CANCELLED into a spurious FAILED
        _CURRENT_TASK = None
        raise TaskCancelledInterrupt(f"task {tid} force-cancelled mid-run")


def _child_init(events) -> None:
    """Pool-child initializer: stash the event queue, install the cancel
    handler (main thread of the child; mirrors the SIGALRM arming in
    execute_fn)."""
    global _EVENTS
    _EVENTS = events
    if hasattr(_signal, "SIGUSR1"):
        _signal.signal(_signal.SIGUSR1, _on_cancel_signal)


def _run_reported(
    task_id: str,
    ser_fn: str,
    ser_params: str,
    timeout: float | None,
    fn_digest: str | None = None,
    dep_results: dict[str, str] | None = None,
) -> ExecutionResult:
    """execute_fn wrapped with start/end reporting + the cancel window.

    The WHOLE window — from opening `_CURRENT_TASK` through execute_fn's
    return — sits inside one try, so an interrupt can never escape as the
    future's exception (that would report FAILED, leak the child's window
    permanently open, and let the next stray signal kill the executor's
    worker loop). `_CURRENT_TASK` is set before the start event ships: a
    deferred interrupt fired on seeing that event must find the window
    open. An interrupt landing AFTER execute_fn returned keeps the real
    result — the task beat the signal, and discarding a computed
    COMPLETED for a raced CANCELLED would break the documented force-
    cancel contract."""
    global _CURRENT_TASK
    res: ExecutionResult | None = None
    end_sent = False
    try:
        try:
            _CURRENT_TASK = task_id
            if _EVENTS is not None:
                _EVENTS.put(("start", task_id, os.getpid()))
            # interrupts DURING the call are handled inside execute_fn
            # itself (its except clauses return a CANCELLED result)
            res = execute_fn(
                task_id, ser_fn, ser_params, timeout, fn_digest, dep_results
            )
        except TaskCancelledInterrupt as exc:
            if res is None:
                # landed before execute_fn produced anything: a pre-start
                # cancel (the handler already closed the window)
                res = ExecutionResult(
                    task_id, str(TaskStatus.CANCELLED), serialize(exc)
                )
        finally:
            _CURRENT_TASK = None
            if _EVENTS is not None:
                _EVENTS.put(("end", task_id, 0))
                end_sent = True
    except TaskCancelledInterrupt as exc:
        # the signal landed in the sliver between the try body completing
        # and the finally's window close — the handler cleared the window
        # before raising, so no further interrupt can arrive; keep the
        # real result if one exists (the task beat the signal) and make
        # sure the end event still ships
        if res is None:
            res = ExecutionResult(
                task_id, str(TaskStatus.CANCELLED), serialize(exc)
            )
        if _EVENTS is not None and not end_sent:
            _EVENTS.put(("end", task_id, 0))
    return res


def _run_bundle(items) -> list[ExecutionResult]:
    """Bundle form of _run_reported: K tasks ride ONE pool IPC message and
    execute sequentially in this child — one wakeup, one result shipment,
    and a repeated function pays its digest-cache lookup against a warm
    entry for every element after the first. Each element keeps the full
    per-task contract (own timeout arm, own cancel window, own start/end
    events), so a mid-bundle force-cancel interrupts exactly the element
    the parent's event mirror says is running. ``items`` is a list of
    (task_id, ser_fn, ser_params, timeout, fn_digest[, dep_results])
    tuples."""
    return [_run_reported(*item) for item in items]


def _warm() -> None:
    """No-op run in each child to force its spawn (must be module-level to
    pickle)."""


class TaskPool:
    def __init__(self, num_processes: int) -> None:
        self.num_processes = num_processes
        self._done: queue.Queue[tuple[str, Future]] = queue.Queue()
        self._busy = 0
        #: parent-side mirror of the children's start/end events:
        #: task_id -> child pid, maintained by _drain_events
        self._running_pids: dict[str, int] = {}
        #: in-flight bookkeeping for force-cancel: the future (so a task
        #: still queued in the executor can be cancelled without a signal),
        #: the submitted payloads (so a misfired interrupt can resubmit),
        #: and which tasks a cancel was actually requested for
        self._futures: dict[str, Future] = {}
        self._args: dict[
            str, tuple[str, str, float | None, str | None, dict | None]
        ] = {}
        #: bundle future -> member task ids (batched data plane): members
        #: share ONE future, so cancel() must never fut.cancel() a bundle
        #: (it would cancel the innocent siblings) — bundled pre-start
        #: cancels ride the deferred-kill path instead
        self._bundle_members: dict[Future, list[str]] = {}
        self._want_cancel: set[str] = set()
        #: cancels for tasks sitting in the executor's CALL QUEUE (future
        #: no longer .cancel()-able, child not started): the interrupt is
        #: deferred until the task's start event arrives
        self._deferred_kill: set[str] = set()
        #: cumulative misfire repairs (a cancel interrupt that landed on a
        #: bystander task, repaired by resubmission — the one at-least-once
        #: execution in the system). Surfaced by the workers on their
        #: RESULT messages and aggregated into dispatcher /stats, so
        #: doubled side effects are operator-visible without log scraping.
        self.n_misfires = 0
        #: completion wakeup pipe: the done callback (executor thread)
        #: pokes it so a serving loop parked in a poller wakes the moment
        #: a result is ready instead of waiting out its poll timeout —
        #: the worker-side analog of the dispatcher's event-driven intake.
        #: Register ``wakeup_fd`` for POLLIN; drain() clears it.
        self._wake_r, self._wake_w = os.pipe()
        os.set_blocking(self._wake_r, False)
        os.set_blocking(self._wake_w, False)
        #: serializes done-callback pokes against close(): without it, a
        #: callback that snapshotted the fd pre-close could write into a
        #: since-reused descriptor number (one uncontended acquire per
        #: POOL round trip, not per task — bundles amortize it too)
        self._wake_lock = threading.Lock()
        self._executor = self._make()

    def _make(self) -> ProcessPoolExecutor:
        ctx = mp.get_context("forkserver")
        self._events = ctx.SimpleQueue()
        self._running_pids.clear()
        return ProcessPoolExecutor(
            max_workers=self.num_processes,
            mp_context=ctx,
            initializer=_child_init,
            initargs=(self._events,),
        )

    @property
    def wakeup_fd(self) -> int:
        """Readable fd that becomes ready when a result lands in the done
        queue (level-cleared by drain())."""
        return self._wake_r

    def _on_done(self, key, fut) -> None:
        """Done callback (runs on an executor thread): enqueue + poke the
        wakeup pipe. A full pipe is fine — the byte already in it wakes
        the reader, which drains everything level-triggered. The poke
        holds _wake_lock so it cannot race close(): a straggler callback
        either sees the live fd (close hasn't started) or -1 (close won
        the lock) — never a closed-and-reused descriptor number."""
        self._done.put((key, fut))
        with self._wake_lock:
            w = self._wake_w
            if w < 0:
                return
            try:
                os.write(w, b"\0")
            except (BlockingIOError, OSError):
                pass

    def _drain_events(self) -> None:
        while not self._events.empty():
            kind, tid, pid = self._events.get()
            if kind == "start":
                self._running_pids[tid] = pid
                if tid in self._deferred_kill:
                    # a cancel arrived while this task sat in the call
                    # queue: interrupt it the moment it starts (the child
                    # opens its cancel window BEFORE shipping this event)
                    self._deferred_kill.discard(tid)
                    try:
                        os.kill(pid, _signal.SIGUSR1)
                    except (ProcessLookupError, PermissionError):
                        pass
            else:
                self._running_pids.pop(tid, None)

    def cancel(self, task_id: str) -> bool:
        """Best-effort force-cancel of ``task_id``. True when the task will
        surface as a CANCELLED result from :meth:`drain` — either its
        future was still queued in the executor (cancelled without a
        signal) or an interrupt was sent to the child the event stream
        says runs it. False when it is not held here (finished, shipped,
        or never seen). The event stream lags reality by design, so an
        interrupt CAN land on a child that already switched tasks; drain()
        repairs such misfires internally by resubmitting the wrongly
        interrupted task — see the module docstring."""
        fut = self._futures.get(task_id)
        bundled = fut is not None and fut in self._bundle_members
        if fut is not None and not bundled and fut.cancel():
            # never handed to a child: the done-callback queues the
            # cancelled future and drain() reports terminal CANCELLED
            self._want_cancel.add(task_id)
            return True
        if not hasattr(_signal, "SIGUSR1"):
            return False
        self._drain_events()
        pid = self._running_pids.get(task_id)
        if pid is None:
            if fut is not None and not fut.done():
                # in the executor's call queue: no child to signal yet —
                # defer the interrupt to the task's start event
                self._deferred_kill.add(task_id)
                self._want_cancel.add(task_id)
                return True
            return False
        try:
            os.kill(pid, _signal.SIGUSR1)
        except (ProcessLookupError, PermissionError):
            return False
        self._want_cancel.add(task_id)
        return True

    @property
    def busy(self) -> int:
        return self._busy

    @property
    def free(self) -> int:
        return self.num_processes - self._busy

    def warmup(self, timeout: float = 120.0) -> None:
        """Force the lazy child-process spawn NOW, off the serving path.

        The executor spawns children on first submit; with forkserver that
        first submit blocks for seconds (forkserver boot + module re-import).
        A worker that pays this inside its serving loop goes heartbeat-silent
        long enough to be falsely purged — so workers warm up BEFORE
        registering with the dispatcher."""
        wait(
            [self._executor.submit(_warm) for _ in range(self.num_processes)],
            timeout=timeout,
        )

    def submit(
        self,
        task_id: str,
        fn_payload: str,
        param_payload: str,
        timeout: float | None = None,
        fn_digest: str | None = None,
        dep_results: dict[str, str] | None = None,
    ) -> None:
        """``fn_digest`` (payload plane): content digest of ``fn_payload``,
        keying the child-side deserialized-function cache so a repeated
        function pays dill decode once per child, not once per task.
        ``dep_results`` (result-blob plane): the graph child's resolved
        parent bodies {parent_id: serialized result}, exposed to the
        executing function via core/executor.dep_results()."""
        try:
            fut = self._executor.submit(
                _run_reported, task_id, fn_payload, param_payload, timeout,
                fn_digest, dep_results,
            )
        except BrokenProcessPool:
            self._executor.shutdown(wait=False, cancel_futures=True)
            self._executor = self._make()
            fut = self._executor.submit(
                _run_reported, task_id, fn_payload, param_payload, timeout,
                fn_digest, dep_results,
            )
        fut.add_done_callback(lambda f, tid=task_id: self._on_done(tid, f))
        self._futures[task_id] = fut
        self._args[task_id] = (
            fn_payload, param_payload, timeout, fn_digest, dep_results
        )
        self._busy += 1
        POOL_IPC.inc()
        BUNDLE_SIZE.observe(1.0)

    def submit_bundle(self, items) -> None:
        """Submit K tasks as ONE pool IPC message (batched data plane):
        ``items`` is a list of (task_id, fn_payload, param_payload,
        timeout, fn_digest[, dep_results]) tuples that execute
        sequentially in one child.
        Every per-task semantic is preserved element-wise — own timeout,
        own cancel window (deferred-kill interrupts exactly the running
        element), own misfire repair — but the bundle costs one executor
        round trip and one drain entry instead of K of each. A singleton
        falls through to the classic submit."""
        if not items:
            return
        if len(items) == 1:
            self.submit(*items[0])
            return
        items = list(items)
        try:
            fut = self._executor.submit(_run_bundle, items)
        except BrokenProcessPool:
            self._executor.shutdown(wait=False, cancel_futures=True)
            self._executor = self._make()
            fut = self._executor.submit(_run_bundle, items)
        fut.add_done_callback(lambda f: self._on_done(_BUNDLE, f))
        self._bundle_members[fut] = [it[0] for it in items]
        for it in items:
            task_id = it[0]
            self._futures[task_id] = fut
            self._args[task_id] = (
                it[1], it[2], it[3], it[4],
                it[5] if len(it) > 5 else None,
            )
        self._busy += len(items)
        POOL_IPC.inc()
        BUNDLE_SIZE.observe(float(len(items)))

    def _pop_member(self, task_id: str):
        """Shared per-task bookkeeping pop as a result is drained: busy
        slot, future/args maps, deferred-kill note. Returns (wanted,
        args)."""
        self._busy -= 1
        self._futures.pop(task_id, None)
        self._deferred_kill.discard(task_id)
        args = self._args.pop(task_id, None)
        wanted = task_id in self._want_cancel
        self._want_cancel.discard(task_id)
        return wanted, args

    @staticmethod
    def _terminal(task_id: str, status: TaskStatus, exc: BaseException) -> ExecutionResult:
        """Synthesized terminal result for a task whose future never
        produced one (pre-start cancel, rebuild-cancelled, dead child) —
        ONE construction point so the per-task and bundle drain paths
        cannot diverge."""
        _TASKS_TOTAL.labels(status=str(status)).inc()
        return ExecutionResult(task_id, str(status), serialize(exc))

    def _deliver(
        self, task_id: str, res: ExecutionResult, wanted: bool, args, out
    ) -> None:
        """Terminal-result delivery with misfire repair (shared by the
        per-task and bundle drain paths): a CANCELLED result nobody asked
        for is a misfired interrupt — resubmit instead of delivering."""
        if (
            res.status == str(TaskStatus.CANCELLED)
            and not wanted
            and args is not None
        ):
            log.warning(
                "misfired cancel interrupt hit task %s; resubmitting it",
                task_id,
                extra=log_ctx(task_id=task_id),
            )
            self.n_misfires += 1
            _MISFIRES_TOTAL.inc()
            self.submit(task_id, *args)
            return
        _TASKS_TOTAL.labels(status=res.status).inc()
        out.append(res)

    def drain(self) -> list[ExecutionResult]:
        """Non-blocking: collect all finished results. Force-cancel
        semantics live here: a cancelled-before-start future becomes a
        terminal CANCELLED result; a CANCELLED result nobody requested (an
        interrupt that landed after its child switched tasks) is repaired
        by resubmitting the task instead of delivering — the wrongly
        interrupted run reported nothing externally, so the re-execution
        is invisible to every consumer."""
        self._drain_events()  # keep the task->pid mirror bounded + fresh
        r = self._wake_r
        if r >= 0:
            try:
                while os.read(r, 4096):  # clear the wakeup pipe
                    pass
            except (BlockingIOError, OSError):
                pass
        out: list[ExecutionResult] = []
        while True:
            try:
                task_id, fut = self._done.get_nowait()
            except queue.Empty:
                return out
            if task_id is _BUNDLE:
                self._drain_bundle(fut, out)
                continue
            wanted, args = self._pop_member(task_id)
            if fut.cancelled():
                if wanted:
                    # deliberate pre-start cancel: terminal CANCELLED
                    out.append(
                        self._terminal(
                            task_id,
                            TaskStatus.CANCELLED,
                            TaskCancelledInterrupt(
                                f"task {task_id} cancelled before start"
                            ),
                        )
                    )
                    continue
                # future cancelled by a broken-pool rebuild: .exception()
                # would RAISE CancelledError; report the task as FAILED
                exc: BaseException | None = RuntimeError(
                    "task cancelled: worker pool died and was rebuilt"
                )
            else:
                exc = fut.exception()
            if exc is None:
                # misfire repair lives in _deliver: the one at-least-once
                # execution in the system, logged + counted there
                self._deliver(task_id, fut.result(), wanted, args, out)
            else:
                out.append(
                    self._terminal(
                        task_id, TaskStatus.FAILED, RuntimeError(str(exc))
                    )
                )

    def _drain_bundle(self, fut: Future, out: list[ExecutionResult]) -> None:
        """Drain one completed bundle future into ``out``. The happy path
        delivers each member through the shared misfire-repair gate; a
        future-level failure (pool rebuild cancelled it, or a member
        killed the child — the executor fails the WHOLE submission) fails
        every member, exactly what K per-task futures sharing the dead
        child's queue would have reported."""
        members = self._bundle_members.pop(fut, [])
        was_cancelled = fut.cancelled()
        if was_cancelled:
            exc: BaseException | None = RuntimeError(
                "task cancelled: worker pool died and was rebuilt"
            )
        else:
            exc = fut.exception()
        if exc is None:
            by_id = {res.task_id: res for res in fut.result()}
            for task_id in members:
                wanted, args = self._pop_member(task_id)
                res = by_id.get(task_id)
                if res is None:  # defensive: a child must answer every item
                    res = ExecutionResult(
                        task_id,
                        str(TaskStatus.FAILED),
                        serialize(
                            RuntimeError("bundle returned no result")
                        ),
                    )
                self._deliver(task_id, res, wanted, args, out)
        else:
            for task_id in members:
                wanted, _ = self._pop_member(task_id)
                if was_cancelled and wanted:
                    # per-task parity: a rebuild-cancelled future whose
                    # member had a deliberate cancel pending reports
                    # terminal CANCELLED, exactly like the single-task
                    # drain's cancelled+wanted branch
                    out.append(
                        self._terminal(
                            task_id,
                            TaskStatus.CANCELLED,
                            TaskCancelledInterrupt(
                                f"task {task_id} cancelled before start"
                            ),
                        )
                    )
                    continue
                out.append(
                    self._terminal(
                        task_id, TaskStatus.FAILED, RuntimeError(str(exc))
                    )
                )

    def close(self) -> None:
        self._executor.shutdown(wait=False, cancel_futures=True)
        # park-then-close UNDER the wake lock: a straggler done callback
        # (the shutdown above does not wait) either ran its poke before
        # we took the lock or sees -1 after — the descriptor is never
        # closed (and possibly reused) under a callback's feet
        with self._wake_lock:
            r, w = self._wake_r, self._wake_w
            self._wake_r = self._wake_w = -1
            for fd in (r, w):
                if fd >= 0:
                    try:
                        os.close(fd)
                    except OSError:
                        pass
