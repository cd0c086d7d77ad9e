"""Local dispatch mode: one in-process process pool, no network.

Capability parity with reference LocalDispatcher (task_dispatcher.py:59-103):
admission-controlled intake (only read the announce bus while the pool has a
free slot), execute via ``execute_fn`` in pool children, write terminal
status+result back to the store. Purpose: the no-network baseline that
isolates communication overhead (reference README:41).

Design differences:

- execution rides the SAME :class:`~tpu_faas.worker.pool.TaskPool` the
  workers use (forkserver children, broken-pool recovery, force-cancel
  interrupts) instead of a second hand-rolled executor: a child that dies
  mid-task (user code calls os._exit, OOM-kill) surfaces as a FAILED
  result and the pool rebuilds, where the reference silently leaks a pool
  slot forever;
- completions land on the pool's thread-safe done queue via future
  done-callbacks instead of the reference's deque-rotation scan
  (task_dispatcher.py:88-103) — O(1) drain, no polling latency;
- cancellation works end to end: queued tasks are dropped at the submit
  gate (store-verified cancel notes), and FORCE cancels interrupt a
  running task in place — locally there is no wire to relay over, the
  kill note feeds :meth:`TaskPool.cancel` directly.
"""

from __future__ import annotations

import time

from tpu_faas_torch.dispatch.base import STORE_OUTAGE_ERRORS, TaskDispatcher
from tpu_faas_torch.worker.pool import TaskPool


class LocalDispatcher(TaskDispatcher):
    def __init__(
        self,
        num_workers: int = 4,
        store_url: str = "memory://",
        store=None,
        channel: str = "tasks",
        idle_sleep: float = 0.001,
        shared: bool = False,
    ) -> None:
        super().__init__(
            store_url=store_url, channel=channel, store=store, shared=shared
        )
        self.num_workers = num_workers
        self.idle_sleep = idle_sleep
        self._running: set[str] = set()
        #: tasks admitted while their cancel-note verification read hit a
        #: store outage: their record may actually be CANCELLED (or even
        #: DELETEd), so their eventual result writes first_wins — a blind
        #: write could resurrect a consumed record as a partial hash
        self._suspect: set[str] = set()

    def start(self, max_tasks: int | None = None) -> int:
        """Run the dispatch loop; returns number of tasks completed.

        ``max_tasks`` bounds the run for tests/benchmarks; None = run until
        ``stop()``.
        """
        completed = 0
        last_renew = time.monotonic()
        pool = TaskPool(self.num_workers)
        misfire_base = self.worker_misfires.get("local-pool", 0)
        try:
            while not self.stopping:
                progressed = False
                if self.deferred_results or self.deferred_dep_completions:
                    self.flush_deferred_results()
                try:
                    # store failover: replay the announce ring so tasks
                    # announced on the dead primary re-enter intake
                    self.maybe_rearm_after_failover()
                except STORE_OUTAGE_ERRORS as exc:
                    self.note_store_outage(exc)
                # admission-controlled intake (reference task_dispatcher.py:73-75)
                while pool.free > 0:
                    try:
                        # shared mode: only run tasks we claimed, and shed
                        # tasks whose queue deadline lapsed (outage-safe:
                        # an unclaimed/unshed poll parks and retries)
                        task = self.poll_next_admitted()
                    except STORE_OUTAGE_ERRORS as exc:
                        self.note_store_outage(exc)
                        break
                    if task is None:
                        break
                    suspect = False
                    try:
                        if self.drop_if_cancelled(task.task_id):
                            continue
                    except STORE_OUTAGE_ERRORS as exc:
                        # verification read mid-outage: run the task anyway
                        # (the benign lost-race convergence) rather than
                        # wedging intake — local holds no pending structure
                        # to park it in. Its result write is demoted to
                        # first_wins: the unverified record may be
                        # CANCELLED or DELETEd, and a blind write would
                        # resurrect it
                        self.note_store_outage(exc, pause=0)
                        self._suspect.add(task.task_id)
                        suspect = True
                    # payload plane: a digest-carrying task materializes
                    # its body through the dispatcher blob cache (one
                    # store fetch per unique function) before hitting the
                    # pool; the digest rides into the pool so children
                    # skip the per-task dill decode too
                    try:
                        if not self.ensure_inline_payload(task):
                            continue  # blob vanished: task FAILed in place
                    except STORE_OUTAGE_ERRORS as exc:
                        # the announce is spent — park in the base's
                        # unclaimed buffer, which poll_next_claimed serves
                        # first once the store is back
                        self.note_store_outage(exc, pause=0)
                        self._unclaimed.append(task)
                        break
                    if not suspect:
                        # a suspect task gets NO RUNNING mark: the store may
                        # recover between the failed verification read and
                        # this write, and set_status would then un-freeze a
                        # terminal CANCELLED record (or recreate a DELETEd
                        # hash) — defeating the very demotion above. The
                        # deferred-capable first_wins result write is the
                        # only store touch a suspect earns.
                        self.mark_running_safe(task.task_id)
                    self.note_dispatch(task)
                    pool.submit(
                        task.task_id,
                        task.fn_payload,
                        task.param_payload,
                        task.timeout,
                        fn_digest=task.fn_digest,
                    )
                    self._running.add(task.task_id)
                    progressed = True
                # control messages flow even while the pool is saturated,
                # and force-cancels feed the pool DIRECTLY (no wire here)
                self.drain_control_messages()
                self.relay_kills(
                    lambda tid: tid if tid in self._running else None,
                    lambda _addr, tid: pool.cancel(tid),
                )
                # drain completions (CANCELLED included — force cancels
                # surface through the ordinary result path); the pool's
                # misfire-repair counter rides the shared stats surface
                # (wire modes report it via RESULT `misfires`). Baseline
                # offset: each start() builds a fresh pool whose counter
                # restarts at 0, and the operator-facing total must not
                # go backward across invocations.
                if pool.n_misfires:
                    self.worker_misfires["local-pool"] = (
                        misfire_base + pool.n_misfires
                    )
                for res in pool.drain():
                    self._running.discard(res.task_id)
                    # exec window for the timeline (worker-measured in the
                    # pool child, same fields the wire modes carry on
                    # RESULT messages)
                    self.note_result_message(
                        res.task_id,
                        {"started_at": res.started_at, "elapsed": res.elapsed},
                    )
                    suspect = res.task_id in self._suspect
                    self._suspect.discard(res.task_id)
                    self.record_result_safe(
                        res.task_id, res.status, res.result,
                        first_wins=suspect,
                    )
                    completed += 1
                    progressed = True
                if (self._running or self.shared) and (
                    time.monotonic() - last_renew >= self.lease_renew_period
                ):
                    # keep in-pool tasks from being adopted: EVERY mode
                    # renews (base.py LEASE_RENEW_PERIOD invariant) — an
                    # unshared local dispatcher can still share a store with
                    # a tpu-push rescanner, and a task running past
                    # lease_timeout would be adopted and re-executed. In
                    # shared mode the renewal also rides as the liveness
                    # heartbeat, so it runs even while idle.
                    try:
                        # suspects excluded: their record may be CANCELLED
                        # or DELETEd (unverified mid-outage admission), and
                        # a blind lease write would recreate a deleted hash
                        # as a permanent partial ghost — same rationale as
                        # their skipped RUNNING mark above
                        self.renew_leases(self._running - self._suspect)
                    except STORE_OUTAGE_ERRORS as exc:
                        self.note_store_outage(exc, pause=0)
                    last_renew = time.monotonic()
                try:
                    # saturation signal for gateway admission control
                    self.maybe_publish_capacity(
                        pending=len(self._announce_backlog),
                        inflight=len(self._running),
                        capacity=self.num_workers,
                        results=completed,
                    )
                except STORE_OUTAGE_ERRORS as exc:
                    self.note_store_outage(exc, pause=0)
                if max_tasks is not None and completed >= max_tasks:
                    break
                if not progressed:
                    time.sleep(self.idle_sleep)
        finally:
            pool.close()
        return completed
