"""The cell's system under test and the loop that drives it.

The scheduler is the program's ``ResidentScheduler``, built for the
configuration and filled by arrays (a ``register()`` loop over 16,384
rows would cost more than the ticks measured): the fleet's mirrors, the
calls in flight, and the backlog by ``pending_bulk_load``. One tick is
what the dispatcher's resident tick does with the scheduler
(``TpuPushDispatcher._tick_resident`` and its result and act paths):

1. intake: ``inflight_done`` and ``release_slot`` for each call that
   finished, ``heartbeat`` for each worker due, ``pending_add`` for each
   new call;
2. enqueue: ``tick_resident()``;
3. resolve: ``resolve_next()`` until it returns None, with
   ``inflight_add`` for each placement (the dispatcher's act).

Under a configuration's ``churn`` (:class:`ChurnLoop`, chosen once when
the loop is built) a tick also does what the dispatcher does when workers
fail and return: a failed worker sends no heartbeat and no result from
its failure tick on, so the calls it holds never report; a returning
worker calls ``register`` in intake; resolve reads each redispatched
slot's call, clears the slot (``inflight_clear_slot``) and re-queues the
call, and calls ``deactivate`` on each purged row (``_reap_dead_workers``
without the store); the next intake adds the re-queued calls with
``pending_add`` ahead of its arrivals, as the dispatcher's pending deque
holds them.

The scheduler runs on a virtual clock that advances one tick period a
tick. The loop keeps four host-clock stamps a tick (the span edges) and,
outside the tick's span, files each placement under the tick its call
will finish on and keeps the tick's inputs and the program's answers for
the reference.
"""

from __future__ import annotations

import time
from contextlib import nullcontext

import numpy as np

from benchmark.traffic import ChurnView, Traffic, due_after

#: the names of the tick's three spans in a profiler trace
SPANS = ("bench.intake", "bench.enqueue", "bench.resolve")


class VirtualClock:
    """The scheduler's clock: the loop sets ``now`` at each tick."""

    def __init__(self) -> None:
        self.now = 0.0

    def __call__(self) -> float:
        return self.now


def build_scheduler(config: dict, tr: Traffic, device, clock):
    """The program's resident scheduler for ``config``, its fleet
    registered, saturated with ``tr``'s calls in flight and holding its
    backlog. Nothing has run on the device but the backlog's upload."""
    from tpu_faas_torch.sched.resident import ResidentScheduler

    rs = ResidentScheduler(
        max_workers=int(config["max_workers"]),
        max_pending=int(config["max_pending"]),
        max_inflight=int(config["max_inflight"]),
        max_slots=int(config["max_slots"]),
        time_to_expire=float(config["time_to_expire_s"]),
        clock=clock,
        placement=config["placement"],
        device=device,
    )
    f = tr.fleet
    rs.worker_speed[:] = f.speed
    rs.worker_active[:] = f.active
    rs.worker_procs[:] = np.where(f.active, f.procs, 0)
    # saturated: every process of a live worker holds a call
    rs.worker_free[:] = 0
    rs.last_heartbeat[f.active] = clock()
    if tr.churn is not None:  # each worker's last beat before the start
        rs.last_heartbeat[f.active] = tr.churn.start_hb[f.active]
    for row, wid in enumerate(f.ids):
        if wid is not None:
            rs.worker_ids[wid] = row
            rs.row_ids[row] = wid
    for tid, row in zip(tr.inflight_ids, tr.inflight_rows.tolist()):
        rs.inflight_add(tid, row)
    rs.pending_bulk_load(tr.backlog_ids, tr.backlog_sizes)
    return rs


class Loop:
    """Drives ``rs`` with ``tr``'s calls, one tick per :meth:`tick`.

    ``record`` keeps, per tick, what the reference needs: the tick, the
    ids that finished (and re-arrived), the first arrival's ring index,
    and the program's resolved ticks. ``stamps`` keeps the span edges
    (intake start, enqueue start, resolve start, resolve end) in
    ``time.perf_counter`` seconds. With ``trace`` each span also runs in a
    ``torch.profiler.record_function`` of :data:`SPANS`."""

    def __init__(self, rs, tr: Traffic, clock: VirtualClock,
                 trace: bool = False) -> None:
        self.rs, self.tr, self.clock = rs, tr, clock
        self.k = 0
        self.pos = 0
        self.buckets: dict[int, list] = {}
        self.size_of: dict[str, float] = {}
        for tid, due, size in zip(tr.inflight_ids, tr.inflight_due.tolist(),
                                  tr.inflight_sizes.tolist()):
            self.buckets.setdefault(due, []).append(tid)
            self.size_of[tid] = size
        self.size_of.update(zip(tr.backlog_ids, tr.backlog_sizes.tolist()))
        self.record: list[tuple] = []
        self.stamps: list[tuple[float, float, float, float]] = []
        self.outputs: dict[int, object] = {}
        if trace:
            from torch.profiler import record_function

            self._span = record_function
        else:
            self._span = lambda name: nullcontext()

    def tick(self, keep_output: bool = False) -> None:
        rs, tr, span = self.rs, self.tr, self._span
        k = self.k
        self.clock.now = k * tr.dt
        due = self.buckets.pop(k, [])
        pos0 = self.pos % len(tr.arrival_sizes)
        sizes = tr.arrival_sizes[pos0:pos0 + len(due)]
        if len(sizes) < len(due):  # the ring wraps
            sizes = sizes + tr.arrival_sizes[:len(due) - len(sizes)]
        hb = tr.hb_bucket[k % tr.hb_period]
        clock = time.perf_counter

        t0 = clock()
        with span(SPANS[0]):
            for tid in due:
                row = rs.inflight_done(tid)
                if row is not None:
                    rs.release_slot(row)
            for wid in hb:
                rs.heartbeat(wid)
            for tid, size in zip(due, sizes):
                rs.pending_add(tid, size)
        t1 = clock()
        with span(SPANS[1]):
            out = rs.tick_resident()
        t2 = clock()
        resolved = []
        with span(SPANS[2]):
            while True:
                res = rs.resolve_next()
                if res is None:
                    break
                for tid, row in res.placed:
                    rs.inflight_add(tid, row)
                resolved.append(res)
        t3 = clock()

        # outside the span: file each placement under its finishing tick
        self.stamps.append((t0, t1, t2, t3))
        size_of = self.size_of
        size_of.update(zip(due, sizes))
        buckets, due_tick = self.buckets, tr.due_tick
        for res in resolved:
            for tid, row in res.placed:
                buckets.setdefault(due_tick(k, size_of[tid], row),
                                   []).append(tid)
        self.record.append((k, due, pos0, resolved,
                            rs.device_dispatches_last_tick))
        if keep_output:
            self.outputs[k] = out
        self.pos += len(due)
        self.k = k + 1

    @staticmethod
    def placed_count(record) -> int:
        return sum(len(r.placed) for entry in record for r in entry[3])


class ChurnLoop(Loop):
    """The loop under the configuration's ``churn`` (see the module's
    docstring). A record entry carries two more items: the rows
    ``register`` gave the tick's returning workers, and the calls the
    tick's resolve read at its redispatched slots, in slot order."""

    def __init__(self, rs, tr: Traffic, clock: VirtualClock,
                 trace: bool = False) -> None:
        super().__init__(rs, tr, clock, trace)
        self.view = view = ChurnView(tr.churn)
        self.row_worker = [w if wid is not None else -1
                           for w, wid in enumerate(tr.fleet.ids)]
        self.inv_speed = list(tr.inv_speed)
        self.requeue: list = []
        # the calls of the start whose worker is down or fails before
        # they finish never report
        self.buckets = {}
        for tid, row, due in zip(tr.inflight_ids, tr.inflight_rows.tolist(),
                                 tr.inflight_due.tolist()):
            if not view.lost(self.row_worker[row], due):
                self.buckets.setdefault(due, []).append(tid)

    def tick(self, keep_output: bool = False) -> None:
        rs, tr, span, view = self.rs, self.tr, self._span, self.view
        ch = tr.churn
        k = self.k
        self.clock.now = k * tr.dt
        due = self.buckets.pop(k, [])
        pos0 = self.pos % len(tr.arrival_sizes)
        sizes = tr.arrival_sizes[pos0:pos0 + len(due)]
        if len(sizes) < len(due):  # the ring wraps
            sizes = sizes + tr.arrival_sizes[:len(due) - len(sizes)]
        back = view.step(k)
        hb = view.beating(k, tr.hb_period)
        requeue, self.requeue = self.requeue, []
        size_of = self.size_of
        clock = time.perf_counter

        t0 = clock()
        with span(SPANS[0]):
            for tid in due:
                row = rs.inflight_done(tid)
                if row is not None:
                    rs.release_slot(row)
            rows = [rs.register(ch.wid[w], ch.procs[w], ch.speed[w])
                    for w in back]
            for wid in hb:
                rs.heartbeat(wid)
            for tid in requeue:
                rs.pending_add(tid, size_of[tid])
            for tid, size in zip(due, sizes):
                rs.pending_add(tid, size)
        t1 = clock()
        with span(SPANS[1]):
            out = rs.tick_resident()
        t2 = clock()
        resolved = []
        redispatched = []
        with span(SPANS[2]):
            while True:
                res = rs.resolve_next()
                if res is None:
                    break
                for slot in res.redispatch_slots:
                    tid = rs.inflight_task[slot]
                    if tid is not None:
                        rs.inflight_clear_slot(slot)
                        redispatched.append(tid)
                for row in res.purged_rows:
                    rs.deactivate(int(row))
                for tid, row in res.placed:
                    rs.inflight_add(tid, row)
                resolved.append(res)
        t3 = clock()

        # outside the span: the rows the returning workers took, and each
        # placement filed under its finishing tick, unless its worker is
        # down or fails by then
        self.stamps.append((t0, t1, t2, t3))
        row_worker, inv_speed, dt = self.row_worker, self.inv_speed, tr.dt
        for w, row in zip(back, rows):
            row_worker[row] = w
            inv_speed[row] = tr.inv_speed[w]
        size_of.update(zip(due, sizes))
        buckets, lost = self.buckets, view.lost
        for res in resolved:
            for tid, row in res.placed:
                d = due_after(k, size_of[tid], inv_speed[row], dt)
                if not lost(row_worker[row], d):
                    buckets.setdefault(d, []).append(tid)
        self.requeue = redispatched
        self.record.append((k, due, pos0, resolved,
                            rs.device_dispatches_last_tick, rows,
                            redispatched))
        if keep_output:
            self.outputs[k] = out
        self.pos += len(due)
        self.k = k + 1


def make_loop(rs, tr: Traffic, clock: VirtualClock,
              trace: bool = False) -> Loop:
    """The loop for ``tr``'s configuration, chosen once: a configuration
    without ``churn`` runs :class:`Loop`'s tick unchanged."""
    cls = Loop if tr.churn is None else ChurnLoop
    return cls(rs, tr, clock, trace=trace)


def snapshot(rs) -> dict:
    """The program's state after the window, for the reference to judge:
    the host mirrors, and the leaves its kernel carries read back."""
    from tpu_faas_torch.sched.resident import state_to_numpy

    inflight = {tid: int(rs.inflight_worker[slot])
                for slot, tid in enumerate(rs.inflight_task)
                if tid is not None}
    return {
        "host": {
            "worker_free": rs.worker_free.astype(np.int64),
            "last_heartbeat": rs.last_heartbeat.copy(),
            "slot_task": dict(rs.slot_task),
            "inflight": inflight,
            "worker_active": rs.worker_active.copy(),
            "worker_ids": dict(rs.worker_ids),
            "row_ids": dict(rs.row_ids),
        },
        "device": state_to_numpy(rs._r_state),
    }
