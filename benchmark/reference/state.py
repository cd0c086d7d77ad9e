"""The resident scheduler's semantics, in plain NumPy: the state the
reference carries from tick to tick, worked out from the benchmark's own
inputs (the fleet, the backlog, the calls in flight, and each tick's
results, heartbeats and arrivals).

What it holds and how a tick moves it, as the scheduler documents it:

- per worker: speed, processes, whether registered, free processes (a
  result gives one back, never above the registered count; a placement
  takes one), the last heartbeat (the virtual time of the call);
- the pending set of ``max_pending`` slots: an arrival takes the free slot
  of lowest index (arrivals that find none are rejected and retried first
  next tick); a reported placement frees its slot;
- liveness: registered and heard from within ``time_to_expire``, the ages
  in float32 as the device sees them (``f32(now) - f32(stamp)`` against
  ``f32(time_to_expire)``); purged = live last tick and not now; a call in
  flight on a worker that is not live is redispatched;
- placements reported in pending-slot order, at most ``KP`` a tick; a
  placed call is in flight on its row until its result.
"""

from __future__ import annotations

import heapq
from collections import deque

import numpy as np

from benchmark.traffic import Traffic

F32 = np.float32
#: placements and redispatches reported per tick, arrivals per packet
KP, KR = 2048, 512


class RefState:
    def __init__(self, config: dict, tr: Traffic) -> None:
        f = tr.fleet
        self.T = int(config["max_pending"])
        self.W = int(config["max_workers"])
        self.K = int(config["max_slots"])
        self.tte = F32(config["time_to_expire_s"])
        self.kp = min(KP, self.T)
        self.speed = f.speed.copy()
        self.active = f.active.copy()
        self.procs = np.where(f.active, f.procs, 0).astype(np.int64)
        self.row_of = {wid: r for r, wid in enumerate(f.ids)
                       if wid is not None}
        self.free = np.zeros(self.W, dtype=np.int64)  # saturated
        self.last_hb = np.where(f.active, 0.0, -np.inf)
        self.prev_live = np.zeros(self.W, dtype=bool)
        self.size = np.zeros(self.T, dtype=F32)
        self.valid = np.zeros(self.T, dtype=bool)
        self.slot_id: list = [None] * self.T
        self.slot_of: dict[str, int] = {}
        n = len(tr.backlog_ids)
        self.size[:n] = tr.backlog_sizes
        self.valid[:n] = True
        for i, tid in enumerate(tr.backlog_ids):
            self.slot_id[i] = tid
            self.slot_of[tid] = i
        self.free_slots = list(range(n, self.T))
        heapq.heapify(self.free_slots)
        self.inflight = dict(zip(tr.inflight_ids,
                                 tr.inflight_rows.tolist()))
        #: calls in flight on each row
        self.busy = np.bincount(tr.inflight_rows, minlength=self.W)
        self.retry: deque = deque()  # rejected arrivals, oldest first
        # the auction's carry: prices over every process slot, stale at
        # start
        self.price = np.zeros(self.W * self.K, dtype=F32)
        self.refresh = True

    @property
    def n_valid(self) -> int:
        return self.T - len(self.free_slots)

    # -- a tick's inputs ---------------------------------------------------
    def results(self, ids) -> None:
        for tid in ids:
            row = self.inflight.pop(tid)
            self.busy[row] -= 1
            self.free[row] = min(self.free[row] + 1, self.procs[row])

    def heartbeats(self, wids, now: float) -> None:
        for wid in wids:
            self.last_hb[self.row_of[wid]] = now

    def arrive(self, arrivals) -> int:
        """Arrivals (id, size), after the retried ones, into the free
        slots of lowest index; returns how many were rejected."""
        queue = list(self.retry) + list(arrivals)
        self.retry.clear()
        for tid, size in queue:
            if not self.free_slots:
                self.retry.append((tid, size))
                continue
            slot = heapq.heappop(self.free_slots)
            self.size[slot] = F32(size)
            self.valid[slot] = True
            self.slot_id[slot] = tid
            self.slot_of[tid] = slot
        return len(self.retry)

    def liveness(self, now: float):
        """(live, purged rows, calls to redispatch: those in flight on a
        row that is not live)."""
        age = F32(now) - self.last_hb.astype(F32)
        live = self.active & (age <= self.tte)
        purged = np.flatnonzero(self.prev_live & ~live)
        return live, purged, int(self.busy[~live].sum())

    def capacity(self, live) -> np.ndarray:
        return np.where(live, np.minimum(np.maximum(self.free, 0), self.K),
                        0)

    # -- a tick's outputs --------------------------------------------------
    def place(self, placed, live) -> None:
        """Apply reported placements [(id, row)]: the slots free up, the
        rows lose a process, the calls go in flight."""
        for tid, row in placed:
            slot = self.slot_of.pop(tid)
            self.valid[slot] = False
            self.slot_id[slot] = None
            heapq.heappush(self.free_slots, slot)
            self.free[row] -= 1
            self.inflight[tid] = row
            self.busy[row] += 1
        self.prev_live = live
