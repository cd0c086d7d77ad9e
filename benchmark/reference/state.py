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
  placed call is in flight on its row until its result;
- membership, where workers fail and return: a redispatched call leaves
  the in-flight table and arrives again at the next tick, ahead of that
  tick's arrivals; a purged row is deactivated (unregistered, no free
  process, its id forgotten); a returning worker registers: the row its id
  holds, else the inactive row of lowest index, registered with its
  processes and speed, all processes free, heard from now.
"""

from __future__ import annotations

import heapq
from collections import Counter, deque

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
        self.wid_of = {r: wid for wid, r in self.row_of.items()}
        self.free = np.zeros(self.W, dtype=np.int64)  # saturated
        self.last_hb = np.where(f.active, 0.0, -np.inf)
        if tr.churn is not None:  # each worker's last beat before the start
            self.last_hb[f.active] = tr.churn.start_hb[f.active]
        self.prev_live = np.zeros(self.W, dtype=bool)
        self.size = np.zeros(self.T, dtype=F32)
        self.valid = np.zeros(self.T, dtype=bool)
        self.slot_id: list = [None] * self.T
        self.slot_of: dict[str, int] = {}
        #: the size of each call that arrived (a redispatch arrives again
        #: with it)
        self.size_of: dict[str, float] = dict(zip(
            tr.inflight_ids, tr.inflight_sizes.tolist()))
        self.size_of.update(zip(tr.backlog_ids, tr.backlog_sizes.tolist()))
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
        #: the calls themselves (dicts keep their order)
        self.on_row: list[dict] = [{} for _ in range(self.W)]
        for tid, row in self.inflight.items():
            self.on_row[row][tid] = None
        self.retry: deque = deque()  # rejected arrivals, oldest first
        #: calls redispatched last tick, arriving again this tick
        self.requeued: list = []
        #: what the last tick's resolve changed after its packet: (row,
        #: free count) of each purged row, (call, row) of each redispatch
        self.last_purged: list = []
        self.last_redispatched: list = []
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
            del self.on_row[row][tid]
            self.busy[row] -= 1
            self.free[row] = min(self.free[row] + 1, self.procs[row])

    def rejoin(self, wid: bytes, procs: int, speed: float,
               now: float) -> int:
        """A returning worker registers; returns its row."""
        row = self.row_of.get(wid)
        if row is None:
            row = int(np.flatnonzero(~self.active)[0])
            self.row_of[wid] = row
            self.wid_of[row] = wid
        self.active[row] = True
        self.speed[row] = F32(speed)
        self.procs[row] = procs
        self.free[row] = procs
        self.last_hb[row] = now
        return row

    def heartbeats(self, wids, now: float) -> None:
        for wid in wids:
            row = self.row_of.get(wid)
            if row is not None:
                self.last_hb[row] = now

    def arrive(self, arrivals) -> int:
        """Arrivals (id, size), after the retried ones and then the calls
        redispatched last tick, into the free slots of lowest index;
        returns how many were rejected."""
        queue = (list(self.retry)
                 + [(tid, self.size_of[tid]) for tid in self.requeued]
                 + list(arrivals))
        self.retry.clear()
        self.requeued = []
        for tid, size in queue:
            if not self.free_slots:
                self.retry.append((tid, size))
                continue
            slot = heapq.heappop(self.free_slots)
            self.size_of[tid] = size
            self.size[slot] = F32(size)
            self.valid[slot] = True
            self.slot_id[slot] = tid
            self.slot_of[tid] = slot
        return len(self.retry)

    def liveness(self, now: float):
        """(live, purged rows, the calls to redispatch: those in flight on
        a row that is not live, by row)."""
        age = F32(now) - self.last_hb.astype(F32)
        live = self.active & (age <= self.tte)
        purged = np.flatnonzero(self.prev_live & ~live)
        dead = np.flatnonzero(~live & (self.busy > 0))
        return live, purged, [tid for r in dead.tolist()
                              for tid in self.on_row[r]]

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
            self.on_row[row][tid] = None
            self.busy[row] += 1
        self.prev_live = live

    def reap(self, redispatched, purged) -> None:
        """Apply a tick's redispatches (call ids, in the order reported)
        and purges: the calls leave the in-flight table and arrive again
        next tick; the rows are deactivated."""
        self.last_redispatched = []
        for tid in redispatched:
            row = self.inflight.pop(tid)
            del self.on_row[row][tid]
            self.busy[row] -= 1
            self.last_redispatched.append((tid, row))
        self.requeued = list(redispatched)
        self.last_purged = [(int(r), int(self.free[r])) for r in purged]
        for row in purged:
            self.active[row] = False
            self.free[row] = 0
            wid = self.wid_of.pop(int(row), None)
            if wid is not None:
                del self.row_of[wid]

    def device_view(self, last_placed) -> dict:
        """The leaves the program's card holds after the last tick: the
        last resolve's placements, redispatches and purges reach it with
        the next packet."""
        free, active = self.free.copy(), self.active.copy()
        for row, f in self.last_purged:
            free[row], active[row] = f, True
        rows = Counter(self.inflight.values())
        rows.update(row for _, row in self.last_redispatched)
        rows.subtract(Counter(row for _, row in last_placed))
        return {"free": free, "active": active, "inflight": +rows}
