"""Discrete-event simulated worker fleet driving the port's scheduler state.

Counterpart of ``tpu_faas/sim/fleet.py``. The fleet models what the
scheduler can observe about real push workers — registration capacity,
heartbeats, results arriving when tasks finish, crashes and rejoins — while
skipping serialization and sockets, so configurations like "4k workers, 5%
churn per tick" run in seconds. The object under test is the production
path: :class:`SchedulerArrays` and its batch tick, on ``device``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from tpu_faas_torch.device import to_host
from tpu_faas_torch.sched.state import SchedulerArrays


@dataclass
class SimResult:
    completed: int
    lost: int  # tasks that vanished (must be 0: redistribution works)
    makespan: float  # sim-time until every task completed
    ticks: int
    tick_seconds: list[float] = field(default_factory=list)  # wall per tick

    @property
    def median_tick_ms(self) -> float:
        return float(np.median(self.tick_seconds) * 1e3)


class SimFleet:
    """n workers with heterogeneous speeds/capacities executing sized tasks
    in simulated time, with optional fail/rejoin churn."""

    def __init__(
        self,
        n_workers: int,
        max_pending: int,
        rng: np.random.Generator,
        procs_per_worker: int = 4,
        hetero: bool = True,
        time_to_expire: float = 10.0,
        max_slots: int = 8,
        device: str | torch.device = "cuda",
    ) -> None:
        self.rng = rng
        self.n = n_workers
        self.sim_time = 0.0
        # 2x row headroom: a crashed worker rejoins under a FRESH identity,
        # so its old row stays allocated until the heartbeat timeout
        self.arrays = SchedulerArrays(
            max_workers=n_workers * 2,
            max_pending=max_pending,
            max_inflight=n_workers * max_slots + max_pending,
            max_slots=max_slots,
            time_to_expire=time_to_expire,
            clock=lambda: self.sim_time,
            device=device,
        )
        self.speeds = (
            rng.uniform(0.5, 4.0, n_workers).astype(np.float32)
            if hetero
            else np.ones(n_workers, dtype=np.float32)
        )
        self.procs = np.full(n_workers, procs_per_worker, dtype=np.int32)
        self.alive = np.ones(n_workers, dtype=bool)
        # incarnation counter: bumped on every rejoin so the scheduler sees
        # a brand-new worker, never a resurrected row
        self.generation = np.zeros(n_workers, dtype=np.int64)
        # per worker: list of (finish_time, task_id)
        self.running: list[list[tuple[float, str]]] = [
            [] for _ in range(n_workers)
        ]
        for w in range(n_workers):
            self.arrays.register(
                self._wid(w), procs_per_worker, float(self.speeds[w])
            )

    def _wid(self, w: int) -> bytes:
        return f"sim-{w}-g{int(self.generation[w])}".encode()

    def run(
        self,
        task_sizes: np.ndarray,
        dt: float = 0.5,
        churn: float = 0.0,
        max_ticks: int = 10_000,
    ) -> SimResult:
        """Feed ``task_sizes`` as the pending queue and tick until drained.

        churn: per-tick probability that a live worker crashes (losing its
        running tasks) and a dead one rejoins fresh. ``tick_seconds`` is the
        host wall time of each tick including the readback of its outputs.
        """
        a = self.arrays
        pending: list[tuple[str, float]] = [
            (f"task-{i}", float(s)) for i, s in enumerate(task_sizes)
        ]
        sizes = {tid: s for tid, s in pending}
        completed: set[str] = set()
        ticks = 0
        tick_wall: list[float] = []

        while len(completed) < len(task_sizes) and ticks < max_ticks:
            ticks += 1
            self.sim_time += dt

            # -- churn: crashes lose running tasks; rejoins come back empty
            if churn > 0:
                flips = self.rng.random(self.n) < churn
                for w in np.flatnonzero(flips):
                    if self.alive[w]:
                        self.alive[w] = False  # silent crash
                        self.running[w].clear()
                    else:
                        # rejoin as a fresh process: new identity, new row;
                        # the old row dies by heartbeat timeout
                        self.alive[w] = True
                        self.generation[w] += 1
                        a.register(
                            self._wid(w),
                            int(self.procs[w]),
                            float(self.speeds[w]),
                        )

            # -- workers: finish tasks, heartbeat
            for w in range(self.n):
                if not self.alive[w]:
                    continue
                a.heartbeat(self._wid(w))
                still: list[tuple[float, str]] = []
                for finish, tid in self.running[w]:
                    if finish <= self.sim_time:
                        completed.add(tid)
                        row = a.inflight_done(tid)
                        if row is not None:
                            a.worker_free[row] = min(
                                a.worker_free[row] + 1, a.worker_procs[row]
                            )
                    else:
                        still.append((finish, tid))
                self.running[w] = still

            # -- scheduler tick over the pending window
            window = pending[: a.max_pending]
            batch_sizes = np.asarray([s for _, s in window], dtype=np.float32)
            t0 = time.perf_counter()
            out = a.tick(batch_sizes)
            redispatch = to_host(out.redispatch)
            purged = to_host(out.purged)
            assignment = to_host(out.assignment)[: len(window)]
            tick_wall.append(time.perf_counter() - t0)

            # redistribution: reclaim tasks of purged workers
            for slot in np.flatnonzero(redispatch):
                tid = a.inflight_clear_slot(int(slot))
                if tid is not None and tid not in completed:
                    pending.append((tid, sizes[tid]))
            for row in np.flatnonzero(purged):
                a.deactivate(int(row))

            # dispatch assignments into the sim workers
            dispatched_tids: set[str] = set()
            for i, row in enumerate(assignment):
                row = int(row)
                if row < 0 or row not in a.row_ids:
                    continue
                wid = a.row_ids[row]
                parts = wid.decode().split("-")
                w, gen = int(parts[1]), int(parts[2][1:])
                if not self.alive[w] or gen != self.generation[w]:
                    continue  # message to a dead incarnation is lost
                tid, size = window[i]
                duration = size / float(self.speeds[w])
                self.running[w].append((self.sim_time + duration, tid))
                a.inflight_add(tid, row)
                a.worker_free[row] -= 1
                dispatched_tids.add(tid)
            if dispatched_tids:
                pending = [p for p in pending if p[0] not in dispatched_tids]

        return SimResult(
            completed=len(completed),
            lost=len(task_sizes) - len(completed),
            makespan=self.sim_time,
            ticks=ticks,
            tick_seconds=tick_wall,
        )
