"""Collective scheduler tick for a multi-process dispatcher.

Counterpart of ``tpu_faas/parallel/multihost_tick.py``. One dispatcher
fleet, one mesh over every process's positions: process 0 (the LEAD) runs
the real serve loop — sockets, store, workers — while every other process
is a FOLLOWER that holds its positions' shards and joins the tick's
collectives. The lead broadcasts each tick's host inputs as one packed f32
buffer (``dist.broadcast`` from rank 0, for JAX's ``broadcast_one_to_all``),
every process runs the identical ``sharded_scheduler_tick`` over the mesh,
and the task-sharded assignment comes back whole in every process: the
sharded functions ``all_gather`` it, as JAX's ``process_allgather`` does
(the lead acts on it; followers discard). A stop flag in the same buffer
shuts the followers down with the lead.

Determinism: followers never see host scheduler state except through the
broadcast buffer, and the tick is deterministic, so per-process carried
state (prev_live, the auction's warm prices) stays bit-identical without
further communication.

Transfer: the buffer carries the pending sizes and the per-worker vectors
every tick. The in-flight table is not broadcast: redispatch is
elementwise in the replicated live vector, so the lead computes it from its
own table.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from tpu_faas_torch.device import to_host
from tpu_faas_torch.parallel import distributed
from tpu_faas_torch.utils.logging import get_logger

log = get_logger("parallel.multihost")

_HEADER = 4  # stop, n_valid, time_to_expire, has_prio


def broadcast_from_lead(buf: np.ndarray, device: torch.device) -> np.ndarray:
    """Rank 0's ``buf`` in every process (a copy; identity in a single
    process). Under NCCL the buffer crosses on ``device``; under gloo it is
    staged through host memory."""
    if not distributed.is_multiprocess():
        return buf
    t = torch.from_numpy(np.array(buf, dtype=np.float32))
    if dist.get_backend() != "gloo":
        t = t.to(device)
    dist.broadcast(t, src=0)
    return to_host(t)  # faas: allow(trace.host-sync) the broadcast packet, read back in every process


def watchdog(in_tick_since: list, timeout: float, what: str) -> None:
    """Hard-exit this process when one tick's collectives have blocked for
    more than ``timeout`` seconds (``in_tick_since[0]`` is when the tick
    began, None between ticks): the lead died mid-tick, and a blocked
    collective cannot be interrupted from Python."""
    import os
    import threading
    import time

    def watch() -> None:
        while True:
            time.sleep(min(timeout / 4.0, 30.0))
            t0 = in_tick_since[0]
            if t0 is not None and time.monotonic() - t0 > timeout:
                log.critical("%s: tick stuck > %.0fs (lead died "
                             "mid-collective?); exiting", what, timeout)
                os._exit(2)

    threading.Thread(target=watch, name="multihost-watchdog",
                     daemon=True).start()


class MultihostTick:
    """Lead/follower collective tick over the mesh of every process.

    Construct with identical parameters in every process (they define the
    broadcast buffer's layout and the shapes); then the lead calls
    :meth:`lead_tick` per scheduler tick and :meth:`lead_stop` on shutdown,
    while followers sit in :meth:`follow_loop`. ``device`` is where this
    process computes (its card on ``cuda``)."""

    def __init__(
        self,
        max_pending: int,
        max_workers: int,
        max_slots: int = 8,
        placement: str | None = None,
        device: str | torch.device = "cuda",
    ) -> None:
        from tpu_faas_torch.parallel.mesh import make_mesh, prepare_sinkhorn

        self.T = int(max_pending)
        self.W = int(max_workers)
        self.max_slots = int(max_slots)
        self.placement = placement or "rank"
        self.mesh = make_mesh(device=distributed.process_device(device))
        if self.placement == "sinkhorn":
            # the scripted tick compiled here, not in the first tick
            prepare_sinkhorn()
        n_dev = self.mesh.size
        if self.T % n_dev:
            self.T += n_dev - (self.T % n_dev)
        # buffer layout: header ++ sizes[T] [++ prio[T]] ++ speed[W] ++
        # free[W] ++ active[W] ++ hb_age[W]. Only the rank placement has
        # hard priority classes, so the prio section exists exactly then;
        # every process derives that from the parameters it shares
        self.prio_section = self.placement == "rank"
        self.buflen = (
            _HEADER + (2 if self.prio_section else 1) * self.T + 4 * self.W
        )
        self._prev_live = None  # device, replicated; carried across ticks
        # auction warm prices: carried per process; the collective tick's
        # outputs are bit-identical everywhere, so every carry (and its
        # refresh decision, read one tick late) stays in lockstep
        self._prev_price = None
        self._price_refresh = None
        self.process_index = distributed.process_index()
        #: set when a lead tick failed AFTER its broadcast: the followers
        #: are blocked inside that tick's collectives, and any further
        #: collective from the lead — the stop broadcast included — would
        #: be mismatched and hang this process too
        self._broken = False

    # -- shared execution --------------------------------------------------
    def _run(self, buf: np.ndarray):
        """Execute one collective tick from a broadcast buffer. Returns the
        host-view TickOutput, or None when the buffer carries the stop
        flag. Every process calls this with the identical buffer."""
        from tpu_faas_torch.parallel.mesh import (
            shard_task_arrays,
            sharded_scheduler_tick,
        )
        from tpu_faas_torch.sched.state import TickOutput

        if buf[0] > 0.5:
            return None
        T, W = self.T, self.W
        lead = self.mesh.lead
        n_valid = int(buf[1])
        tte = float(np.float32(buf[2]))
        has_prio = buf[3] > 0.5
        off = _HEADER
        sizes = buf[off : off + T]; off += T
        prio = None
        if self.prio_section:
            # f32 carries the (clamped) priorities exactly: lead_tick clips
            # to +/-2^24, inside f32's integer-exact range
            prio = buf[off : off + T].astype(np.int32); off += T
        speed = buf[off : off + W]; off += W
        free = buf[off : off + W].astype(np.int32); off += W
        active = buf[off : off + W] > 0.5; off += W
        hb_age = buf[off : off + W]

        def put(host):
            return torch.from_numpy(np.array(host)).to(lead)

        (ts,) = shard_task_arrays(self.mesh, sizes)
        prio_d = (shard_task_arrays(self.mesh, prio)[0]
                  if self.prio_section and has_prio else None)
        if self._prev_live is None:
            self._prev_live = torch.zeros(W, dtype=torch.bool, device=lead)
        if self._price_refresh is not None and bool(self._price_refresh):  # faas: allow(trace.host-sync) the auction's refresh flag, computed a tick ago: one read a tick
            # last warm attempt's prices went stale: cold re-solve. The
            # read is of a replicated value computed a tick ago: the same
            # decision in every process
            self._prev_price = None
        self._price_refresh = None
        out = sharded_scheduler_tick(
            self.mesh,
            ts,
            None,
            put(speed),
            put(free),
            put(active),
            put(hb_age),
            self._prev_live,
            # redispatch is computed by the LEAD from its own in-flight
            # table (lead_tick): the tick gathers over a length-1 dummy
            torch.full((1,), -1, dtype=torch.int32, device=lead),
            tte,
            max_slots=self.max_slots,
            placement=self.placement,
            task_priority=prio_d,
            n_valid=n_valid,
            auction_price=self._prev_price,
        )
        self._prev_live = out.live  # identical in every process
        if self.placement == "auction":
            self._prev_price = out.auction_price
            self._price_refresh = out.auction_refresh
        # the assignment is already whole in every process: the sharded
        # functions all_gather it
        return TickOutput(
            to_host(out.assignment),  # faas: allow(trace.host-sync) the multihost tick's readback: assignment
            to_host(out.live),  # faas: allow(trace.host-sync) the multihost tick's readback: live
            to_host(out.purged),  # faas: allow(trace.host-sync) the multihost tick's readback: purged
            None,  # the lead fills redispatch from its own table
        )

    # -- lead side ---------------------------------------------------------
    def _broadcast(self, buf: np.ndarray) -> np.ndarray:
        return broadcast_from_lead(buf, self.mesh.lead)

    def lead_tick(
        self,
        task_sizes: np.ndarray,  # f32[n] un-padded
        worker_speed: np.ndarray,
        worker_free: np.ndarray,
        worker_active: np.ndarray,
        hb_age: np.ndarray,
        inflight_worker: np.ndarray,
        time_to_expire: float,
        task_priorities: np.ndarray | None = None,  # i32[n] un-padded
    ):
        n = len(task_sizes)
        if n > self.T:
            raise ValueError(f"{n} pending > padded {self.T}")
        buf = np.zeros(self.buflen, dtype=np.float32)
        buf[1] = n
        buf[2] = time_to_expire
        buf[3] = 0.0 if task_priorities is None else 1.0
        off = _HEADER
        buf[off : off + n] = task_sizes
        off += self.T
        if self.prio_section:
            if task_priorities is not None:
                # clip into f32's integer-exact range so the broadcast
                # cannot merge distinct priorities
                buf[off : off + n] = np.clip(
                    task_priorities, -(2**24), 2**24
                ).astype(np.float32)
            off += self.T
        buf[off : off + self.W] = worker_speed; off += self.W
        buf[off : off + self.W] = worker_free; off += self.W
        buf[off : off + self.W] = worker_active; off += self.W
        buf[off : off + self.W] = hb_age
        if self._broken:
            raise RuntimeError(
                "multihost tick previously failed mid-collective; the "
                "fleet must be restarted (followers killed)"
            )
        # the broadcast stays OUTSIDE the broken-marking guard: if IT
        # fails, the followers are still parked in their matching
        # broadcast, and a later stop broadcast remains matched and safe
        shared = self._broadcast(buf)
        try:
            out = self._run(shared)
        except Exception:
            # the broadcast committed every follower to this tick's
            # collectives; no collective is safe from a diverged program
            self._broken = True
            log.critical(
                "multihost lead tick failed AFTER the broadcast: followers "
                "are blocked in this tick's collectives and will not "
                "receive a stop — kill them (or rely on their watchdog / "
                "process-group timeout) and restart the fleet"
            )
            raise
        # redispatch from the lead's own table: elementwise in the
        # replicated live vector, the tick's own formula
        occupied = inflight_worker >= 0
        redispatch = occupied & ~out.live[np.clip(inflight_worker, 0, None)]
        return out._replace(redispatch=redispatch)

    def lead_stop(self) -> None:
        if self._broken:
            # followers are stuck inside a failed tick's collectives, not
            # parked in the broadcast: a stop broadcast would be mismatched
            log.warning(
                "multihost stop skipped: fleet marked broken by a failed "
                "mid-tick collective (followers must be killed)"
            )
            return
        buf = np.zeros(self.buflen, dtype=np.float32)
        buf[0] = 1.0
        self._broadcast(buf)
        log.info("multihost stop broadcast sent")

    # -- follower side -----------------------------------------------------
    def follow_loop(self, watchdog_timeout: float | None = None) -> None:
        """Join broadcast and tick collectives until the lead sends the
        stop flag; between ticks this process waits inside the broadcast.

        ``watchdog_timeout``: seconds one tick's collectives may take
        before this follower assumes the lead died mid-tick and hard-exits.
        None/0 disables."""
        import time

        log.info("multihost follower %d: joined, waiting for ticks",
                 self.process_index)
        ticks = 0
        in_tick_since: list[float | None] = [None]
        if watchdog_timeout:
            watchdog(in_tick_since, watchdog_timeout,
                     f"multihost follower {self.process_index}")
        while True:
            # the idle park between ticks is the broadcast itself: only
            # the tick's collectives are under the watchdog
            buf = self._broadcast(np.zeros(self.buflen, dtype=np.float32))
            in_tick_since[0] = time.monotonic()
            stopped = self._run(buf) is None
            in_tick_since[0] = None
            if stopped:
                log.info("multihost follower %d: stop after %d ticks",
                         self.process_index, ticks)
                return
            ticks += 1
