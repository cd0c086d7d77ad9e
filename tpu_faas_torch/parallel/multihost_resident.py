"""Multihost RESIDENT tick: the delta-packet fast path over several
processes.

Counterpart of ``tpu_faas/parallel/multihost_resident.py``. The fleet's
per-tick traffic is the resident DELTA PACKET — a fixed-shape buffer of a
few tens of KB bounded by the per-tick churn capacities (KA/KH/KF/KI/KS/
KB), independent of how many tasks are pending or how big the fleet is.

The resident state is a pure function of the packet sequence
(``sched/resident.py`` keeps every mutable input in the packet,
time_to_expire included), so identical packets keep identical states.
The LEAD runs the normal ResidentScheduler host logic and broadcasts each
packet (flush or tick) before launching its kernel; every FOLLOWER applies
the same packet to its own state. The packet's opcode slot tells tick,
flush and stop apart, so the broadcast keeps one shape and followers
always know what to run.

Where JAX shards the task leaves over the global mesh and lets GSPMD run
the tick, every process here holds a FULL REPLICA of the resident state
and runs B1 (``csrc/fused_tick.cu``) on it: B1 is deterministic on rank
and auction, so every process gets bit-identical outputs, the lead's
those of one ``ResidentScheduler``. At the headline shape the whole state
is about 1.9 MB, which a card does not notice.

Cold start: ``pending_bulk_load`` (a host-side full upload) is not part of
the packet protocol; a restart backlog drips through arrival packets
instead. The dispatcher handles this (``supports_bulk_load``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from tpu_faas_torch.parallel import distributed
from tpu_faas_torch.parallel.multihost_tick import (
    broadcast_from_lead,
    watchdog,
)
from tpu_faas_torch.sched.resident import (
    _OP_FLUSH,
    _OP_STOP,
    _OP_TICK,
    ResidentScheduler,
    _ResidentState,
)
from tpu_faas_torch.utils.logging import get_logger

log = get_logger("parallel.multihost_resident")


class MultihostResidentScheduler(ResidentScheduler):
    """ResidentScheduler whose packets every process of the fleet applies.

    Construct with IDENTICAL shape/capacity parameters in every process
    (they define the packet layout). The lead (process 0) uses it exactly
    like a ResidentScheduler and calls :meth:`lead_stop` on shutdown.
    Followers call :meth:`follow_loop`."""

    @classmethod
    def from_shape(
        cls,
        *,
        max_workers: int,
        max_pending: int,
        max_inflight: int,
        max_slots: int,
        time_to_expire: float,
        placement: str,
        clock=None,
        device: str | torch.device = "cuda",
    ):
        """The ONE constructor every process uses: the packet layout must
        agree fleet-wide, so the lead, the followers and the lead's
        crash path build it from the same keywords (and the same
        ``use_priority`` pin)."""
        kw = dict(
            max_workers=max_workers,
            max_pending=max_pending,
            max_inflight=max_inflight,
            max_slots=max_slots,
            time_to_expire=time_to_expire,
            placement=placement,
            use_priority=True,
            device=device,
        )
        if clock is not None:
            kw["clock"] = clock
        return cls(**kw)

    def __init__(self, *args, **kw):
        device = distributed.process_device(kw.get("device", "cuda"))
        kw["device"] = device
        n = distributed.process_count() * len(
            distributed.local_devices(device))
        kw.setdefault("mesh_devices", n)
        super().__init__(*args, **kw)
        if self.mesh.size != n:
            raise ValueError(
                "multihost resident mode owns the GLOBAL mesh; do not pass "
                "a smaller mesh_devices"
            )
        self.process_index = distributed.process_index()
        self._broken = False
        # every process starts from the same empty state, before any
        # registration: the fleet then reaches every replica as packet
        # deltas, never as a host upload only the lead made
        self._ensure_state()

    # -- the packet protocol -----------------------------------------------
    def _broadcast(self, buf: np.ndarray) -> np.ndarray:
        # strict alternation with the kernels: this process's last launch
        # has finished before the next collective starts
        if self.device.type == "cuda" and self._r_state is not None:
            torch.cuda.synchronize(self.device)  # faas: allow(trace.host-sync) strict alternation: this process's last launch ends before the next collective
        return broadcast_from_lead(buf, self.device)

    def _apply_packet(self, packet: np.ndarray):
        """Run the kernel a packet's opcode names: the same in every
        process."""
        return self._launch(packet, flush=packet[7] == _OP_FLUSH)

    def _dispatch(self, packet: np.ndarray, op: float):
        """Broadcast one packet and apply it: the whole containment
        contract in one place (both kernel entry points share it)."""
        packet[7] = op
        if self._broken:
            raise RuntimeError(
                "multihost resident tick previously failed mid-collective; "
                "restart the fleet"
            )
        shared = self._broadcast(packet)
        try:
            return self._apply_packet(shared)
        except Exception:
            self._mark_broken()
            raise

    def _run_flush(self, packet: np.ndarray):
        return self._dispatch(packet, _OP_FLUSH)

    def _run_tick(self, packet: np.ndarray):
        return self._dispatch(packet, _OP_TICK)

    def _mark_broken(self) -> None:
        # the containment contract of MultihostTick.lead_tick: after a
        # failure past the broadcast the followers may be stuck, and any
        # further collective (the stop broadcast included) could hang
        self._broken = True
        log.critical(
            "multihost resident kernel failed AFTER its broadcast: "
            "followers may be blocked — kill them (watchdog / process-group "
            "timeout also applies) and restart the fleet"
        )

    supports_bulk_load = False

    def pending_bulk_load(self, *a, **kw):
        raise RuntimeError(
            "pending_bulk_load is host-local and cannot ride the multihost "
            "packet protocol; cold backlogs drip through arrival packets "
            "(raise KA to speed adoption)"
        )

    # -- lead shutdown / follower side -------------------------------------
    def lead_stop(self) -> None:
        if self._broken:
            log.warning(
                "multihost resident stop skipped: fleet marked broken"
            )
            return
        buf = np.zeros(self.packet_len(), dtype=np.float32)
        buf[7] = _OP_STOP
        self._broadcast(buf)
        # rendezvous before anyone exits: a follower that tears its process
        # down while the stop broadcast's transport tail is still in flight
        # could break the lead's side of it
        if distributed.is_multiprocess():
            dist.barrier()
        log.info("multihost resident stop broadcast sent")

    def follow_loop(self, watchdog_timeout: float | None = None) -> None:
        """Mirror the lead's packet stream until the stop opcode. The state
        evolves bit-identically from the packets alone; outputs are
        discarded. ``watchdog_timeout`` hard-exits the process if one
        packet's kernel and collectives block longer than that."""
        import time

        self._ensure_state()
        log.info(
            "multihost resident follower %d: joined, waiting for packets",
            self.process_index,
        )
        n = 0
        in_tick_since: list[float | None] = [None]
        if watchdog_timeout:
            watchdog(in_tick_since, watchdog_timeout,
                     f"multihost resident follower {self.process_index}")
        while True:
            packet = self._broadcast(
                np.zeros(self.packet_len(), dtype=np.float32)
            )
            if packet[7] == _OP_STOP:
                if distributed.is_multiprocess():
                    dist.barrier()
                log.info(
                    "multihost resident follower %d: stop after %d packets",
                    self.process_index, n,
                )
                return
            in_tick_since[0] = time.monotonic()
            res = self._apply_packet(packet)
            # a flush returns (state, arrival_slots), a tick (out, state)
            self._r_state = (res[0] if isinstance(res[0], _ResidentState)
                             else res[1])
            if self.device.type == "cuda":
                # the kernel under the watchdog too, not just its launch
                torch.cuda.synchronize(self.device)  # faas: allow(trace.host-sync) the follower's watchdog covers the kernel, not just its launch
            in_tick_since[0] = None
            n += 1
