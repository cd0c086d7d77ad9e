"""The batch scheduler tick: liveness + purge + placement + redistribution.

Counterpart of ``tpu_faas/sched/state.py``. One call computes what the
reference's push loop does in Python per tick — heartbeat-timeout
detection, placement — plus the redispatch of every in-flight task whose
worker just died.

Host side, :class:`SchedulerArrays` owns the mirrored numpy state (worker
registry, heartbeat stamps, in-flight table) and feeds the tick; its
bookkeeping is a copy of the JAX class's. Only the device methods are
PyTorch: the tick, the cached fleet uploads and the delta-maintained
in-flight mirror, and the auction's warm prices carried between ticks.
All three placements are ported: rank, auction (its bids run kernel B2 on
the card) and Sinkhorn (plain torch ops on both devices: the JAX batch tick
reaches no Pallas kernel for it), and so are the tenancy plane
(``tpu_faas_torch/tenancy``: plain torch ops here too) and the speculation
plane (``tpu_faas_torch/spec``: the straggler flags, the anti-affinity veto
and the hedge fixup, plain torch ops too), and the graph lanes
(``tpu_faas_torch/graph/frontier.py``: the dependency mask, the byte
preference and the locality exchange, plain torch ops as in JAX).

``mesh_devices=N`` shards the pending-task axis over a mesh of N positions
(``tpu_faas_torch/parallel/mesh.py``: N cards on ``cuda``, N host positions
on ``cpu``) and ticks through ``sharded_scheduler_tick``; ``multihost`` (a
``parallel.multihost_tick.MultihostTick``) routes the tick through its
``lead_tick`` over every process's positions. Both refuse the tenancy,
speculation, quarantine and graph lanes with JAX's ``ValueError``s: those
lanes are single-device, in JAX and here.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
import torch

from tpu_faas_torch.device import resolve_device, to_host, upload
from tpu_faas_torch.graph.frontier import (
    dep_ready_mask,
    locality_exchange,
    parent_pref_impl,
)
from tpu_faas_torch.sched.auction import auction_placement_impl
from tpu_faas_torch.sched.greedy import rank_match_placement_impl
from tpu_faas_torch.sched.scripted import call, scripted
from tpu_faas_torch.sched.sinkhorn import (
    sinkhorn_placement_bucketed_impl,
    sinkhorn_placement_impl,
)
from tpu_faas_torch.spec.straggler import (
    hedge_fixup_impl,
    straggler_flags_impl,
)
from tpu_faas_torch.tenancy.fairshare import (
    DEFAULT_STARVE_BOOST,
    DEFAULT_STARVE_DEFICIT,
    tenant_deficit_update_impl,
    tenant_fair_admission_impl,
)

_I32 = torch.int32


def check_placement(placement: str) -> None:
    if placement not in ("rank", "auction", "sinkhorn"):
        raise ValueError(f"unknown placement kernel {placement!r}")


#: the tick's Sinkhorn solvers: bucketed (its iterations over N_BUCKETS size
#: classes, bucket rounding) or dense, each with its iteration count
N_BUCKETS = 1024
BUCKETED_ITERS, DENSE_ITERS = 20, 60


def sinkhorn_bucketed(T: int, W: int) -> bool:
    """The tick's static Sinkhorn route: the bucketed solver when
    ``T * W > 2**24``, else the dense one."""
    return T * W > 2**24


class TickOutput(NamedTuple):
    assignment: torch.Tensor  # i32[T] worker index per pending task, -1 queued
    live: torch.Tensor  # bool[W]
    purged: torch.Tensor  # bool[W] was live last tick, dead now
    redispatch: torch.Tensor  # bool[I] in-flight task needs re-queue
    #: f32[W*max_slots] final slot prices (auction only, else None): the
    #: next tick's warm start, device-resident between ticks
    auction_price: torch.Tensor | None = None
    #: bool scalar (auction only): the prices went stale; the next tick
    #: re-solves cold
    auction_refresh: torch.Tensor | None = None
    #: bidding rounds this tick ran (auction only), counted on the host
    auction_rounds: int | None = None
    #: i32 scalar (auction only): tasks the rank spill placed
    auction_spilled: torch.Tensor | None = None
    #: rows that bid, summed over the rounds (auction only), counted on
    #: the host
    auction_bid_rows: int | None = None
    #: f32 final Sinkhorn potentials (Sinkhorn only): f over the iterated
    #: rows (tasks + slack, or buckets + slack), g over the workers + slack
    sinkhorn_f: torch.Tensor | None = None
    sinkhorn_g: torch.Tensor | None = None
    #: f32 scalar (Sinkhorn only): the effective temperature
    sinkhorn_tau: torch.Tensor | None = None
    #: f32[N_TENANTS] updated per-tenant deficit counters (tenancy plane
    #: only): the next tick's carry, device-resident between ticks
    tenant_deficit: torch.Tensor | None = None
    #: bool[T] the tasks placement saw as valid (tenancy plane only): the
    #: valid tasks minus those past their tenant's inflight-cap allowance
    tenant_eligible: torch.Tensor | None = None
    #: bool[I] straggler flags (speculation plane only, else None): in-flight
    #: slots past their predicted runtime on a still-live worker
    straggler: torch.Tensor | None = None


def fleet_state(
    worker_active: torch.Tensor,  # bool[W] registered
    heartbeat_age: torch.Tensor,  # f32[W] seconds since last heartbeat
    prev_live: torch.Tensor,  # bool[W]
    inflight_worker: torch.Tensor,  # i32[I] worker per in-flight slot
    time_to_expire: torch.Tensor | float,  # f32 scalar
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """A tick's failure detection: (live, purged, redispatch)."""
    # ages, not absolute stamps (f32 error stays on a small number); one
    # compare spelled twice, so that TorchScript types each branch
    if isinstance(time_to_expire, torch.Tensor):
        fresh = heartbeat_age <= time_to_expire
    else:
        fresh = heartbeat_age <= time_to_expire
    live = worker_active & fresh
    purged = prev_live & ~live
    # in-flight redistribution: the gather clamps like XLA's, a row past W
    # reads the last worker. index_select, not live[...]: on the CPU
    # aten::index opens a parallel region at a few thousand rows, and on a
    # loaded host gathering the intra-op pool for it took milliseconds a
    # tick (ROADMAP C.12)
    worker_of = inflight_worker.clamp(0, live.shape[0] - 1).long()
    redispatch = (inflight_worker >= 0) & ~live.index_select(0, worker_of)
    return live, purged, redispatch


def scheduler_tick_impl(
    task_size: torch.Tensor,  # f32[T]
    task_valid: torch.Tensor,  # bool[T]
    worker_speed: torch.Tensor,  # f32[W]
    worker_free: torch.Tensor,  # i32[W]
    worker_active: torch.Tensor,  # bool[W] registered
    heartbeat_age: torch.Tensor,  # f32[W] seconds since last heartbeat
    prev_live: torch.Tensor,  # bool[W]
    inflight_worker: torch.Tensor,  # i32[I] worker per in-flight slot, -1 empty
    time_to_expire: torch.Tensor | float,  # f32 scalar
    max_slots: int = 8,
    task_priority: torch.Tensor | None = None,  # i32[T], higher first
    placement: str = "rank",
    worker_health: torch.Tensor | None = None,  # f32[W] tail multiplier
    worker_place_cap: torch.Tensor | None = None,  # i32[W] placement ceiling
    auction_price: torch.Tensor | None = None,  # f32[W*max_slots] warm start
    auction_refresh: torch.Tensor | None = None,  # bool scalar: resident carry
    sinkhorn_potentials: tuple[torch.Tensor, torch.Tensor] | None = None,
    task_tenant: torch.Tensor | None = None,  # i32[T] dense tenant rows
    tenant_share: torch.Tensor | None = None,  # f32[N] weights
    tenant_deficit: torch.Tensor | None = None,  # f32[N] carried counters
    tenant_ahead: torch.Tensor | None = None,  # i32[N] inflight per tenant
    tenant_cap: torch.Tensor | None = None,  # i32[N] ceilings (0 = uncapped)
    starve_deficit: float = DEFAULT_STARVE_DEFICIT,
    starve_boost: int = DEFAULT_STARVE_BOOST,
    spec_elapsed: torch.Tensor | None = None,  # f32[I] seconds since dispatch
    spec_predicted: torch.Tensor | None = None,  # f32[I] predicted runtime
    spec_mult=None,  # f32 scalar straggler multiplier
    spec_min_s=None,  # f32 scalar absolute floor
    task_avoid_worker: torch.Tensor | None = None,  # i32[T] forbidden row
) -> TickOutput:
    """One batch tick. ``sinkhorn_potentials`` (Sinkhorn only) replaces the
    solver's iterations with given final (f, g): the replay of a rounding
    from the CUDA kernel's own potentials. ``task_tenant`` turns the
    tenancy plane on: the inflight-cap eligibility narrows ``task_valid``
    for every placement, the weighted-fair admission order feeds rank's
    cut, and the deficit carry runs on the final assignment.
    ``spec_elapsed`` turns the straggler flags on (they ride the liveness
    pass: a slot flags only while its worker is live); ``task_avoid_worker``
    runs the hedge fixup after every placement, before the deficit carry,
    on the effective speeds and the capped free counts."""
    check_placement(placement)
    # tail-health multiplier on effective speed, and the quarantine plane's
    # per-row placement ceiling: two elementwise lanes ahead of placement
    if worker_health is not None:
        worker_speed = worker_speed * worker_health
    if worker_place_cap is not None:
        worker_free = torch.minimum(worker_free, worker_place_cap)
    live, purged, redispatch = fleet_state(
        worker_active, heartbeat_age, prev_live, inflight_worker,
        time_to_expire)

    # -- speculation plane: straggler flags on the same liveness pass
    straggler = None
    if spec_elapsed is not None:
        iw = inflight_worker
        worker_of = iw.clamp(0, worker_speed.shape[0] - 1).long()
        straggler = straggler_flags_impl(
            spec_elapsed, spec_predicted,
            (iw >= 0) & live.index_select(0, worker_of),
            spec_mult, spec_min_s,
        )

    def veto(assignment):
        # anti-affinity for hedge rows: veto, then re-place the vetoed tail
        if task_avoid_worker is None:
            return assignment
        return hedge_fixup_impl(assignment, task_avoid_worker, worker_speed,
                                worker_free, live)

    # -- tenancy plane: the cap mask narrows task_valid for EVERY placement;
    # the fair order feeds rank's admission cut alone
    adm_rank = demand = None
    if task_tenant is not None:
        eligible, adm_rank, demand = tenant_fair_admission_impl(
            task_valid, task_tenant, task_priority, tenant_share,
            tenant_deficit, tenant_ahead, tenant_cap,
            starve_deficit=starve_deficit, starve_boost=starve_boost,
        )
        task_valid = task_valid & eligible

    def tenancy_out(assignment) -> dict:
        if task_tenant is None:
            return dict(straggler=straggler)
        return dict(
            straggler=straggler,
            tenant_deficit=tenant_deficit_update_impl(
                assignment, task_tenant, demand, tenant_share, tenant_deficit
            ),
            tenant_eligible=task_valid,
        )

    # auction ignores task_priority: its admission order is FCFS
    if placement == "auction":
        res = auction_placement_impl(
            task_size, task_valid, worker_speed, worker_free, live,
            max_slots=max_slots, init_price=auction_price,
            carry_refresh=auction_refresh,
        )
        assignment = veto(res.assignment)
        return TickOutput(assignment, live, purged, redispatch,
                          res.prices, res.refresh, res.n_rounds,
                          res.n_spilled, res.n_bid_rows,
                          **tenancy_out(assignment))
    # Sinkhorn ignores task_priority too: every valid task competes
    if placement == "sinkhorn":
        T, W = task_size.shape[0], worker_speed.shape[0]
        if sinkhorn_bucketed(T, W):
            res = sinkhorn_placement_bucketed_impl(
                task_size, task_valid, worker_speed, worker_free, live,
                max_slots=max_slots, n_iters=BUCKETED_ITERS,
                n_buckets=N_BUCKETS, rounding="bucket",
                potentials=sinkhorn_potentials,
            )
        else:
            res = sinkhorn_placement_impl(
                task_size, task_valid, worker_speed, worker_free, live,
                max_slots=max_slots, n_iters=DENSE_ITERS,
                potentials=sinkhorn_potentials,
            )
        assignment = veto(res.assignment)
        return TickOutput(assignment, live, purged, redispatch,
                          sinkhorn_f=res.f, sinkhorn_g=res.g,
                          sinkhorn_tau=res.tau,
                          **tenancy_out(assignment))
    assignment = rank_match_placement_impl(
        task_size, task_valid, worker_speed, worker_free, live,
        max_slots=max_slots, task_priority=task_priority,
        task_adm_rank=adm_rank,
    )
    assignment = veto(assignment)
    return TickOutput(assignment, live, purged, redispatch,
                      **tenancy_out(assignment))


def _unpack(packed: torch.Tensor, n_valid: int, T: int, W: int
            ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`packed_tick`'s upload as (sizes, valid mask, heartbeat ages,
    free counts), the valid mask built on the device from the count."""
    task_valid = torch.arange(T, device=packed.device) < n_valid
    return (packed[:T], task_valid, packed[T:T + W],
            packed[T + W:].to(torch.int32))


def _rank_tick(
    packed: torch.Tensor,
    n_valid: int,
    worker_speed: torch.Tensor,
    worker_active: torch.Tensor,
    prev_live: torch.Tensor,
    inflight_worker: torch.Tensor,
    time_to_expire: torch.Tensor | float,
    task_priority: torch.Tensor | None,
    worker_place_cap: torch.Tensor | None,
    T: int,
    W: int,
    max_slots: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`packed_tick` with rank placement and no plane or graph lane:
    (assignment, live, purged, redispatch), one scripted call
    (``sched/scripted.py``; ROADMAP C.12)."""
    task_size, task_valid, hb_age, worker_free = _unpack(packed, n_valid, T,
                                                         W)
    if worker_place_cap is not None:
        worker_free = torch.minimum(worker_free, worker_place_cap)
    live, purged, redispatch = fleet_state(
        worker_active, hb_age, prev_live, inflight_worker, time_to_expire)
    assignment = rank_match_placement_impl(
        task_size, task_valid, worker_speed, worker_free, live,
        max_slots=max_slots, task_priority=task_priority)
    return assignment, live, purged, redispatch


def packed_tick(
    packed: torch.Tensor,  # f32[T + 2W]: sizes ++ heartbeat ages ++ free
    n_valid: int,  # first n rows of the batch are real tasks
    worker_speed: torch.Tensor,
    worker_active: torch.Tensor,
    prev_live: torch.Tensor,
    inflight_worker: torch.Tensor,
    time_to_expire: float,
    task_priority: torch.Tensor | None,
    auction_price: torch.Tensor | None = None,
    worker_place_cap: torch.Tensor | None = None,
    *,
    T: int,
    W: int,
    max_slots: int,
    placement: str = "rank",
    dep_edge_child: torch.Tensor | None = None,  # i32[E] batch row (pad = T)
    dep_edge_undone: torch.Tensor | None = None,  # i32[E] 1 while unconfirmed
    task_pref: torch.Tensor | None = None,  # i32[T] preferred row, -1 none
    pref_child: torch.Tensor | None = None,  # i32[P] batch row per lane
    pref_row: torch.Tensor | None = None,  # i32[P] row holding parent bytes
    pref_bytes: torch.Tensor | None = None,  # f32[P] bytes that row holds
    **plane_kw,
) -> TickOutput:
    """scheduler_tick behind a transfer-minimal calling convention:
    everything that changes every tick (sizes, heartbeat ages, free counts)
    rides ONE packed upload, and the valid mask is built on the device from
    a host integer. The rest is device-resident between ticks.
    ``plane_kw`` are the tenancy and speculation planes' arguments of
    :func:`scheduler_tick_impl`.

    The graph lanes compose as in JAX's ``_packed_tick``: the dependency
    mask narrows the valid tasks before placement, the byte preference
    overrides the function preference wherever it is >= 0, and the
    locality exchange runs on the final assignment, after the tenancy and
    speculation planes. The rank tick with no plane or graph lane, the
    production default, is one scripted call (:func:`_rank_tick`)."""
    if placement == "rank" and not plane_kw and all(
            x is None for x in (dep_edge_child, task_pref, pref_child)):
        return TickOutput(*call(
            _rank_tick, packed, n_valid, worker_speed, worker_active,
            prev_live, inflight_worker, time_to_expire, task_priority,
            worker_place_cap, T, W, max_slots))
    task_size, task_valid, hb_age, worker_free = _unpack(packed, n_valid, T,
                                                         W)
    if dep_edge_child is not None:
        task_valid = task_valid & dep_ready_mask(
            dep_edge_child, dep_edge_undone, T=T
        )
    if pref_child is not None:
        byte_pref = parent_pref_impl(pref_child, pref_row, pref_bytes, T=T)
        task_pref = (
            byte_pref
            if task_pref is None
            else torch.where(byte_pref >= 0, byte_pref, task_pref)
        )
    out = scheduler_tick_impl(
        task_size, task_valid, worker_speed, worker_free, worker_active,
        hb_age, prev_live, inflight_worker, time_to_expire,
        max_slots=max_slots, task_priority=task_priority,
        placement=placement, worker_place_cap=worker_place_cap,
        auction_price=auction_price, **plane_kw,
    )
    if task_pref is not None:
        out = out._replace(
            assignment=locality_exchange(out.assignment, task_pref,
                                         worker_speed)
        )
    return out


@dataclass
class SchedulerArrays:
    """Host mirror of scheduler state, padded to static shapes.

    Worker rows are allocated on register and recycled after purge+timeout;
    the in-flight table maps slot -> (task_id, worker_row). ``device`` is
    where the tick runs: ``"cuda"`` by default, ``"cpu"`` on request.
    """

    max_workers: int = 256
    max_pending: int = 1024
    max_inflight: int = 4096
    max_slots: int = 8
    time_to_expire: float = 10.0
    clock: "callable" = time.monotonic
    #: placement kernel for the tick: rank, auction or sinkhorn
    placement: str = "rank"
    #: multi-process collective tick (parallel.multihost_tick.MultihostTick)
    #: — when set, tick() routes through its lead_tick over the GLOBAL mesh
    #: instead of the local device path; mutually exclusive with
    #: mesh_devices (the MultihostTick owns the mesh)
    multihost: "object | None" = None
    #: shard the pending-task axis over this many positions (0/None = one
    #: device); the tick then runs parallel.mesh.sharded_scheduler_tick
    mesh_devices: int | None = None
    device: "str | torch.device" = "cuda"

    worker_speed: np.ndarray = field(init=False)
    worker_free: np.ndarray = field(init=False)
    worker_active: np.ndarray = field(init=False)
    last_heartbeat: np.ndarray = field(init=False)
    prev_live: np.ndarray = field(init=False)
    worker_procs: np.ndarray = field(init=False)  # registered num_processes

    def __post_init__(self) -> None:
        check_placement(self.placement)
        self.device = resolve_device(self.device)
        self.mesh = None
        if self.mesh_devices:
            from tpu_faas_torch.parallel.mesh import (
                make_mesh,
                prepare_sinkhorn,
            )

            # N distinct cards on cuda (fewer present raises), N host
            # positions on cpu
            self.mesh = make_mesh(self.mesh_devices, device=self.device)
            if self.placement == "sinkhorn":
                # the scripted tick compiled here, not in the first tick
                prepare_sinkhorn()
            if self.max_pending % self.mesh_devices:
                # the task axis must split evenly; round up rather than
                # reject — max_pending is a padding size anyway
                self.max_pending += self.mesh_devices - (
                    self.max_pending % self.mesh_devices
                )
        elif self.placement == "rank":
            # the scripted rank tick compiled here, not in the first tick
            scripted(_rank_tick)
        W = self.max_workers
        self.worker_speed = np.zeros(W, dtype=np.float32)
        #: tail-health multiplier on effective placement speed (1.0 =
        #: healthy); only the speculation plane produces losses
        self.worker_health = np.ones(W, dtype=np.float32)
        self._last_health_recover: float | None = None
        #: id-keyed health memory (stable identity -> (health, stamp))
        self.health_memory: dict[bytes, tuple[float, float]] = {}
        self.worker_free = np.zeros(W, dtype=np.int32)
        self.worker_active = np.zeros(W, dtype=bool)
        # float64: absolute monotonic timestamps live host-side only; the
        # device receives f32 *ages*
        self.last_heartbeat = np.full(W, -np.inf, dtype=np.float64)
        self.prev_live = np.zeros(W, dtype=bool)
        self.worker_procs = np.zeros(W, dtype=np.int32)
        # worker identity (e.g. zmq routing id) <-> row index
        self.worker_ids: dict[bytes, int] = {}
        self.row_ids: dict[int, bytes] = {}
        # in-flight table
        self.inflight_task: list[str | None] = [None] * self.max_inflight
        self.inflight_worker: np.ndarray = np.full(
            self.max_inflight, -1, dtype=np.int32
        )
        self.inflight_started: np.ndarray = np.zeros(
            self.max_inflight, dtype=np.float64
        )
        self.inflight_pred: np.ndarray = np.zeros(
            self.max_inflight, dtype=np.float32
        )
        #: straggler threshold (speculation plane): None = plane off; the
        #: dispatcher sets both from its --speculate-* knobs
        self.spec_mult: float | None = None
        self.spec_min_s: float = 0.05
        self._inflight_slot: dict[str, int] = {}  # task_id -> slot
        self._free_inflight: list[int] = list(
            range(self.max_inflight - 1, -1, -1)
        )
        # device mirror of inflight_worker, updated by small scatters
        self._d_inflight: torch.Tensor | None = None
        self._inflight_delta: dict[int, int] = {}
        # device cache of rarely-changing fleet arrays, keyed by name; each
        # tick compares the live host array against the cached snapshot and
        # re-uploads only on change
        self._dev_cache: dict[str, tuple[np.ndarray, torch.Tensor]] = {}
        #: tenancy plane: the host TenantTable (None = off); with it set,
        #: tick(task_tenants=...) runs the in-tick fairness lane
        self.tenancy = None
        # the per-tenant deficit carry, device-resident between ticks
        self._d_tenant_deficit: torch.Tensor | None = None
        # auction placement: last tick's slot prices, the next tick's warm
        # start (device-resident), and last tick's staleness flag, read one
        # tick late
        self._d_auction_price: torch.Tensor | None = None
        self._d_auction_refresh: torch.Tensor | None = None

    # -- membership (reference register/reconnect/purge semantics) ---------
    def register(
        self, worker_id: bytes, num_processes: int, speed: float = 1.0
    ) -> int:
        """New or returning worker announces itself with its capacity."""
        if worker_id in self.worker_ids:
            row = self.worker_ids[worker_id]
        else:
            inactive = np.flatnonzero(~self.worker_active)
            if len(inactive) == 0:
                raise RuntimeError("worker table full; raise max_workers")
            row = int(inactive[0])
            self.worker_ids[worker_id] = row
            self.row_ids[row] = worker_id
        self.worker_active[row] = True
        self.worker_speed[row] = speed
        # clean tail-health slate: the row may be recycled from a purged
        # worker, and a fresh registrant must not inherit its penalty
        self.worker_health[row] = 1.0
        self.worker_procs[row] = num_processes
        self.worker_free[row] = num_processes
        self.last_heartbeat[row] = self.clock()
        return row

    def reconnect(self, worker_id: bytes, free_processes: int) -> int:
        """Purged-but-alive worker rejoins with its current free capacity.
        Total capacity is the best known value: the previous registration's
        num_processes if the row still exists, else the reported free
        count."""
        prev_row = self.worker_ids.get(worker_id)
        prev_procs = (
            int(self.worker_procs[prev_row]) if prev_row is not None else 0
        )
        row = self.register(worker_id, max(free_processes, 0))
        self.worker_procs[row] = max(prev_procs, free_processes)
        self.worker_free[row] = free_processes
        return row

    def heartbeat(self, worker_id: bytes) -> None:
        row = self.worker_ids.get(worker_id)
        if row is not None:
            self.last_heartbeat[row] = self.clock()

    def deactivate(self, row: int) -> None:
        """Purge bookkeeping after the tick reported the worker dead. Drops
        the identity mapping too, so a zombie reappearing under the old
        identity re-registers fresh instead of aliasing a recycled row."""
        self.worker_active[row] = False
        self.worker_free[row] = 0
        wid = self.row_ids.pop(row, None)
        if wid is not None:
            self.worker_ids.pop(wid, None)

    # -- tail-aware worker health ------------------------------------------
    HEALTH_DECAY = 0.8
    HEALTH_FLOOR = 0.25
    HEALTH_RECOVERY_TAU = 30.0
    MISFIRE_DECAY = 0.85
    RECLAIM_DECAY = 0.7
    HEALTH_MEMORY_MAX = 4096

    def note_hedge_loss(self, row: int) -> None:
        """The original placement on ``row`` lost its hedge race: decay the
        row's health multiplier."""
        if 0 <= row < len(self.worker_health) and self.worker_active[row]:
            self.worker_health[row] = max(
                self.HEALTH_FLOOR,
                float(self.worker_health[row]) * self.HEALTH_DECAY,
            )

    def _recover_health(self, now: float) -> None:
        """Exponential recovery toward 1.0; rows within noise of 1.0 snap
        to exactly 1.0 so the all-healthy steady state is bit-stable."""
        last = self._last_health_recover
        self._last_health_recover = now
        if last is None or not (self.worker_health < 0.9999).any():
            return
        dt = now - last
        if dt <= 0.0:
            return
        alpha = 1.0 - math.exp(-dt / self.HEALTH_RECOVERY_TAU)
        h = self.worker_health
        h += (np.float32(1.0) - h) * np.float32(alpha)
        np.copyto(h, np.float32(1.0), where=h > 0.999)

    def _decay_health(self, row: int, factor: float) -> None:
        if 0 <= row < len(self.worker_health) and self.worker_active[row]:
            self.worker_health[row] = max(
                self.HEALTH_FLOOR, float(self.worker_health[row]) * factor
            )

    def note_misfire(self, row: int, n_new: int = 1) -> None:
        """``n_new`` fresh pool-child misfires were attributed to ``row``."""
        if n_new > 0:
            self._decay_health(row, self.MISFIRE_DECAY ** min(n_new, 8))

    def note_reclaim(self, row: int) -> None:
        """A task was reclaimed from ``row`` (its worker died holding it)."""
        self._decay_health(row, self.RECLAIM_DECAY)

    # -- id-keyed health memory (survives purge + re-register) -------------
    def remember_health(self, ident: bytes, row: int) -> None:
        """Stash ``row``'s health under a stable identity at purge time."""
        if not ident or not (0 <= row < len(self.worker_health)):
            return
        h = float(self.worker_health[row])
        if h >= 0.9999:
            self.health_memory.pop(ident, None)
            return
        if (
            len(self.health_memory) >= self.HEALTH_MEMORY_MAX
            and ident not in self.health_memory
        ):
            self.health_memory.pop(next(iter(self.health_memory)))
        self.health_memory[ident] = (h, self.clock())

    def recall_health(self, ident: bytes, row: int) -> None:
        """Re-apply a remembered penalty to a freshly registered row,
        crediting exponential recovery for the time spent away."""
        if not ident:
            return
        entry = self.health_memory.pop(ident, None)
        if entry is None or not (0 <= row < len(self.worker_health)):
            return
        h, stamp = entry
        dt = max(0.0, self.clock() - stamp)
        alpha = 1.0 - math.exp(-dt / self.HEALTH_RECOVERY_TAU)
        h = h + (1.0 - h) * alpha
        if h < 0.9999:
            self.worker_health[row] = np.float32(h)

    # -- in-flight table ---------------------------------------------------
    @property
    def n_inflight(self) -> int:
        return len(self._inflight_slot)

    def _note_inflight(self, slot: int, row: int) -> None:
        """Record a slot write for the device mirror's next delta scatter."""
        if self._d_inflight is not None:
            self._inflight_delta[slot] = row

    def inflight_add(self, task_id: str, row: int, pred: float = 0.0) -> int:
        if not self._free_inflight:
            raise RuntimeError("inflight table full; raise max_inflight")
        slot = self._free_inflight.pop()
        self.inflight_task[slot] = task_id
        self.inflight_worker[slot] = row
        self.inflight_started[slot] = self.clock()
        self.inflight_pred[slot] = max(0.0, float(pred))
        self._note_inflight(slot, row)
        self._inflight_slot[task_id] = slot
        return slot

    def inflight_owner(self, task_id: str) -> int | None:
        """Worker row currently holding this task, or None if not in flight."""
        slot = self._inflight_slot.get(task_id)
        return None if slot is None else int(self.inflight_worker[slot])

    def release_slot(self, row: int) -> None:
        """Return one process slot to a worker row, clamped to the row's
        registered capacity — the single capacity-restore rule for every
        host-side give-back. Out-of-range rows are ignored."""
        if 0 <= row < len(self.worker_free):
            self.worker_free[row] = min(
                self.worker_free[row] + 1, int(self.worker_procs[row])
            )

    def inflight_done(self, task_id: str) -> int | None:
        """Result arrived: free the slot, return the worker row."""
        slot = self._inflight_slot.pop(task_id, None)
        if slot is None:
            return None
        row = int(self.inflight_worker[slot])
        self.inflight_task[slot] = None
        self.inflight_worker[slot] = -1
        self.inflight_started[slot] = 0.0
        self.inflight_pred[slot] = 0.0
        self._note_inflight(slot, -1)
        self._free_inflight.append(slot)
        return row

    @staticmethod
    def assigned_counts(assignment: np.ndarray, n_workers: int) -> np.ndarray:
        """Per-worker tasks handed out this tick, from the readback."""
        a = np.asarray(assignment)
        return np.bincount(a[a >= 0], minlength=n_workers).astype(np.int32)

    def inflight_clear_slot(self, slot: int) -> str | None:
        tid = self.inflight_task[slot]
        self.inflight_task[slot] = None
        self.inflight_worker[slot] = -1
        self.inflight_started[slot] = 0.0
        self.inflight_pred[slot] = 0.0
        self._note_inflight(slot, -1)
        if tid is not None:
            self._inflight_slot.pop(tid, None)
            self._free_inflight.append(slot)
        return tid

    def tenant_deficits(self) -> np.ndarray | None:
        """Host view of the device-carried per-tenant deficit vector (one
        sync, stats surface only); None before the first tenancy tick."""
        d = self._d_tenant_deficit
        return None if d is None else to_host(d)

    # -- device side -------------------------------------------------------
    def _device_inflight(self) -> torch.Tensor:
        """The inflight table as a device tensor, maintained incrementally:
        a full upload when absent or when more than half the table changed,
        else one scatter of the dirty slots. Uploads are snapshots (see
        :func:`tpu_faas_torch.device.upload`): a host mutation landing
        before the enqueued tick runs must not leak into it."""
        if (
            self._d_inflight is None
            or len(self._inflight_delta) > self.max_inflight // 2
        ):
            self._inflight_delta.clear()
            self._d_inflight = upload(self.inflight_worker, self.device)
        elif self._inflight_delta:
            n = len(self._inflight_delta)
            delta = np.empty((2, n), dtype=np.int64)
            delta[0] = np.fromiter(self._inflight_delta.keys(), np.int64, n)
            delta[1] = np.fromiter(self._inflight_delta.values(), np.int64, n)
            self._inflight_delta.clear()
            d = upload(delta, self.device)
            # out of place: an earlier tick still queued may read the old
            self._d_inflight = self._d_inflight.index_put(
                (d[0],), d[1].to(_I32)
            )
        return self._d_inflight

    def _cached_dev(self, name: str, host: np.ndarray) -> torch.Tensor:
        """Device copy of a host fleet array, re-uploaded only when the host
        content actually changed (cheap compare per tick)."""
        entry = self._dev_cache.get(name)
        if entry is not None and np.array_equal(entry[0], host):
            return entry[1]
        snap = host.copy()
        dev = upload(snap, self.device)
        self._dev_cache[name] = (snap, dev)
        return dev

    def _prev_live_dev(self) -> torch.Tensor:
        pl = self.prev_live
        if isinstance(pl, np.ndarray):
            return upload(pl, self.device)
        return pl

    # -- the tick ----------------------------------------------------------
    def tick(
        self,
        task_sizes: np.ndarray,
        now: float | None = None,
        task_priorities: np.ndarray | None = None,
        dep_edges: tuple[np.ndarray, np.ndarray] | None = None,
        task_pref: np.ndarray | None = None,
        pref_edges: tuple[np.ndarray, np.ndarray, np.ndarray] | None = None,
        task_tenants=None,
        task_avoid=None,
        worker_place_cap: np.ndarray | None = None,
    ) -> TickOutput:
        """Run the batch device step for the current pending batch.

        ``task_sizes`` is the un-padded vector of pending task cost
        estimates; padding/masking to ``max_pending`` happens here.
        ``task_priorities`` (optional, parallel to ``task_sizes``) orders
        admission under overload — higher first, FCFS within a priority.
        ``worker_place_cap`` (optional, i32[max_workers]) is the quarantine
        plane's placement ceiling. ``task_tenants`` (optional, the dense
        tenant row of each task) runs the tenancy plane when ``tenancy``
        holds a TenantTable, with the deficit carried on the device between
        ticks; without a table it is ignored, as in the JAX tick. With
        ``spec_mult`` set the tick flags stragglers (``TickOutput.straggler``)
        from the host's dispatch stamps and predictions, and scales speeds
        by the recovered ``worker_health``; ``task_avoid`` (optional, the
        forbidden worker row of each task, -1 none) runs the hedge fixup.
        ``dep_edges`` (optional) is the graph frontier's padded
        (edge_child, edge_undone) pair: the tick masks rows with
        unconfirmed parents. ``task_pref`` (optional, i32[max_pending]) is
        the graph locality preference the post-placement exchange applies;
        ``pref_edges`` (optional) is the result data plane's padded
        (pref_child, pref_row, pref_bytes) triplet, overriding
        ``task_pref`` where it applies (``graph/frontier.py``). A mesh or
        multihost tick refuses every one of these lanes, as JAX's does.
        """
        n = len(task_sizes)
        sharded = self.multihost is not None or self.mesh is not None
        if sharded and (dep_edges is not None or task_pref is not None
                        or pref_edges is not None):
            raise ValueError(
                "graph frontier args are single-device only; mesh/"
                "multihost dispatchers must rely on promotion announces"
            )
        tenancy_on = self.tenancy is not None and task_tenants is not None
        if tenancy_on and sharded:
            raise ValueError(
                "the tenancy plane is single-device only in the one-shot "
                "tick; mesh/multihost fleets run without in-tick fairness"
            )
        if sharded and (self.spec_mult is not None
                        or task_avoid is not None):
            raise ValueError(
                "the speculation plane is single-device only; mesh/"
                "multihost fleets run without straggler hedging"
            )
        if worker_place_cap is not None and sharded:
            raise ValueError(
                "the quarantine plane is single-device only; mesh/"
                "multihost fleets run without placement ceilings"
            )
        if n > self.max_pending:
            raise ValueError(f"{n} pending > max_pending={self.max_pending}")
        T, W = self.max_pending, self.max_workers
        now_f = now if now is not None else self.clock()
        if self.multihost is not None:
            # the collective tick over every process's positions; returns
            # host arrays (the whole assignment), priorities on the
            # broadcast
            out = self.multihost.lead_tick(
                np.asarray(task_sizes, dtype=np.float32),
                self.worker_speed,
                self.worker_free,
                self.worker_active,
                (now_f - self.last_heartbeat).astype(np.float32),
                self.inflight_worker,
                self.time_to_expire,
                task_priorities=(
                    None if task_priorities is None
                    else np.asarray(task_priorities, dtype=np.int32)
                ),
            )
            self.prev_live = out.live
            return out
        if self._d_auction_refresh is not None and bool(  # faas: allow(trace.host-sync) the batch auction's refresh flag, computed a tick ago: one read a tick
            self._d_auction_refresh
        ):
            # last tick's prices went stale: re-solve cold this tick (the
            # read is of a value computed a whole tick ago)
            self._d_auction_price = None
        self._d_auction_refresh = None
        if self.mesh is not None:
            ts = np.zeros(T, dtype=np.float32)
            ts[:n] = task_sizes
            prio = None
            if task_priorities is not None:
                prio = np.zeros(T, dtype=np.int32)
                prio[:n] = task_priorities
            out = self._tick_sharded(
                ts, n, (now_f - self.last_heartbeat).astype(np.float32), prio)
            if self.placement == "auction":
                self._d_auction_price = out.auction_price
                self._d_auction_refresh = out.auction_refresh
            self.prev_live = out.live
            return out
        # one packed upload carries everything that changes every tick
        packed = np.zeros(T + 2 * W, dtype=np.float32)
        packed[:n] = task_sizes
        packed[T : T + W] = (now_f - self.last_heartbeat).astype(np.float32)
        packed[T + W :] = self.worker_free
        prio = None
        if task_priorities is not None:
            p = np.zeros(self.max_pending, dtype=np.int32)
            p[:n] = task_priorities
            prio = upload(p, self.device)
        cap = None
        if worker_place_cap is not None:
            cap = self._cached_dev(
                "place_cap", np.asarray(worker_place_cap, dtype=np.int32)
            )
        tenant_kw: dict = {}
        if tenancy_on:
            ten = self.tenancy
            tt = np.zeros(T, dtype=np.int32)
            tt[:n] = task_tenants
            if self._d_tenant_deficit is None:
                self._d_tenant_deficit = torch.zeros(
                    ten.max_tenants, dtype=torch.float32, device=self.device
                )
            # share and cap change only on a hot reload (cached uploads);
            # the inflight counts are per tick. Snapshots throughout: the
            # table mutates between ticks
            tenant_kw = dict(
                task_tenant=upload(tt, self.device),
                tenant_share=self._cached_dev("tenant_share", ten.share),
                tenant_deficit=self._d_tenant_deficit,
                tenant_ahead=upload(ten.inflight, self.device),
                tenant_cap=self._cached_dev("tenant_cap", ten.cap),
            )
        spec_kw: dict = {}
        if self.spec_mult is not None:
            # elapsed ages are computed on the host in float64, like the
            # heartbeat ages, then cast; pred ships as a snapshot (the act
            # loop mutates it as soon as tick() returns). Tail health rides
            # the same gate: only the speculation plane produces losses
            self._recover_health(now_f)
            spec_kw = dict(
                spec_elapsed=upload(
                    (now_f - self.inflight_started).astype(np.float32),
                    self.device),
                spec_predicted=upload(self.inflight_pred, self.device),
                spec_mult=float(np.float32(self.spec_mult)),
                spec_min_s=float(np.float32(self.spec_min_s)),
                worker_health=self._cached_dev("health", self.worker_health),
            )
        if task_avoid is not None:
            av = np.full(T, -1, dtype=np.int32)
            av[:n] = task_avoid
            spec_kw["task_avoid_worker"] = upload(av, self.device)
        graph: dict = {}
        if dep_edges is not None:
            graph.update(dep_edge_child=dep_edges[0],
                         dep_edge_undone=dep_edges[1])
        if task_pref is not None:
            graph["task_pref"] = task_pref
        if pref_edges is not None:
            graph.update(zip(("pref_child", "pref_row", "pref_bytes"),
                             pref_edges))
        graph_kw = {
            k: upload(np.asarray(v, np.float32 if k == "pref_bytes"
                                 else np.int32), self.device)
            for k, v in graph.items()
        }
        out = packed_tick(
            upload(packed, self.device),
            n,
            self._cached_dev("speed", self.worker_speed),
            self._cached_dev("active", self.worker_active),
            self._prev_live_dev(),
            self._device_inflight(),
            # the f32 value JAX compares against: read as float, cast back
            # to float32 by the comparison
            float(np.float32(self.time_to_expire)),
            prio,
            self._d_auction_price,
            cap,
            T=T,
            W=W,
            max_slots=self.max_slots,
            placement=self.placement,
            **graph_kw,
            **tenant_kw,
            **spec_kw,
        )
        if self.placement == "auction":
            self._d_auction_price = out.auction_price
            self._d_auction_refresh = out.auction_refresh
        if tenancy_on:
            self._d_tenant_deficit = out.tenant_deficit
        # prev_live stays DEVICE-resident: it only feeds the next tick, and
        # reading it back here would put a sync inside every tick
        self.prev_live = out.live
        return out

    def _tick_sharded(
        self,
        ts: np.ndarray,
        n_valid: int,
        hb_age: np.ndarray,
        prio: np.ndarray | None,
    ) -> TickOutput:
        """The mesh tick: the sizes (and priorities) sharded over the task
        axis, the fleet replicated, the semantics of the single-device tick.

        The transfer discipline of the single-device path: the sizes are
        the one big upload (sharded); the valid mask is built on each
        position from a scalar; speed, active and the in-flight table are
        cached per position behind host compares (the in-flight table
        through its delta-maintained device mirror, re-replicated only
        when that mirror changed); heartbeat ages and free counts are sent
        every tick, once, to the first position (the sharded tick reads
        the fleet there)."""
        from tpu_faas_torch.parallel.mesh import (
            shard_task_arrays,
            sharded_scheduler_tick,
        )

        mesh = self.mesh
        (ts_d,) = shard_task_arrays(mesh, ts)
        prio_d = None if prio is None else shard_task_arrays(mesh, prio)[0]
        # upload snapshots: the act loop mutates worker_free the moment
        # tick() returns
        hb, wf = (upload(x, mesh.lead) for x in (hb_age, self.worker_free))
        ws = self._cached_mesh("speed@mesh", self.worker_speed)
        wa = self._cached_mesh("active@mesh", self.worker_active)
        src = self._device_inflight()
        entry = self._dev_cache.get("inflight@mesh")
        if entry is None or entry[0] is not src:
            self._dev_cache["inflight@mesh"] = (
                src, [src.to(d) for d in mesh.devices])
        iw = self._dev_cache["inflight@mesh"][1]
        return sharded_scheduler_tick(
            mesh,
            ts_d,
            None,  # valid mask built on each position from n_valid
            ws,
            wf,
            wa,
            hb,
            self._prev_live_dev(),
            iw,
            float(np.float32(self.time_to_expire)),
            max_slots=self.max_slots,
            placement=self.placement,
            task_priority=prio_d,
            n_valid=n_valid,
            auction_price=self._d_auction_price,
        )

    def _cached_mesh(self, name: str, host: np.ndarray) -> list:
        """:meth:`_cached_dev` for the mesh: one copy per position."""
        from tpu_faas_torch.parallel.mesh import replicate

        entry = self._dev_cache.get(name)
        if entry is not None and np.array_equal(entry[0], host):
            return entry[1]
        snap = host.copy()
        (dev,) = replicate(self.mesh, snap)
        self._dev_cache[name] = (snap, dev)
        return dev
