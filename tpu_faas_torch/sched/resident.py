"""Device-resident steady-state scheduler: the tick without the re-upload.

Counterpart of ``tpu_faas/sched/resident.py``. ALL scheduler state stays on
the device between ticks — pending sizes/valid/priority, per-worker
heartbeat stamps and free counts, the in-flight table, prev-live — and each
tick uploads ONE small packed delta vector (new-arrival sizes + changed-row
scatters) and launches ONE kernel that applies the deltas and runs the full
scheduler step (liveness + purge + rank placement + redistribution).
Outputs are compacted on the device (placed pairs, arrival slots,
redispatch slots as fixed-K index lists).

Slot allocation for arrivals is computed ON DEVICE (first free slots by
index order), so consecutive ticks pipeline with no host round trip between
them; the host learns each tick's arrival slots and placements from the
readback, which it may consume several ticks later. The kernel clears the
pending-valid bit ONLY for placements it reported (first KP) and decrements
free counts for exactly those, so an over-KP burst is re-placed next tick
and a second tick issued before the first is resolved cannot double-book.

``_resident_tick_impl`` below is the plain PyTorch version of the fused
kernel (``sched/fused_tick.py`` + ``csrc/fused_tick.cu``): on a CUDA device
the tick always runs the kernel, which updates the state tensors in place
(their ``data_ptr()`` never changes); on the CPU it runs this version. Both
place by rank, by auction or by Sinkhorn. The auction carries its slot
prices and staleness flag in the state, and on the card its bidding rounds
loop inside the one launch, with no host round trip; Sinkhorn carries no
state of its own, and on the card its iterations run inside the one launch
too. A ``TenantTable`` turns the tenancy plane on: the packet grows a tenant
arrival lane and a tail of the share, inflight and cap vectors, the state
carries the tenant rows and the deficits, and on the card the kernel runs
the lane in all three placements. ``spec_mult`` turns the speculation plane
on: the packet grows an avoid arrival lane, a predicted-runtime lane on the
in-flight scatter and a 2-float threshold tail; the state carries real
``infl_start``/``infl_pred``/``avoid`` leaves; the tick flags stragglers
(the first KG, compacted) and runs the hedge fixup after placement, and on
the card the kernel runs this lane in all three placements too.

With ``mesh_devices=N`` the task axis is padded to a multiple of N and the
task leaves stay one contiguous [T] tensor on the first position's device,
the dispatcher's card: B1 runs on the whole state
unchanged, under the mesh as without it. Where the positions are distinct
cards, the others hold no resident state (B1 is a single-device kernel:
this is the price of one process). Multi-card resident work is
``parallel/multihost_resident.py``: one process per card, each with a
full replica, the lead broadcasting every packet. Either way a layout's
placements are those of one ``ResidentScheduler`` at the padded shape.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
import torch

from tpu_faas_torch.device import to_host, upload
from tpu_faas_torch.obs.profile import (
    COUNT_AUCTION_ROUNDS,
    COUNT_AUCTION_SPILLED,
    COUNT_PLACED,
    SPAN_DIFF,
    SPAN_LAUNCH,
    SPAN_PACK,
    SPAN_RESOLVE_MAP,
    SPAN_RESOLVE_WAIT,
    count,
    span_close,
    span_open,
    tracing,
)
from tpu_faas_torch.sched.scatter import (
    drop_index,
    f32_to_i32,
    scatter_add,
    scatter_set,
)
from tpu_faas_torch.sched.state import SchedulerArrays, scheduler_tick_impl
from tpu_faas_torch.spec.straggler import DEFAULT_MIN_RUNTIME_S
from tpu_faas_torch.tenancy.fairshare import check_segment_key

_I32 = torch.int32


class ResidentTickOutput(NamedTuple):
    placed_slots: torch.Tensor  # i32[KP] pending-slot index, -1 = pad
    placed_rows: torch.Tensor  # i32[KP] worker row per placed slot
    arrival_slots: torch.Tensor  # i32[KA] slot per arrival, -1 = pad/rejected
    redispatch_slots: torch.Tensor  # i32[KR] in-flight slots to re-queue
    purged: torch.Tensor  # bool[W]
    live: torch.Tensor  # bool[W]
    n_pending: torch.Tensor  # i32 pending tasks still valid after this tick
    #: i32[KG] in-flight slots flagged as stragglers (speculation plane;
    #: length 1, all -1, while it is off), -1 = pad
    straggler_slots: torch.Tensor | None = None
    #: i32 scalar (auction only): bidding rounds this tick ran; read back
    #: by resolve_next under a profiler capture alone (obs/profile.py)
    auction_rounds: torch.Tensor | None = None
    #: i32 scalar (auction only): tasks the rank spill placed; read as the
    #: rounds are
    auction_spilled: torch.Tensor | None = None
    #: i32 scalar (auction only): rows that bid, summed over the rounds
    auction_bid_rows: torch.Tensor | None = None
    #: f32 final Sinkhorn potentials (Sinkhorn only): f over the iterated
    #: rows, g over the workers + slack
    sinkhorn_f: torch.Tensor | None = None
    sinkhorn_g: torch.Tensor | None = None
    #: f32 scalar (Sinkhorn only): the effective temperature
    sinkhorn_tau: torch.Tensor | None = None
    #: bool[T] (tenancy only): the tasks placement saw as valid, the valid
    #: tasks minus those past their tenant's inflight-cap allowance
    tenant_eligible: torch.Tensor | None = None


class _ResidentState(NamedTuple):
    """Everything carried on device between ticks — the 16 leaves of the
    JAX state, in its order. Rank placement reads and writes the first
    ten; the auction also carries ``price`` and ``refresh``; the tenancy
    plane the ``tenant`` rows and the ``t_deficit`` carry; the speculation
    plane the ``infl_start``/``infl_pred``/``avoid`` leaves (length 1 and
    inert while it is off)."""

    sizes: torch.Tensor  # f32[T]
    valid: torch.Tensor  # bool[T]
    prio: torch.Tensor  # i32[T] (all-zero when priorities unused)
    tenant: torch.Tensor  # i32[T] dense tenant rows (tenancy plane)
    last_hb: torch.Tensor  # f32[W] epoch-relative heartbeat stamps
    free: torch.Tensor  # i32[W]
    inflight: torch.Tensor  # i32[I]
    prev_live: torch.Tensor  # bool[W]
    speed: torch.Tensor  # f32[W]
    active: torch.Tensor  # bool[W]
    price: torch.Tensor  # f32[W*max_slots] auction slot prices
    t_deficit: torch.Tensor  # f32[NT] per-tenant deficits
    #: f32[I] epoch-relative dispatch stamp per in-flight slot (the
    #: packet's now when its scatter applied)
    infl_start: torch.Tensor
    #: f32[I] predicted runtime per in-flight slot (<= 0 never flags)
    infl_pred: torch.Tensor
    #: i32[T] the worker row each pending task must not land on (-1 none)
    avoid: torch.Tensor
    refresh: torch.Tensor  # bool scalar (auction staleness flag)


_LEAF_DTYPES = {
    "sizes": torch.float32, "valid": torch.bool, "prio": _I32,
    "tenant": _I32, "last_hb": torch.float32, "free": _I32,
    "inflight": _I32, "prev_live": torch.bool, "speed": torch.float32,
    "active": torch.bool, "price": torch.float32,
    "t_deficit": torch.float32, "infl_start": torch.float32,
    "infl_pred": torch.float32, "avoid": _I32, "refresh": torch.bool,
}


def state_from_numpy(
    leaves: dict[str, np.ndarray], device: str | torch.device
) -> _ResidentState:
    """A resident state from numpy leaves keyed by the JAX ``_ResidentState``
    field names (e.g. ``np.asarray`` of each leaf of a JAX scheduler's
    ``_r_state``), copied onto ``device``."""
    dev = torch.device(device)
    return _ResidentState(**{
        name: torch.from_numpy(np.array(leaves[name]))
        .to(dtype=dt)
        .to(dev)
        for name, dt in _LEAF_DTYPES.items()
    })


def state_to_numpy(st: _ResidentState) -> dict[str, np.ndarray]:
    """The inverse of :func:`state_from_numpy`."""
    return {name: to_host(leaf) for name, leaf in st._asdict().items()}


# header: now (epoch-relative seconds), then the counts of arrivals, hb,
# free, inflight, speed and active deltas, one opcode word (0 = tick,
# 1 = flush, 2 = stop: the multihost followers' exit) and time_to_expire
_OP_TICK, _OP_FLUSH, _OP_STOP = 0.0, 1.0, 2.0
_HEADER = 9


def _first_k_indices(mask: torch.Tensor, K: int) -> torch.Tensor:
    """Indices of the first K set bits of ``mask``, in index order, -1
    padded — one cumsum + one scatter, O(N)."""
    N = mask.shape[0]
    pos = torch.cumsum(mask.to(_I32), 0, dtype=_I32) - 1
    idx = torch.where(mask & (pos < K), pos, K).long()
    out = torch.full((K + 1,), -1, dtype=_I32, device=mask.device)
    out[idx] = torch.arange(N, dtype=_I32, device=mask.device)
    return out[:K]


def _apply_deltas(packed, st: _ResidentState, *, T, W, I, KA, KH, KF, KI,
                  KS, KB, use_priority, use_tenancy=False, use_spec=False):
    """Scatter one delta packet into the carried state. Returns (state,
    arrival_slots i32[KA], now)."""
    now = packed[0]
    n_arr, n_hb, n_free, n_infl, n_speed, n_active = f32_to_i32(packed[1:7])
    dev = packed.device
    off = _HEADER

    def lane(K, as_int=False):
        nonlocal off
        v = packed[off : off + K]
        off += K
        return f32_to_i32(v) if as_int else v

    arr_sizes = lane(KA)
    if use_priority:
        arr_prio = lane(KA, True)
    if use_tenancy:
        arr_tenant = lane(KA, True)
    if use_spec:
        # the forbidden worker row of each arrival (-1 on ordinary ones)
        arr_avoid = lane(KA, True)
    hb_idx, hb_val = lane(KH, True), lane(KH)
    free_idx, free_val = lane(KF, True), lane(KF, True)
    infl_idx, infl_val = lane(KI, True), lane(KI, True)
    if use_spec:
        # the predicted runtime of each scattered in-flight slot, on the
        # same indices as the in-flight scatter
        infl_pred_val = lane(KI)
    sp_idx, sp_val = lane(KS, True), lane(KS)
    ac_idx, ac_val = lane(KB, True), lane(KB)

    def live_lanes(K, n):
        return torch.arange(K, device=dev) < n

    # -- per-worker / in-flight scatters (sentinel index = dropped write) --
    last_hb = scatter_set(
        st.last_hb, drop_index(hb_idx, live_lanes(KH, n_hb), W), hb_val
    )
    # free counts travel as ADDITIVE deltas: the device decrements free for
    # every placement it reports, possibly ticks before the host mirrors
    # it, and an absolute set would resurrect capacity the device consumed
    free = scatter_add(
        st.free, drop_index(free_idx, live_lanes(KF, n_free), W), free_val
    )
    infl_sidx = drop_index(infl_idx, live_lanes(KI, n_infl), I)
    inflight = scatter_set(st.inflight, infl_sidx, infl_val)
    infl_start, infl_pred = st.infl_start, st.infl_pred
    if use_spec:
        # a slot's dispatch stamp is the packet's now at apply time; a
        # cleared slot (value < 0) zeroes both
        occupied_w = infl_val >= 0
        infl_start = scatter_set(infl_start, infl_sidx,
                                 torch.where(occupied_w, now, 0.0))
        infl_pred = scatter_set(infl_pred, infl_sidx,
                                torch.where(occupied_w, infl_pred_val, 0.0))
    speed = scatter_set(
        st.speed, drop_index(sp_idx, live_lanes(KS, n_speed), W), sp_val
    )
    active = scatter_set(
        st.active, drop_index(ac_idx, live_lanes(KB, n_active), W),
        ac_val > 0.5,
    )

    # -- arrivals into the first free pending slots ------------------------
    # the device picks slots deterministically (first invalid slots in index
    # order), so the host can stay several unresolved ticks behind
    free_slots = _first_k_indices(~st.valid, KA)
    n_invalid = T - st.valid.sum(dtype=_I32)
    accept = torch.minimum(n_arr, n_invalid)  # never overwrite live pending
    ok = torch.arange(KA, dtype=_I32, device=dev) < accept
    slots = torch.where(ok, free_slots, T).long()
    sizes = scatter_set(st.sizes, slots, arr_sizes)
    valid = scatter_set(st.valid, slots, True)
    prio = st.prio
    if use_priority:
        prio = scatter_set(prio, slots, arr_prio)
    tenant = st.tenant
    if use_tenancy:
        tenant = scatter_set(tenant, slots, arr_tenant)
    avoid = st.avoid
    if use_spec:
        avoid = scatter_set(avoid, slots, arr_avoid)
    arrival_slots = torch.where(ok, free_slots, -1).to(_I32)
    new = st._replace(sizes=sizes, valid=valid, prio=prio, tenant=tenant,
                      last_hb=last_hb, free=free, inflight=inflight,
                      speed=speed, active=active, infl_start=infl_start,
                      infl_pred=infl_pred, avoid=avoid)
    return new, arrival_slots, now


def _flush_kernel_impl(packed, st, *, T, W, I, KA, KH, KF, KI, KS, KB,
                       use_priority, use_tenancy=False, NT=1,
                       use_spec=False, KG=1):
    """Delta application alone — the plain version of the kernel's flush
    mode, used when a tick's deltas exceed one packet's capacity. ``NT``
    and ``KG`` shape nothing here (the tails and the straggler compaction
    are tick-only) but ride the statics so both share one ``_statics()``
    dict."""
    st, arrival_slots, _ = _apply_deltas(
        packed, st, T=T, W=W, I=I, KA=KA, KH=KH, KF=KF, KI=KI, KS=KS,
        KB=KB, use_priority=use_priority, use_tenancy=use_tenancy,
        use_spec=use_spec,
    )
    return st, arrival_slots


def tenancy_tail(packed, NT: int):
    """The tenancy tail at the end of a packet: share f32[NT], and the
    inflight counts and caps, i32[NT] each (XLA's f32 -> i32)."""
    tail = packed.shape[0] - 3 * NT
    return (packed[tail : tail + NT],
            f32_to_i32(packed[tail + NT : tail + 2 * NT]),
            f32_to_i32(packed[tail + 2 * NT :]))


def spec_tail(packed, use_tenancy: bool, NT: int):
    """The speculation tail (the straggler multiplier and the floor), just
    before the tenancy tail, or at the end of the packet without it."""
    at = packed.shape[0] - (3 * NT if use_tenancy else 0) - 2
    return packed[at], packed[at + 1]


def _resident_tick_impl(
    packed,
    st: _ResidentState,
    *,
    T, W, I, KA, KH, KF, KI, KS, KB, KP, KR, max_slots, use_priority,
    placement="rank",
    use_tenancy=False,
    NT=1,
    use_spec=False,
    KG=1,
    sinkhorn_potentials=None,
):
    """The full resident step as plain PyTorch ops — the plain version of
    the fused CUDA kernel. Functional: returns ``(ResidentTickOutput,
    new_state)`` and leaves ``st`` untouched. ``sinkhorn_potentials``
    replays a Sinkhorn tick's rounding from given final (f, g)."""
    st, arrival_slots, now = _apply_deltas(
        packed, st, T=T, W=W, I=I, KA=KA, KH=KH, KF=KF, KI=KI, KS=KS,
        KB=KB, use_priority=use_priority, use_tenancy=use_tenancy,
        use_spec=use_spec,
    )
    spec_kw: dict = {}
    if use_spec:
        # elapsed per in-flight slot from the carried dispatch stamps; the
        # thresholds ride the packet as values
        mult, min_s = spec_tail(packed, use_tenancy, NT)
        spec_kw = dict(spec_elapsed=now - st.infl_start,
                       spec_predicted=st.infl_pred, spec_mult=mult,
                       spec_min_s=min_s, task_avoid_worker=st.avoid)
    tenant_kw: dict = {}
    if use_tenancy:
        # share, inflight and cap ride the END of every tick packet as
        # values; the deficit carry stays a device-resident leaf
        share, ahead, cap = tenancy_tail(packed, NT)
        tenant_kw = dict(task_tenant=st.tenant, tenant_share=share,
                         tenant_deficit=st.t_deficit, tenant_ahead=ahead,
                         tenant_cap=cap)
    auction = placement == "auction"
    out = scheduler_tick_impl(
        st.sizes,
        st.valid,
        st.speed,
        st.free,
        st.active,
        now - st.last_hb,
        st.prev_live,
        st.inflight,
        packed[8],  # time_to_expire rides the packet header
        max_slots=max_slots,
        task_priority=st.prio if use_priority else None,
        placement=placement,
        auction_price=st.price if auction else None,
        auction_refresh=st.refresh if auction else None,
        sinkhorn_potentials=sinkhorn_potentials,
        **tenant_kw,
        **spec_kw,
    )

    # -- compact placements to KP (slot, row) pairs ------------------------
    placed_slots = _first_k_indices(out.assignment >= 0, KP)
    pok = placed_slots >= 0
    placed_rows = torch.where(
        pok, out.assignment[placed_slots.clamp(min=0).long()], -1
    ).to(_I32)
    # clear ONLY reported placements; an over-KP surplus stays valid and is
    # re-placed (and reported) next tick
    reported = scatter_set(
        torch.zeros(T, dtype=torch.bool, device=packed.device),
        torch.where(pok, placed_slots, T).long(), True,
    )
    valid_next = st.valid & ~reported
    # consume the reported placements' capacity ON DEVICE, so a second tick
    # issued before the host resolves this one cannot re-book it
    free_next = scatter_add(
        st.free, torch.where(pok, placed_rows, W).long(), -1
    )
    redispatch_slots = _first_k_indices(out.redispatch, KR)
    if use_spec:
        straggler_slots = _first_k_indices(out.straggler, KG)
    else:  # the inert length-KG pad
        straggler_slots = torch.full((KG,), -1, dtype=_I32,
                                     device=packed.device)

    new_state = st._replace(valid=valid_next, free=free_next,
                            prev_live=out.live)
    if use_tenancy:
        new_state = new_state._replace(t_deficit=out.tenant_deficit)
    rounds = spilled = bid_rows = None
    if auction:
        new_state = new_state._replace(price=out.auction_price,
                                       refresh=out.auction_refresh)
        rounds = torch.tensor(out.auction_rounds, dtype=_I32,  # faas: allow(trace.host-sync) the plain version: on the card B1 returns its round count itself
                              device=packed.device)
        spilled = out.auction_spilled.to(_I32)
        bid_rows = torch.tensor(out.auction_bid_rows, dtype=_I32,  # faas: allow(trace.host-sync) the plain version: on the card B1 returns its bidder count itself
                                device=packed.device)
    res = ResidentTickOutput(
        placed_slots, placed_rows, arrival_slots, redispatch_slots,
        out.purged, out.live, valid_next.sum(dtype=_I32), straggler_slots,
        rounds, spilled, bid_rows, out.sinkhorn_f, out.sinkhorn_g,
        out.sinkhorn_tau, out.tenant_eligible,
    )
    return res, new_state


@dataclass
class _Arrival:
    task_id: str
    size: float
    priority: int = 0
    tenant: int = 0
    avoid: int = -1


@dataclass
class ResolvedTick:
    """Host-side view of one resident tick, in tick order."""

    placed: list  # [(task_id, worker_row)]
    redispatch_slots: list  # in-flight table slots whose worker died
    purged_rows: np.ndarray  # worker rows purged this tick
    rejected: int  # arrivals bounced (pending buffer full), re-queued
    n_pending: int  # device-side pending count after the tick
    straggler_slots: list = field(default_factory=list)


class _FlushOnly(NamedTuple):
    """Stand-in output for an overflow flush packet (arrival mapping only)."""

    arrival_slots: torch.Tensor
    n: int


class ResidentScheduler(SchedulerArrays):
    """SchedulerArrays whose pending set lives on the device between ticks.

    Usage: ``pending_add()`` new tasks as they arrive, ``tick_resident()``
    once per scheduling period, ``resolve_next()`` after reading back — in
    tick order — to learn placements. All SchedulerArrays membership calls
    work unchanged; their effects reach the device as automatic diffs
    against the last-uploaded copy.

    With ``tenancy`` (a TenantTable), its ``max_tenants`` rows are the
    tick's NT on every device and placement: the only limit is the int32
    segment key, ``(max_tenants + 1) * max_pending < 2**31``
    (``check_segment_key``, raised at construction).

    With ``mesh_devices=N`` (JAX refuses its fused backend there; the port
    has no other) B1 serves every tick under the mesh too, on the whole
    state: see the module docstring.
    """

    # delta-packet capacities
    KA: int = 512  # arrivals / tick packet
    KH: int = 512  # heartbeat scatters
    KF: int = 1024  # free-count scatters
    KI: int = 1024  # in-flight scatters
    KS: int = 512  # worker-speed scatters
    KB: int = 256  # worker-active scatters
    KP: int = 2048  # reported placements / tick
    KR: int = 512  # reported redispatches / tick
    KG: int = 64  # reported straggler flags / tick (speculation plane)
    use_priority: bool = False
    #: uptime (seconds) after which the heartbeat epoch is re-based, so f32
    #: epoch-relative stamps never approach heartbeat granularity
    EPOCH_REBASE_S: float = float(1 << 20)
    #: whether pending_bulk_load's full upload is available
    supports_bulk_load: bool = True

    def __init__(
        self,
        *args,
        use_priority: bool = False,
        KA: int | None = None,
        KH: int | None = None,
        KF: int | None = None,
        KI: int | None = None,
        KS: int | None = None,
        KB: int | None = None,
        KP: int | None = None,
        KR: int | None = None,
        KG: int | None = None,
        tenancy=None,
        spec_mult: float | None = None,
        spec_min_s: float = DEFAULT_MIN_RUNTIME_S,
        **kw,
    ):
        super().__init__(*args, **kw)
        # speculation plane: a straggler multiplier turns it on. The leaf
        # shapes and the packet layout follow at construction; the
        # threshold values ride every packet (hot-tunable)
        self.use_spec = spec_mult is not None
        if self.use_spec:
            self.spec_mult = float(spec_mult)
            self.spec_min_s = float(spec_min_s)
        # tenancy plane: a TenantTable turns it on. NT (the vectors' padded
        # length) shapes the state and the packet, so the table must exist
        # at construction; its contents are values (hot-reloadable)
        self.tenancy = tenancy
        self.use_tenancy = tenancy is not None
        self.NT = tenancy.max_tenants if tenancy is not None else 1
        if self.use_tenancy:
            check_segment_key(self.NT, self.max_pending)
        #: kernel launches issued by the LAST tick_resident() call (steady
        #: state: exactly 1; overflow bursts add one flush launch per
        #: surplus packet) and ever
        self.device_dispatches_last_tick: int = 0
        self.device_dispatches_total: int = 0
        for name, v in (("KA", KA), ("KH", KH), ("KF", KF), ("KI", KI),
                        ("KS", KS), ("KB", KB), ("KP", KP), ("KR", KR),
                        ("KG", KG)):
            if v is not None:
                setattr(self, name, int(v))
        # packet capacities can't exceed the arrays they scatter into
        self.KA = min(self.KA, self.max_pending)
        self.KP = min(self.KP, self.max_pending)
        self.KH = min(self.KH, self.max_workers)
        self.KF = min(self.KF, self.max_workers)
        self.KS = min(self.KS, self.max_workers)
        self.KB = min(self.KB, self.max_workers)
        self.KI = min(self.KI, self.max_inflight)
        self.KR = min(self.KR, self.max_inflight)
        # spec off collapses the straggler output to its length-1 pad
        self.KG = min(self.KG, self.max_inflight) if self.use_spec else 1
        self.use_priority = bool(use_priority)
        self._epoch = self.clock()
        self._arrivals: deque[_Arrival] = deque()
        # arrivals bounced by a full pending buffer, in arrival order;
        # re-fronted onto _arrivals at the next tick (FCFS across packets)
        self._rejected: deque[_Arrival] = deque()
        self.slot_task: dict[int, str] = {}
        self._slot_meta: dict[int, _Arrival] = {}
        self._unresolved: deque[tuple[list[_Arrival], object]] = deque()
        self._r_state: _ResidentState | None = None
        self._hb_sent: np.ndarray | None = None
        self._free_sent: np.ndarray | None = None
        self._speed_sent: np.ndarray | None = None
        self._active_sent: np.ndarray | None = None

    # -- pending interface -------------------------------------------------
    def pending_add(
        self, task_id: str, size: float, priority: int = 0, tenant: int = 0,
        avoid: int = -1,
    ) -> None:
        self._arrivals.append(
            _Arrival(task_id, float(size), int(priority), int(tenant),
                     int(avoid))
        )

    def pending_bulk_load(
        self,
        ids: list[str],
        sizes: np.ndarray,
        priorities: np.ndarray | None = None,
        tenants: np.ndarray | None = None,
    ) -> None:
        """Seed the device pending set with one full upload — the cold-start
        path. Only valid on an empty pending state. The upload is copied
        INTO the existing state tensors, which keep their addresses."""
        if self.slot_task or self._arrivals or self._unresolved:
            raise RuntimeError("bulk load requires an empty pending state")
        n = len(ids)
        if n > self.max_pending:
            raise ValueError(f"{n} tasks > max_pending={self.max_pending}")
        self._ensure_state()
        T = self.max_pending
        s = np.zeros(T, dtype=np.float32)
        s[:n] = np.asarray(sizes, dtype=np.float32)
        v = np.zeros(T, dtype=bool)
        v[:n] = True
        p = np.zeros(T, dtype=np.int32)
        if priorities is not None:
            p[:n] = np.asarray(priorities, dtype=np.int32)
        tn = np.zeros(T, dtype=np.int32)
        if tenants is not None:
            tn[:n] = np.asarray(tenants, dtype=np.int32)
        st = self._r_state
        leaves = [(st.sizes, s), (st.valid, v), (st.prio, p), (st.tenant, tn)]
        if self.use_spec:
            # bulk loads are adoption backlogs, never hedges: no slot keeps
            # a stale veto
            leaves.append((st.avoid, np.full(T, -1, dtype=np.int32)))
        for leaf, host in leaves:
            leaf.copy_(upload(host, self.device), non_blocking=True)
        for i, tid in enumerate(ids):
            self.slot_task[i] = tid
            self._slot_meta[i] = _Arrival(
                tid, float(s[i]), int(p[i]), int(tn[i])
            )

    @property
    def n_pending_host(self) -> int:
        """Tasks the host still considers pending (device slots + queued
        arrivals, including those in unresolved ticks)."""
        return (
            len(self.slot_task)
            + len(self._arrivals)
            + len(self._rejected)
            + sum(len(a) for a, _ in self._unresolved)
        )

    # -- state bootstrap ---------------------------------------------------
    def _hb_rel(self) -> np.ndarray:
        # -inf stamps (never heard from) stay -inf; ages come out +inf
        return (self.last_heartbeat - self._epoch).astype(np.float32)

    def _ensure_state(self) -> None:
        if self._r_state is not None:
            return
        T, W = self.max_pending, self.max_workers
        hb = self._hb_rel()
        pl = self.prev_live
        prev_live = (
            pl.clone() if isinstance(pl, torch.Tensor)
            else upload(np.asarray(pl), self.device)
        )
        dev = self.device
        # the speculation leaves: real [I]/[I]/[T] with the plane on, inert
        # length-1 leaves otherwise
        SI = self.max_inflight if self.use_spec else 1
        ST = T if self.use_spec else 1
        # live fleet mirrors are uploaded as snapshots (see upload): they
        # are mutated in place by membership/result events between ticks
        self._r_state = _ResidentState(
            upload(np.zeros(T, dtype=np.float32), dev),
            upload(np.zeros(T, dtype=bool), dev),
            upload(np.zeros(T, dtype=np.int32), dev),
            upload(np.zeros(T, dtype=np.int32), dev),  # tenant rows
            upload(hb, dev),
            upload(self.worker_free, dev),
            upload(self.inflight_worker, dev),
            prev_live,
            upload(self.worker_speed, dev),
            upload(self.worker_active, dev),
            upload(np.zeros(W * self.max_slots, dtype=np.float32), dev),
            upload(np.zeros(self.NT, dtype=np.float32), dev),  # deficits
            upload(np.zeros(SI, dtype=np.float32), dev),  # infl_start
            upload(np.zeros(SI, dtype=np.float32), dev),  # infl_pred
            upload(np.full(ST, -1, dtype=np.int32), dev),  # avoid
            # a bool scalar, as the tick returns it (upload makes 1-d)
            upload(np.asarray(True), dev).reshape(()),  # refresh
        )
        self._hb_sent = hb.copy()
        self._free_sent = self.worker_free.copy()
        self._speed_sent = self.worker_speed.copy()
        self._active_sent = self.worker_active.copy()
        # route inflight mutations into _inflight_delta (see _note_inflight)
        self._d_inflight = self._r_state.inflight
        self._inflight_delta.clear()

    # -- delta packet construction -----------------------------------------
    def _diff_deltas(self):
        """Index/value scatter lists for everything that changed host-side
        since the last upload."""
        hb = self._hb_rel()
        hb_idx = np.flatnonzero(hb != self._hb_sent)
        hb_val = hb[hb_idx]
        self._hb_sent[hb_idx] = hb_val
        # free counts: ship the DIFFERENCE since the last packet (the
        # device adds it); _free_sent is the host view the device was told
        fr_idx = np.flatnonzero(self.worker_free != self._free_sent)
        fr_val = (self.worker_free[fr_idx] - self._free_sent[fr_idx]).astype(
            np.int64
        )
        self._free_sent[fr_idx] = self.worker_free[fr_idx]
        if self._inflight_delta:
            if_idx = np.fromiter(
                self._inflight_delta.keys(), np.int64,
                len(self._inflight_delta),
            )
            if_val = np.fromiter(
                self._inflight_delta.values(), np.int64, len(if_idx)
            )
            self._inflight_delta.clear()
        else:
            if_idx = if_val = np.empty(0, dtype=np.int64)
        sp_idx = np.flatnonzero(self.worker_speed != self._speed_sent)
        sp_val = self.worker_speed[sp_idx]
        self._speed_sent[sp_idx] = sp_val
        ac_idx = np.flatnonzero(self.worker_active != self._active_sent)
        ac_val = self.worker_active[ac_idx].astype(np.float32)
        self._active_sent[ac_idx] = self.worker_active[ac_idx]
        return (hb_idx, hb_val, fr_idx, fr_val, if_idx, if_val,
                sp_idx, sp_val, ac_idx, ac_val)

    def packet_len(self) -> int:
        lanes = (1 + int(self.use_priority) + int(self.use_tenancy)
                 + int(self.use_spec))
        return (
            _HEADER
            + self.KA * lanes
            + 2 * (self.KH + self.KF + self.KI + self.KS + self.KB)
            # speculation: the pred lane on the in-flight scatter's indices
            # and the 2-float threshold tail (before the tenancy tail)
            + (self.KI + 2 if self.use_spec else 0)
            # the tenancy tail: share, inflight and cap, on every packet
            + (3 * self.NT if self.use_tenancy else 0)
        )

    def _pack(self, now_rel, arrivals, hb, fr, infl, sp, ac) -> np.ndarray:
        on = tracing()
        if on:
            span = span_open(SPAN_PACK)
        p = np.zeros(self.packet_len(), dtype=np.float32)
        p[0] = now_rel
        p[1] = len(arrivals)
        p[2] = len(hb[0])
        p[3] = len(fr[0])
        p[4] = len(infl[0])
        p[5] = len(sp[0])
        p[6] = len(ac[0])
        p[7] = _OP_TICK  # _run_flush overwrites for flush packets
        p[8] = self.time_to_expire
        off = _HEADER

        def put(vals, K):
            nonlocal off
            p[off : off + len(vals)] = vals
            off += K

        put([a.size for a in arrivals], self.KA)
        if self.use_priority:
            put([a.priority for a in arrivals], self.KA)
        if self.use_tenancy:
            put([a.tenant for a in arrivals], self.KA)
        if self.use_spec:
            put([a.avoid for a in arrivals], self.KA)
        for (idx, val), K in ((hb, self.KH), (fr, self.KF), (infl, self.KI)):
            put(idx, K)
            put(val, K)
        if self.use_spec:
            # the pred lane: the host mirror's prediction for each slot of
            # the in-flight scatter, read at pack time
            put(self.inflight_pred[np.asarray(infl[0], dtype=np.int64)],
                self.KI)
        for (idx, val), K in ((sp, self.KS), (ac, self.KB)):
            put(idx, K)
            put(val, K)
        if self.use_spec:
            put([self.spec_mult, self.spec_min_s], 2)
        if self.use_tenancy:
            ten = self.tenancy
            for vec in (ten.share, ten.inflight, ten.cap):
                put(vec[: self.NT], self.NT)
        if on:
            span_close(span)
        return p

    def _statics(self) -> dict:
        return dict(
            T=self.max_pending, W=self.max_workers, I=self.max_inflight,
            KA=self.KA, KH=self.KH, KF=self.KF, KI=self.KI, KS=self.KS,
            KB=self.KB, use_priority=self.use_priority,
            use_tenancy=self.use_tenancy, NT=self.NT,
            use_spec=self.use_spec, KG=self.KG,
        )

    @property
    def tick_backend(self) -> str | None:
        """What serves the resident tick, for the dispatcher's status block
        (JAX's ``tick_backend``): ``"fused_cuda"`` on the card, where every
        tick is launches of B1 (``csrc/fused_tick.cu``), None on the CPU,
        where its plain version runs."""
        return "fused_cuda" if self.device.type == "cuda" else None

    def tenant_deficits(self) -> np.ndarray | None:
        """Host view of the resident deficit leaf (one sync, stats surface
        only); None with the tenancy plane off or before the first tick."""
        st = self._r_state
        if not self.use_tenancy or st is None:
            return None
        return to_host(st.t_deficit)

    # -- kernel launch -----------------------------------------------------
    def _count_dispatch(self) -> None:
        self.device_dispatches_last_tick += 1
        self.device_dispatches_total += 1

    def _launch(self, packet: np.ndarray, flush: bool):
        # imported here: fused_tick imports this module's plain version
        from tpu_faas_torch.sched.fused_tick import fused_resident_tick

        on = tracing()
        if on:
            span = span_open(SPAN_LAUNCH)
        out = fused_resident_tick(
            upload(packet, self.device),
            self._r_state,
            **self._statics(),
            KP=self.KP,
            KR=self.KR,
            max_slots=self.max_slots,
            flush=flush,
            placement=self.placement,
        )
        if on:
            span_close(span)
        return out

    def _run_flush(self, packet: np.ndarray):
        packet[7] = _OP_FLUSH
        return self._launch(packet, flush=True)

    def _run_tick(self, packet: np.ndarray):
        return self._launch(packet, flush=False)

    # -- the tick ----------------------------------------------------------
    def tick_resident(self, now: float | None = None) -> ResidentTickOutput:
        self._ensure_state()
        self.device_dispatches_last_tick = 0
        if self._rejected:
            # bounced arrivals retry ahead of newer traffic, in order
            self._arrivals.extendleft(reversed(self._rejected))
            self._rejected.clear()
        now_abs = now if now is not None else self.clock()
        if now_abs - self._epoch > self.EPOCH_REBASE_S:
            # re-base the epoch long before f32 stamp spacing approaches
            # heartbeat granularity, and force a stamp re-upload: NaN
            # compares unequal to everything, so every finite row diffs and
            # the overflow flush below drains the surplus this same tick.
            # -inf rows (never heard from) are identical under any epoch.
            self._epoch = now_abs
            if self._hb_sent is not None:
                self._hb_sent[np.isfinite(self._hb_sent)] = np.nan
        now_rel = now_abs - self._epoch
        on = tracing()
        if on:
            span = span_open(SPAN_DIFF)
        (hb_idx, hb_val, fr_idx, fr_val, if_idx, if_val,
         sp_idx, sp_val, ac_idx, ac_val) = self._diff_deltas()
        if on:
            span_close(span)

        # overflow: drain surplus deltas in flush launches so the tick
        # always sees one in-capacity packet
        while (
            len(self._arrivals) > self.KA
            or len(hb_idx) > self.KH
            or len(fr_idx) > self.KF
            or len(if_idx) > self.KI
            or len(sp_idx) > self.KS
            or len(ac_idx) > self.KB
        ):
            take = [
                self._arrivals.popleft()
                for _ in range(min(len(self._arrivals), self.KA))
            ]
            packet = self._pack(
                now_rel,
                take,
                (hb_idx[: self.KH], hb_val[: self.KH]),
                (fr_idx[: self.KF], fr_val[: self.KF]),
                (if_idx[: self.KI], if_val[: self.KI]),
                (sp_idx[: self.KS], sp_val[: self.KS]),
                (ac_idx[: self.KB], ac_val[: self.KB]),
            )
            hb_idx, hb_val = hb_idx[self.KH :], hb_val[self.KH :]
            fr_idx, fr_val = fr_idx[self.KF :], fr_val[self.KF :]
            if_idx, if_val = if_idx[self.KI :], if_val[self.KI :]
            sp_idx, sp_val = sp_idx[self.KS :], sp_val[self.KS :]
            ac_idx, ac_val = ac_idx[self.KB :], ac_val[self.KB :]
            self._count_dispatch()
            st, arrival_slots = self._run_flush(packet)
            self._r_state = st
            self._d_inflight = st.inflight
            if take:
                # flush packets resolve like mini-ticks with no placements
                self._unresolved.append(
                    (take, _FlushOnly(arrival_slots, len(take)))
                )

        take = [
            self._arrivals.popleft()
            for _ in range(min(len(self._arrivals), self.KA))
        ]
        packet = self._pack(
            now_rel, take, (hb_idx, hb_val), (fr_idx, fr_val),
            (if_idx, if_val), (sp_idx, sp_val), (ac_idx, ac_val),
        )
        self._count_dispatch()
        out, st = self._run_tick(packet)
        self._r_state = st
        self._d_inflight = st.inflight
        self.prev_live = st.prev_live
        self._unresolved.append((take, out))
        return out

    # -- readback ----------------------------------------------------------
    def resolve_next(self) -> ResolvedTick | None:
        """Consume the oldest unresolved tick: map its arrivals to slots,
        its reported placements to task ids. MUST be called in tick order
        (enforced by the internal queue). Returns None when nothing is
        outstanding. Reads that tick's outputs back (a device sync: the
        first read waits for the tick's launches).

        Capacity consistency: the device already decremented its free
        count for every placement reported here, so this resolve mirrors
        the decrement into BOTH the live host array and the sent-copy (no
        diff is emitted for it). Free counts cross as additive deltas, so a
        result arriving between the device's decrement and this mirror
        uploads only its own +1 and cannot resurrect the consumed slot."""
        if not self._unresolved:
            return None
        on = tracing()
        if on:
            span = span_open(SPAN_RESOLVE_WAIT)
        arrivals, out = self._unresolved.popleft()
        # a flush resolves with arrivals always; a tick may have none
        first = to_host(out.arrival_slots if arrivals  # faas: allow(trace.host-sync) resolve_next, the resident tick's readback: arrival slots, or placed slots on a tick with no arrival
                        else out.placed_slots)
        if on:
            span_close(span)
            span = span_open(SPAN_RESOLVE_MAP)
        res = self._map_resolved(arrivals, out, first)
        if on:
            if not isinstance(out, _FlushOnly):
                count(COUNT_PLACED, len(res.placed))
                if out.auction_rounds is not None:
                    # one small readback, B1 long done, under capture alone
                    rounds, spilled = to_host(torch.stack(  # faas: allow(trace.host-sync) resolve_next under a profiler capture: B1's auction round and spill counts
                        [out.auction_rounds, out.auction_spilled])).tolist()
                    count(COUNT_AUCTION_ROUNDS, rounds)
                    count(COUNT_AUCTION_SPILLED, spilled)
            span_close(span)
        return res

    def _map_resolved(self, arrivals: list[_Arrival], out,
                      first: np.ndarray) -> ResolvedTick:
        """resolve_next's mapping of one tick read back; ``first`` is its
        first readback, the arrival slots, or the placed slots where the
        tick took no arrival."""
        rejected = 0
        if arrivals:
            rejects: list[_Arrival] = []
            for a, slot in zip(arrivals, first[: len(arrivals)]):
                slot = int(slot)
                if slot < 0:
                    rejects.append(a)  # pending buffer was full: retry
                else:
                    self.slot_task[slot] = a.task_id
                    self._slot_meta[slot] = a
            self._rejected.extend(rejects)
            rejected = len(rejects)
        if isinstance(out, _FlushOnly):
            return ResolvedTick([], [], np.empty(0, np.int64), rejected,
                                len(self.slot_task))
        placed: list[tuple[str, int]] = []
        slots = to_host(out.placed_slots) if arrivals else first  # faas: allow(trace.host-sync) resolve_next: placed slots
        for slot, row in zip(slots,
                             to_host(out.placed_rows)):  # faas: allow(trace.host-sync) resolve_next: placed rows
            if slot < 0:
                break  # compaction puts pads last
            slot = int(slot)
            row = int(row)
            tid = self.slot_task.pop(slot, None)
            self._slot_meta.pop(slot, None)
            if tid is not None:
                # mirror the kernel's capacity decrement into BOTH the live
                # array and the sent-copy: the device already consumed it
                self.worker_free[row] -= 1
                self._free_sent[row] -= 1
                placed.append((tid, row))
            else:
                # no host mapping for the reported slot (defensive): nothing
                # will dispatch, so the next diff carries +1 back up
                self._free_sent[row] -= 1
        redisp = [int(s) for s in to_host(out.redispatch_slots) if s >= 0]  # faas: allow(trace.host-sync) resolve_next: redispatch slots
        purged_rows = np.flatnonzero(to_host(out.purged))  # faas: allow(trace.host-sync) resolve_next: purged rows
        stragglers: list[int] = []
        if self.use_spec:
            stragglers = [int(s) for s in to_host(out.straggler_slots)  # faas: allow(trace.host-sync) resolve_next: straggler slots
                          if s >= 0]
        return ResolvedTick(
            placed, redisp, purged_rows, rejected, int(out.n_pending),  # faas: allow(trace.host-sync) resolve_next: the pending count
            stragglers,
        )
