"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (an H100 is the target).

    python3 chip_smoke.py      # every phase, at the headline shape

Phases, all run every time (each fails the run; nothing is caught and passed
over):

0. ``build``  — print the card's name and power limit, the torch and CUDA
   versions; build both kernels from ``tpu_faas_torch/csrc`` with nvcc for
   sm_90a, one nvcc per source, started together: the fused tick (B1) and
   the top-2 bid (B2).
1. ``kernel`` — the fused tick kernel against its plain PyTorch version on
   the card, at 51,200 pending x 4,096 workers x 65,536 in-flight slots,
   priority admission on and off, several seeds: every output and every
   state leaf must be exactly equal.
2. ``resident`` — the resident scheduler end to end at that shape: 4,096
   workers, 51,200 bulk-loaded tasks, then per tick 512 results, 128
   heartbeats and 512 arrivals with the clock advanced 5 ms, resolved in tick
   order two ticks deep; partway through 64 workers go silent past
   time_to_expire. Checks one kernel launch per steady tick, no host sync
   inside ``tick_resident`` (``torch.cuda.set_sync_debug_mode("error")``),
   state tensors that never move, no task over-booked, placed twice or lost,
   every in-flight slot of a purged worker redispatched, and every launch's
   outputs and state equal to the plain version's from the same state.
3. ``sim``    — ``SimFleet`` on the card: 4,096 workers x 4 processes, 5%
   churn per tick, 20,000 tasks; every task completes, none lost.
4. ``bid``    — kernel B2 against its plain version on the card, exactly
   equal on v1, best and v2: at bench config 7's headline bid (51,200 x
   32,768), at BASELINE config 3's shape (10,240 x 4,096), ragged, with no
   valid slot and one, with a max duplicated across lanes at zero jitter,
   and with a hash index past 2^32 (row_offset, n_slots_total).
5. ``auction`` — ``SchedulerArrays(placement="auction")`` on the card, the
   batch auction tick with the price carry: config 3's uniform and
   lognormal legs (10,000 tasks, 1,000 workers x 4) over 4 ticks each, and
   3 ticks at the headline shape (51,200 pending, 4,096 workers x 8). Every
   tick's assignment is legal and complete, takes one B2 launch per
   bidding round, and equals a twin tick whose bids are the plain version,
   on assignment, rounds, prices, refresh and spilled count.
6. ``time``   — CUDA-event medians of B1 (on the resident run's own states
   and packets, and on a synthetic state) and of B2 (at both bid shapes),
   and of their plain versions, each beside its bound; host-clock medians
   of the integrated ``tick_resident``, of the batch tick and of the
   auction tick cold and warm, all printed beside the card's name and power
   limit. Each timed launch is queued behind a spin kernel, so its events
   measure device time and not the host's launch gap.

The last line of stdout is ``{"ok": true, "device": {...}}``; the line before
it lists each kernel's launches on its main path (the resident run for B1,
the auction ticks for B2), errors and times. Without a CUDA device the
script exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
#: the headline shape (bench.py) and the resident scheduler's packet sizes
SHAPE = dict(T=51_200, W=4_096, I=65_536, KA=512, KH=512, KF=1024, KI=1024,
             KS=512, KB=256, KP=2048, KR=512)
MAX_SLOTS = 8
N_TICKS = 200  # checked resident ticks
N_TIMED = 60  # timed ticks and launches per timing
#: spin queued ahead of each timed launch (about 10 ms at 1.98 GHz), so the
#: host has enqueued the launch before the card reaches its start event
SPIN_CYCLES = 20_000_000


def log(*a) -> None:
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# -- phase 1: kernel against its plain version --------------------------------
def random_case(rng: np.random.Generator, use_priority: bool, now: float):
    """A resident state and one full delta packet with ties, zero (and
    negative-zero) sizes, dead and silent workers, never-heard rows,
    negative and over-cap free counts, an over-KP backlog and negative free
    deltas."""
    T, W, I = SHAPE["T"], SHAPE["W"], SHAPE["I"]
    f32 = np.float32

    def tied_sizes(n):
        s = rng.uniform(0.1, 10.0, n).astype(f32)
        tie = rng.random(n) < 0.3
        s[tie] = np.round(s[tie] * 2) / 2
        s[rng.random(n) < 0.05] = 0.0
        s[rng.random(n) < 0.02] = -0.0
        return s

    speed = (np.round(rng.uniform(0.5, 4.0, W) * 4) / 4).astype(f32)
    speed[rng.random(W) < 0.02] = 0.0
    last_hb = (now - rng.uniform(0.0, 12.0, W)).astype(f32)
    last_hb[rng.random(W) < 0.02] = -np.inf
    leaves = dict(
        sizes=tied_sizes(T),
        valid=rng.random(T) < 0.6,
        prio=rng.integers(-3, 4, T).astype(np.int32),
        tenant=np.zeros(T, np.int32),
        last_hb=last_hb,
        free=rng.integers(-1, 10, W).astype(np.int32),
        inflight=np.where(rng.random(I) < 0.5, -1,
                          rng.integers(0, W, I)).astype(np.int32),
        prev_live=rng.random(W) < 0.9,
        speed=speed,
        active=rng.random(W) < 0.95,
        price=np.zeros(W * MAX_SLOTS, f32),
        t_deficit=np.zeros(1, f32),
        infl_start=np.zeros(1, f32),
        infl_pred=np.zeros(1, f32),
        avoid=np.full(1, -1, np.int32),
        refresh=np.asarray(True),
    )
    S = SHAPE
    lanes = 2 if use_priority else 1
    P = 9 + S["KA"] * lanes + 2 * (S["KH"] + S["KF"] + S["KI"] + S["KS"]
                                   + S["KB"])
    p = np.zeros(P, f32)
    counts = [int(rng.integers(K // 2, K + 1))
              for K in (S["KA"], S["KH"], S["KF"], S["KI"], S["KS"], S["KB"])]
    p[0] = now
    p[1:7] = counts
    p[8] = 10.0  # time_to_expire
    off = 9
    n_arr, n_hb, n_fr, n_if, n_sp, n_ac = counts
    p[off : off + n_arr] = tied_sizes(n_arr)
    off += S["KA"]
    if use_priority:
        p[off : off + n_arr] = rng.integers(-3, 4, n_arr)
        off += S["KA"]
    for n, K, N, vals in (
        (n_hb, S["KH"], W, lambda n: now - rng.uniform(0.0, 12.0, n)),
        (n_fr, S["KF"], W, lambda n: rng.integers(-2, 3, n)),
        (n_if, S["KI"], I, lambda n: rng.integers(-1, W, n)),
        (n_sp, S["KS"], W, lambda n: np.round(rng.uniform(0.5, 4, n) * 4) / 4),
        (n_ac, S["KB"], W, lambda n: (rng.random(n) < 0.9).astype(f32)),
    ):
        p[off : off + n] = rng.choice(N, n, replace=False)
        off += K
        p[off : off + n] = vals(n)
        off += K
    return leaves, p


def clone_state(st):
    return type(st)(*(t.clone() for t in st))


def compare(a, b, what: str) -> tuple[int, float]:
    """(mismatched fields, max abs error) between two tuples of tensors."""
    bad, err = 0, 0.0
    for name, x, y in zip(a._fields, a, b):
        if x is None and y is None:
            continue
        if x.shape != y.shape or x.dtype != y.dtype or not torch.equal(x, y):
            bad += 1
            if x.shape == y.shape:
                d = (x.double() - y.double()).abs()
                d = d[torch.isfinite(d)]
                err = max(err, float(d.max()) if d.numel() else float("inf"))
            else:
                err = float("inf")
            log(f"  MISMATCH {what}.{name}: {x.dtype}{list(x.shape)} vs "
                f"{y.dtype}{list(y.shape)}")
    return bad, err


def phase_kernel(dev) -> dict:
    from tpu_faas_torch.sched.fused_tick import KERNEL
    from tpu_faas_torch.sched.resident import (
        _flush_kernel_impl, _resident_tick_impl, state_from_numpy,
    )

    S = SHAPE
    mismatches, max_err, cases = 0, 0.0, 0
    for use_priority in (False, True):
        for seed in (0, 1, 2):
            rng = np.random.default_rng(seed)
            leaves, pkt = random_case(rng, use_priority, now=100.0)
            st_k = state_from_numpy(leaves, dev)
            st_p = clone_state(st_k)
            packet = torch.from_numpy(pkt).to(dev)
            kw = dict(S, max_slots=MAX_SLOTS, use_priority=use_priority)
            res_p, new_p = _resident_tick_impl(packet, st_p, **kw)
            ptrs = [t.data_ptr() for t in st_k]
            res_k, new_k = KERNEL(packet, st_k, flush=False, **kw)
            torch.cuda.synchronize()
            assert [t.data_ptr() for t in new_k] == ptrs, "state moved"
            b1, e1 = compare(res_k, res_p, "out")
            b2, e2 = compare(new_k, new_p, "state")
            n_placed = int((res_k.placed_slots >= 0).sum())
            log(f"  prio={use_priority} seed={seed}: placed {n_placed}/"
                f"{S['KP']} (KP), n_pending {int(res_k.n_pending)}, "
                f"redispatch {int((res_k.redispatch_slots >= 0).sum())}, "
                f"purged {int(res_k.purged.sum())}, mismatched fields "
                f"{b1 + b2}")
            mismatches += b1 + b2
            max_err = max(max_err, e1, e2)
            cases += 1
        # the flush mode (delta application alone) on a fresh case
        leaves, pkt = random_case(np.random.default_rng(9), use_priority,
                                  now=100.0)
        st_k = state_from_numpy(leaves, dev)
        packet = torch.from_numpy(pkt).to(dev)
        kw = {k: v for k, v in S.items() if k not in ("KP", "KR")}
        new_p, arr_p = _flush_kernel_impl(packet, clone_state(st_k),
                                          use_priority=use_priority, **kw)
        new_k, arr_k = KERNEL(packet, st_k, flush=True, KP=S["KP"],
                              KR=S["KR"], max_slots=MAX_SLOTS,
                              use_priority=use_priority, **kw)
        torch.cuda.synchronize()
        b, e = compare(new_k, new_p, "flush-state")
        if not torch.equal(arr_k, arr_p):
            b += 1
            log("  MISMATCH flush arrival_slots")
        log(f"  prio={use_priority} flush: mismatched fields {b}")
        mismatches += b
        max_err = max(max_err, e)
    if mismatches:
        raise SystemExit(f"kernel disagrees with its plain version: "
                         f"{mismatches} mismatched fields")
    log(f"phase kernel: {cases} ticks + 2 flushes exactly equal")
    return {"mismatches": mismatches, "max_abs_err": max_err}


# -- phase 2: the resident path end to end ------------------------------------
def make_checked_scheduler(dev, clock, use_priority: bool):
    """A ResidentScheduler that records, for each kernel launch, the packet
    and a copy of the state before it, so the run can replay every launch
    through the plain version and compare. Recording makes only device
    copies inside the tick (no host sync)."""
    from tpu_faas_torch.sched.resident import ResidentScheduler

    class Checked(ResidentScheduler):
        record = True
        #: CUDA events around each launch (packet upload + kernel), kept
        #: while recording is off
        launch_events: list = []

        def _launch(self, packet, flush):
            if not self.record:
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                out = super()._launch(packet, flush)
                b.record()
                self.launch_events.append((a, b))
                return out
            pre = clone_state(self._r_state)
            out = super()._launch(packet, flush)
            self.launch_log.append((packet.copy(), flush, pre, out))
            return out

        def tick_resident(self, now=None):
            self.launch_log = []
            return super().tick_resident(now)

    return Checked(
        max_workers=SHAPE["W"], max_pending=SHAPE["T"],
        max_inflight=SHAPE["I"], max_slots=MAX_SLOTS, time_to_expire=10.0,
        clock=clock, device=dev, use_priority=use_priority,
        **{k: SHAPE[k] for k in ("KA", "KH", "KF", "KI", "KS", "KB", "KP",
                                 "KR")},
    )


def replay_plain(rs, pre0) -> tuple[int, float]:
    """Replay the last tick's launches through the plain version, starting
    from the state copied before the first; compare every launch's outputs
    and the final state with the kernel's."""
    from tpu_faas_torch.sched.resident import (
        _flush_kernel_impl, _resident_tick_impl,
    )

    kw = dict(rs._statics(), KP=rs.KP, KR=rs.KR, max_slots=rs.max_slots)
    fkw = rs._statics()
    st, bad, err = pre0, 0, 0.0
    for pkt, flush, _, out in rs.launch_log:
        packet = torch.from_numpy(pkt).to(rs.device)
        if flush:
            st, arr = _flush_kernel_impl(packet, st, **fkw)
            if not torch.equal(arr, out[1]):
                bad += 1
                log("  MISMATCH flush arrival_slots")
        else:
            res, st = _resident_tick_impl(packet, st, **kw)
            b, e = compare(out[0], res, "out")
            bad, err = bad + b, max(err, e)
    b, e = compare(rs._r_state, st, "state")
    return bad + b, max(err, e)


def phase_resident(dev, n_ticks: int, timed_ticks: int) -> dict:
    from tpu_faas_torch.sched.fused_tick import KERNEL

    W, T = SHAPE["W"], SHAPE["T"]
    # per tick: 512 results and 512 arrivals (one full arrival lane), 128
    # heartbeats; 64 rows go silent — bench.py's churn at the headline shape
    n_churn, n_hb, n_silent = SHAPE["KA"], SHAPE["KH"] // 4, W // 64
    rng = np.random.default_rng(7)
    clock_box = [1000.0]
    rs = make_checked_scheduler(dev, lambda: clock_box[0], use_priority=True)
    procs = rng.integers(1, MAX_SLOTS + 1, W)
    speeds = rng.uniform(0.5, 4.0, W)
    for i in range(W):
        rs.register(b"w%d" % i, int(procs[i]), speed=float(speeds[i]))
    sizes: dict[str, float] = {}
    prios: dict[str, int] = {}
    ids = [f"bulk-{i}" for i in range(T)]
    bulk_sizes = rng.uniform(0.1, 10.0, T).astype(np.float32)
    bulk_prio = rng.integers(0, 4, T).astype(np.int32)
    for tid, s, p in zip(ids, bulk_sizes, bulk_prio):
        sizes[tid], prios[tid] = float(s), int(p)
    rs.pending_bulk_load(ids, bulk_sizes, bulk_prio)
    ptrs = [t.data_ptr() for t in rs._r_state]

    inflight: dict[str, int] = {}  # task -> row, as dispatched
    infl_list: list[str] = []
    running = np.zeros(W, np.int64)
    completed: set[str] = set()
    silenced: set[int] = set()
    silence_tick = n_ticks // 2
    n_new = 0
    stats = dict(placed=0, redispatched=0, purged=0, flushes=0,
                 steady_ticks=0, overflow_ticks=[], mismatches=0,
                 max_abs_err=0.0)
    expected_redispatch: set[int] | None = None
    expected_purge: set[int] | None = None
    tick_of_purge = None
    launches_at_start = KERNEL.launches

    def resolve_one():
        nonlocal expected_redispatch, expected_purge
        r = rs.resolve_next()
        for tid, row in r.placed:
            assert tid not in inflight and tid not in completed, (
                f"{tid} placed twice")
            rs.inflight_add(tid, row)
            inflight[tid] = row
            infl_list.append(tid)
            running[row] += 1
            stats["placed"] += 1
        over = np.flatnonzero(running > procs)
        assert not len(over), f"rows over-booked: {over[:8]}"
        if len(r.purged_rows):
            stats["purged"] += len(r.purged_rows)
            assert expected_purge is not None, (
                f"unexpected purge {r.purged_rows[:8]}")
            assert set(int(x) for x in r.purged_rows) == expected_purge
            assert set(r.redispatch_slots) == expected_redispatch, (
                "redispatch != in-flight slots of the purged rows")
            expected_purge = None
        for slot in r.redispatch_slots:
            tid = rs.inflight_clear_slot(slot)
            if tid is None:
                continue  # already reclaimed by an earlier resolve
            row = inflight.pop(tid)
            running[row] -= 1
            rs.pending_add(tid, sizes[tid], prios[tid])
            stats["redispatched"] += 1
        for row in r.purged_rows:
            rs.deactivate(int(row))
        return r

    tick_ms, tick_enqueue_ms, samples = [], [], []
    for k in range(n_ticks + timed_ticks):
        timed = k >= n_ticks
        rs.record = not timed
        if k == silence_tick:
            silenced.update(int(x) for x in
                            rng.choice(W, n_silent, replace=False))
            clock_box[0] += 11.0  # past time_to_expire for the silent rows
            for i in range(W):
                if i not in silenced:
                    rs.heartbeat(b"w%d" % i)
        else:
            clock_box[0] += 0.005
        # results from live rows free their slots
        done = 0
        while done < n_churn and infl_list:
            j = int(rng.integers(0, len(infl_list)))
            infl_list[j], infl_list[-1] = infl_list[-1], infl_list[j]
            tid = infl_list.pop()
            row = inflight.get(tid)
            if row is None:
                continue  # redispatched meanwhile
            if row in silenced:
                infl_list.insert(0, tid)
                done += 1
                continue
            del inflight[tid]
            running[row] -= 1
            completed.add(tid)
            rs.release_slot(rs.inflight_done(tid))
            done += 1
        for i in range(n_hb):
            w = (k * n_hb + i) % W
            if w not in silenced:
                rs.heartbeat(b"w%d" % w)
        for _ in range(n_churn):
            tid = f"new-{n_new}"
            n_new += 1
            sizes[tid] = float(rng.uniform(0.1, 10.0))
            prios[tid] = int(rng.integers(0, 4))
            rs.pending_add(tid, sizes[tid], prios[tid])
        if k == silence_tick:
            expected_purge = set(silenced)
            expected_redispatch = {
                int(s) for s in np.flatnonzero(
                    np.isin(rs.inflight_worker, list(silenced)))
            }
            tick_of_purge = k
        before = KERNEL.launches
        torch.cuda.set_sync_debug_mode("error")
        t0 = time.perf_counter()
        try:
            rs.tick_resident()
            t1 = time.perf_counter()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        n_launch = KERNEL.launches - before
        assert n_launch == rs.device_dispatches_last_tick
        assert [t.data_ptr() for t in rs._r_state] == ptrs, "state moved"
        if n_launch == 1:
            stats["steady_ticks"] += 1
        else:
            stats["flushes"] += n_launch - 1
            stats["overflow_ticks"].append(k)
            # only the cold start (a full buffer bouncing its first
            # arrivals), the mass-heartbeat tick and the re-queue of the
            # purged rows' tasks right after it may overflow a packet
            assert k < 16 or silence_tick <= k <= silence_tick + 4, (
                f"tick {k}: {n_launch} launches")
        if timed:
            tick_enqueue_ms.append((t1 - t0) * 1e3)
            tick_ms.append((t2 - t0) * 1e3)
        else:
            b, e = replay_plain(rs, rs.launch_log[0][2])
            stats["mismatches"] += b
            stats["max_abs_err"] = max(stats["max_abs_err"], e)
            assert b == 0, f"tick {k}: kernel != plain version"
            if n_launch == 1 and k >= n_ticks - timed_ticks:
                # the last steady ticks' packets and input states, for
                # timing the kernel alone on the main path's own data
                pkt, _, pre, _ = rs.launch_log[0]
                samples.append((torch.from_numpy(pkt).to(dev), pre))
        while len(rs._unresolved) > 1:  # stay two ticks deep
            resolve_one()
    while rs._unresolved:
        resolve_one()
    assert tick_of_purge is not None and expected_purge is None, (
        "the silenced rows were never purged")
    launches = KERNEL.launches - launches_at_start
    # nothing lost: every task is completed, in flight, or pending
    pending = set(rs.slot_task.values()) | {a.task_id for a in rs._arrivals}
    pending |= {a.task_id for a in rs._rejected}
    every = set(sizes)
    accounted = completed | set(inflight) | pending
    assert accounted == every, (
        f"lost {len(every - accounted)}, unknown {len(accounted - every)}")
    assert not (completed & set(inflight)) and not (completed & pending)
    assert not (set(inflight) & pending), "a task both in flight and pending"
    log(f"phase resident: {n_ticks + timed_ticks} ticks, {launches} kernel "
        f"launches ({stats['steady_ticks']} ticks with exactly one; packet "
        f"overflow flushes on ticks {stats['overflow_ticks']}), "
        f"placed {stats['placed']}, purged {stats['purged']}, redispatched "
        f"{stats['redispatched']}, completed {len(completed)}, in flight "
        f"{len(inflight)}, pending {len(pending)}, lost 0")
    stats.update(launches=launches, tick_ms=tick_ms,
                 tick_enqueue_ms=tick_enqueue_ms, samples=samples,
                 launch_ms=[a.elapsed_time(b) for a, b in rs.launch_events])
    return stats


# -- phase 3: SimFleet on the card --------------------------------------------
def phase_sim(dev) -> dict:
    from tpu_faas_torch.sim import SimFleet

    rng = np.random.default_rng(2)
    n_tasks = 20_000
    fleet = SimFleet(n_workers=4096, max_pending=20_480, rng=rng,
                     procs_per_worker=4, hetero=True, time_to_expire=1.0,
                     device=dev)
    sizes = rng.uniform(0.5, 3.0, n_tasks).astype(np.float32)
    t0 = time.perf_counter()
    res = fleet.run(sizes, dt=0.5, churn=0.05, max_ticks=4000)
    wall = time.perf_counter() - t0
    log(f"phase sim: 4096 workers x 4, churn 5%/tick: completed "
        f"{res.completed}/{n_tasks}, lost {res.lost}, {res.ticks} ticks, "
        f"makespan {res.makespan} sim-s, median tick "
        f"{res.median_tick_ms:.3f} ms (tick + readback), wall {wall:.1f} s")
    assert res.lost == 0 and res.completed == n_tasks
    return {"lost": res.lost, "median_tick_ms": res.median_tick_ms}


# -- phase 4: kernel B2 against its plain version -----------------------------
#: bench config 7's headline bid and BASELINE config 3's auction shape
BID_HEADLINE = (51_200, 32_768)
BID_CONFIG3 = (10_240, 4_096)
#: operations per cell the bid cannot avoid: the index product and sum (2),
#: the Wang hash (three shift-xor pairs and two products, 9), the shift by 8,
#: the int->float conversion, the 2^-24 scale (3) and four float ops
BID_OPS_PER_CELL = 18
F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores


def bid_inputs(dev, T: int, S: int, seed: int, frac_valid: float = 1.0):
    """Config 7's bid inputs: lognormal sizes, inv_speed U(0.25, 2), price
    U(0, 1)."""
    rng = np.random.default_rng(seed)
    valid = (rng.random(S) < frac_valid) if frac_valid < 1 else np.ones(S)
    return [torch.from_numpy(a.astype(np.float32)).to(dev) for a in (
        rng.lognormal(0.0, 1.0, T), rng.uniform(0.25, 2.0, S),
        valid, rng.uniform(0.0, 1.0, S))]


def bid_bound_ms(T: int, S: int) -> tuple[float, str]:
    """The least time for one bid: the larger of its operations at the
    f32 rate and its bytes (inputs once, outputs once) at the HBM rate."""
    ops_ms = T * S * BID_OPS_PER_CELL / F32_OPS_PER_S * 1e3
    bytes_ms = (4 * T + 12 * S + 12 * T) / HBM_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms,
                                                              "bytes")


def phase_bid(dev) -> dict:
    """B2 against its plain version on the card, exactly equal on v1,
    best and v2, at config 7's and config 3's shapes and the edge cases."""
    from tpu_faas_torch.sched.bid import KERNEL, bid_top2_stream_impl

    cases = []
    T, S = BID_HEADLINE
    cases.append(("config 7 headline", bid_inputs(dev, T, S, 7), 1e-4, {}))
    T, S = BID_CONFIG3
    cases.append(("config 3", bid_inputs(dev, T, S, 33, 0.8), 2.5e-4, {}))
    cases.append(("ragged 1000x3001", bid_inputs(dev, 1000, 3001, 1, 0.6),
                  2.5e-4, {}))
    ts, inv, _, price = bid_inputs(dev, 2048, 3001, 2)
    cases.append(("all slots invalid", [ts, inv, torch.zeros_like(inv),
                                        price], 2.5e-4, {}))
    one = torch.zeros_like(inv)
    one[1777] = 1.0
    cases.append(("one valid slot", [ts, inv, one, price], 2.5e-4, {}))
    # a max duplicated across lanes and strides, zero jitter keeps the tie
    dup_price = torch.ones(4096, device=dev)
    dup_price[[37, 69, 2048 + 911, 4000]] = 0.0
    cases.append(("duplicated max, zero jitter",
                  [torch.ones(1024, device=dev), torch.ones(4096, device=dev),
                   torch.ones(4096, device=dev), dup_price], 0.0, {}))
    cases.append(("row_offset/n_slots_total past 2^32",
                  bid_inputs(dev, 2000, 3001, 3, 0.7), 2.5e-4,
                  dict(row_offset=2**20 + 5, n_slots_total=8193)))
    mismatches = 0
    for name, args, js, kw in cases:
        js = float(np.float32(js))
        got = KERNEL(*args, js, **kw)
        want = bid_top2_stream_impl(*args, js, **kw)
        torch.cuda.synchronize()
        bad = [f for f, a, b in zip(("v1", "best", "v2"), got, want)
               if not torch.equal(a, b)]
        if name == "duplicated max, zero jitter":
            assert bool((got[1] == 37).all()), "duplicate max: wrong argmax"
            assert torch.equal(got[0], got[2]), "duplicate max: v2 != v1"
        if name == "all slots invalid":
            assert bool((got[1] == 0).all() & torch.isinf(got[0]).all())
        log(f"  {name} ({args[0].shape[0]} x {args[1].shape[0]}): "
            f"mismatched outputs {bad or 'none'}")
        mismatches += len(bad)
    if mismatches:
        raise SystemExit(f"bid_top2 disagrees with its plain version: "
                         f"{mismatches} mismatched outputs")
    log(f"phase bid: {len(cases)} cases exactly equal")
    return {"mismatches": 0, "max_abs_err": 0.0}


# -- phase 5: the batch auction tick ------------------------------------------
def check_assignment(assignment, task_valid, worker_free, worker_live):
    """Capacity respected, live workers only, no padding rows placed (the
    JAX suite's check, copied: this script imports nothing of it)."""
    assert assignment.shape == task_valid.shape
    assert (assignment[~task_valid] == -1).all(), "padding rows assigned"
    used = assignment[assignment >= 0]
    if used.size:
        counts = np.bincount(used, minlength=len(worker_free))
        assert (counts <= worker_free).all(), "capacity violated"
        assert worker_live[used].all(), "dead worker assigned"


def auction_fleets():
    """(name, max_slots, W, speeds, T, per-tick sizes): BASELINE config 3's
    two legs (10,000 tasks on 1,000 workers x 4, padded to 10,240 x 1,024)
    and the headline shape (51,200 pending, 4,096 x 8). Every worker
    registers max_slots processes."""
    n, w = 10_000, 1_000
    uni = [np.full(n, 1.0, np.float32) + np.float32((i + 1) * 1e-6)
           for i in range(4)]
    rng = np.random.default_rng(33)
    speeds = rng.uniform(0.5, 4.0, w).astype(np.float32)
    base = rng.lognormal(0.0, 1.0, n).astype(np.float32)
    logn = [(base * (1 + i * 1e-4)).astype(np.float32) for i in range(4)]
    rng = np.random.default_rng(51)
    hspeeds = rng.uniform(0.5, 4.0, 4096).astype(np.float32)
    hbase = rng.lognormal(0.0, 1.0, 51_200).astype(np.float32)
    head = [(hbase * (1 + i * 1e-4)).astype(np.float32) for i in range(3)]
    return [
        ("config 3 uniform", 4, 1024, np.ones(w, np.float32), 10_240, uni),
        ("config 3 lognormal", 4, 1024, speeds, 10_240, logn),
        ("headline", 8, 4096, hspeeds, 51_200, head),
    ]


def make_auction_arrays(dev, W, T, max_slots, speeds):
    from tpu_faas_torch.sched.state import SchedulerArrays

    sa = SchedulerArrays(max_workers=W, max_pending=T, max_inflight=4096,
                         max_slots=max_slots, clock=lambda: 1000.0,
                         placement="auction", device=dev)
    for i, s in enumerate(speeds):
        sa.register(b"w%d" % i, max_slots, speed=float(s))
    return sa


class plain_bids:
    """Within this block the auction bids with the plain version on the
    card (a replay's reference), never launching B2."""

    def __enter__(self):
        from tpu_faas_torch.sched import auction, bid

        self._mod, self._real = auction, auction.bid_top2
        auction.bid_top2 = bid.bid_top2_stream_impl

    def __exit__(self, *exc):
        self._mod.bid_top2 = self._real


def phase_auction(dev) -> dict:
    """SchedulerArrays(placement="auction") on the card, ticking each fleet
    with the price carry beside a twin whose bids are the plain version.
    Every tick: a legal, complete assignment, and the twin's tick equal on
    assignment, rounds, prices, refresh and spilled count."""
    from tpu_faas_torch.sched.bid import KERNEL

    stats = {"ticks": 0, "mismatches": 0, "rounds": {}, "arrays": {}}
    for name, K, W, speeds, T, batches in auction_fleets():
        sa = make_auction_arrays(dev, W, T, K, speeds)
        twin = make_auction_arrays(dev, W, T, K, speeds)
        free = np.minimum(sa.worker_free, K)
        for k, sizes in enumerate(batches):
            before = KERNEL.launches
            out = sa.tick(sizes)
            torch.cuda.synchronize()
            launches = KERNEL.launches - before
            with plain_bids():
                ref = twin.tick(sizes)
            a = out.assignment.cpu().numpy()
            valid = np.arange(T) < len(sizes)
            check_assignment(a, valid, free, sa.worker_active.copy())
            placed = int((a >= 0).sum())
            assert placed == min(len(sizes), int(free.sum())), (
                f"{name} tick {k}: placed {placed}")
            assert launches == out.auction_rounds, (
                f"{name} tick {k}: {launches} launches, "
                f"{out.auction_rounds} rounds")
            bad = [f for f in ("assignment", "auction_price",
                               "auction_refresh", "auction_spilled")
                   if not torch.equal(getattr(out, f), getattr(ref, f))]
            if out.auction_rounds != ref.auction_rounds:
                bad.append("auction_rounds")
            log(f"  {name} tick {k} ({'warm' if k else 'cold'}): placed "
                f"{placed}, rounds {out.auction_rounds}, spilled "
                f"{int(out.auction_spilled)}, refresh "
                f"{bool(out.auction_refresh)}, B2 launches {launches}, "
                f"plain-bid twin mismatches {bad or 'none'}")
            stats["mismatches"] += len(bad)
            stats["ticks"] += 1
            stats["rounds"].setdefault(name, []).append(out.auction_rounds)
        stats["arrays"][name] = (sa, batches)
    if stats["mismatches"]:
        raise SystemExit(f"auction ticks disagree with their plain-bid "
                         f"replay: {stats['mismatches']} fields")
    log(f"phase auction: {stats['ticks']} ticks, every one legal, complete "
        f"and equal to its plain-bid twin")
    return stats


# -- phase 6: times -----------------------------------------------------------
def event_ms(fn, n: int, setup=None) -> list[float]:
    """Per-call device time of ``fn`` with CUDA events, ``n`` calls after a
    warm-up; ``setup`` runs before each call, outside the timed pair. A spin
    kernel queued ahead of each call keeps the card busy while the host
    enqueues it, so the pair brackets device work and not the launch gap."""
    times = []
    for i in range(n + 3):
        torch.cuda._sleep(SPIN_CYCLES)
        arg = setup() if setup else None
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn(arg)
        b.record()
        if i >= 3:
            times.append((a, b))
    torch.cuda.synchronize()
    return [a.elapsed_time(b) for a, b in times]


def bound_ms(use_priority: bool, packet: torch.Tensor) -> float:
    """Least time for one tick's bytes at HBM rate, for this packet. Reads:
    the packet's header and used lanes, and each state leaf the tick reads,
    once. Writes: valid, free and prev_live in full (any entry may change);
    sizes and prio at the arrivals, last_hb, inflight, speed and active at
    this packet's counts (scatters); and the compacted outputs."""
    from tpu_faas_torch.sched.resident import _KG

    S = SHAPE
    T, W, I = S["T"], S["W"], S["I"]
    n_arr, n_hb, n_fr, n_if, n_sp, n_ac = (int(x) for x in packet[1:7])
    lanes = 2 if use_priority else 1
    pkt = 4 * (9 + n_arr * lanes + 2 * (n_hb + n_fr + n_if + n_sp + n_ac))
    reads = T * (4 + 1 + 4 * (lanes - 1)) + W * (4 + 4 + 1 + 4 + 1) + I * 4
    writes = (T + W * (4 + 1) + 4 * n_arr * lanes
              + 4 * (n_hb + n_if + n_sp) + n_ac)
    outs = 4 * (2 * S["KP"] + S["KA"] + S["KR"] + 1 + _KG) + 2 * W
    return (pkt + reads + writes + outs) / HBM_BYTES_PER_S * 1e3


def phase_time(dev, n: int, samples: list) -> dict:
    """Kernel and plain-version times; ``samples`` are the resident run's
    own (packet, input state) pairs from its last steady ticks."""
    from tpu_faas_torch.sched.fused_tick import KERNEL
    from tpu_faas_torch.sched.resident import (
        _resident_tick_impl, state_from_numpy,
    )
    from tpu_faas_torch.sched.state import SchedulerArrays

    kw = dict(SHAPE, max_slots=MAX_SLOTS, use_priority=True)
    order = iter(range(10**9))

    def next_sample():
        packet, pre = samples[next(order) % len(samples)]
        return packet, clone_state(pre)

    loop_ms = event_ms(lambda a: KERNEL(a[0], a[1], flush=False, **kw),
                       len(samples), setup=next_sample)
    loop_bound = statistics.median(bound_ms(True, p.cpu()) for p, _ in samples)
    out = {"loop": (statistics.median(loop_ms), loop_bound)}
    log(f"  kernel on the resident run's own states (prio=True): "
        f"{out['loop'][0]:.4f} ms (min {min(loop_ms):.4f}), bound "
        f"{loop_bound:.6f} ms, medians of {len(loop_ms)}")
    for use_priority in (True, False):
        leaves, pkt = random_case(np.random.default_rng(3), use_priority,
                                  now=100.0)
        base = state_from_numpy(leaves, dev)
        packet = torch.from_numpy(pkt).to(dev)
        kw = dict(SHAPE, max_slots=MAX_SLOTS, use_priority=use_priority)
        k_ms = event_ms(lambda st: KERNEL(packet, st, flush=False, **kw), n,
                        setup=lambda: clone_state(base))
        p_ms = event_ms(lambda _: _resident_tick_impl(packet, base, **kw), n)
        bound = bound_ms(use_priority, torch.from_numpy(pkt))
        out[use_priority] = (statistics.median(k_ms),
                             statistics.median(p_ms), bound)
        log(f"  synthetic state, prio={use_priority}: kernel "
            f"{statistics.median(k_ms):.4f} ms (min {min(k_ms):.4f}), plain "
            f"version on the card {statistics.median(p_ms):.4f} ms, bound "
            f"{bound:.6f} ms, medians of {n}")
    # the batch tick (SchedulerArrays.tick) at the same shape
    rng = np.random.default_rng(4)
    sa = SchedulerArrays(max_workers=SHAPE["W"], max_pending=SHAPE["T"],
                         max_inflight=SHAPE["I"], max_slots=MAX_SLOTS,
                         clock=lambda: 1000.0, device=dev)
    for i in range(SHAPE["W"]):
        sa.register(b"w%d" % i, int(rng.integers(1, 9)),
                    speed=float(rng.uniform(0.5, 4.0)))
    for i in range(16_384):
        sa.inflight_add(f"t{i}", int(rng.integers(0, SHAPE["W"])))
    batch = rng.uniform(0.1, 10.0, 50_000).astype(np.float32)
    walls = []
    for i in range(n + 3):
        t0 = time.perf_counter()
        o = sa.tick(batch)
        o.assignment[:1].cpu()
        if i >= 3:
            walls.append((time.perf_counter() - t0) * 1e3)
    out["batch_ms"] = statistics.median(walls)
    log(f"  batch tick (SchedulerArrays.tick, 50,000 tasks, readback of "
        f"one value): {out['batch_ms']:.4f} ms median of {n}")
    return out


def time_bid(dev, n: int) -> dict:
    """B2 and its plain version at config 7's and config 3's shapes, each
    beside its bound."""
    from tpu_faas_torch.sched.bid import KERNEL, bid_top2_stream_impl

    out = {}
    for name, (T, S), seed in (("headline", BID_HEADLINE, 7),
                               ("config3", BID_CONFIG3, 33)):
        args = bid_inputs(dev, T, S, seed)
        js = float(np.float32(1e-4))
        k_ms = event_ms(lambda _: KERNEL(*args, js), n)
        p_ms = event_ms(lambda _: bid_top2_stream_impl(*args, js),
                        max(3, n // 10))
        bound, by = bid_bound_ms(T, S)
        out[name] = (statistics.median(k_ms), statistics.median(p_ms),
                     bound, by)
        log(f"  bid_top2 {T} x {S}: kernel {out[name][0]:.4f} ms (min "
            f"{min(k_ms):.4f}), plain version on the card "
            f"{out[name][1]:.4f} ms, bound {bound:.4f} ms ({by}: "
            f"{BID_OPS_PER_CELL} ops/cell at {F32_OPS_PER_S / 1e12:.0f} "
            f"TFLOP/s), kernel/bound {out[name][0] / bound:.2f}")
    return out


def time_auction(auction: dict, reps: int) -> dict:
    """Host-clock medians of the integrated auction tick (upload, solve,
    one value read back), cold (carried prices dropped) and warm."""
    out = {}
    for name, (sa, batches) in auction["arrays"].items():
        for mode in ("cold", "warm"):
            walls, rounds = [], []
            for i in range(reps):
                if mode == "cold":
                    sa._d_auction_price = None
                t0 = time.perf_counter()
                o = sa.tick(batches[i % len(batches)])
                o.assignment[:1].cpu()
                walls.append((time.perf_counter() - t0) * 1e3)
                rounds.append(o.auction_rounds)
            out[(name, mode)] = statistics.median(walls)
            log(f"  auction tick, {name}, {mode}: "
                f"{out[(name, mode)]:.3f} ms median of {reps}, rounds "
                f"{rounds}")
    return out


def main() -> int:
    if len(sys.argv) > 1:
        print(f"usage: python3 {sys.argv[0]}  (no arguments: every phase "
              f"runs)", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from concurrent.futures import ThreadPoolExecutor

    from tpu_faas_torch.sched import bid, fused_tick

    dev = torch.device("cuda")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python "
        f"{sys.version.split()[0]}, device {kind}")
    t0 = time.perf_counter()
    kernels = (fused_tick.KERNEL, bid.KERNEL)
    with ThreadPoolExecutor(len(kernels)) as pool:  # one nvcc per source
        for f in [pool.submit(k.load) for k in kernels]:
            f.result()
    log(f"phase build: fused_tick and bid_top2 built in "
        f"{time.perf_counter() - t0:.1f} s")
    for k in kernels:
        for line in k.ptxas_report.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"  ptxas {k.name}: {line.strip()}")

    rk = phase_kernel(dev)
    fused_tick.KERNEL.launches = 0  # count the main path alone
    rr = phase_resident(dev, N_TICKS, N_TIMED)
    launches = fused_tick.KERNEL.launches
    assert launches > 0, "the main path never launched"
    log(f"  integrated tick_resident (diff, pack, upload, kernel; "
        f"synchronized): {statistics.median(rr['tick_ms']):.4f} ms, host "
        f"enqueue alone {statistics.median(rr['tick_enqueue_ms']):.4f} ms, "
        f"packet upload + kernel on the card "
        f"{statistics.median(rr['launch_ms']):.4f} ms, medians of "
        f"{len(rr['tick_ms'])} ticks [{card}]")
    phase_sim(dev)
    rb = phase_bid(dev)
    bid.KERNEL.launches = 0  # count the auction path alone
    ra = phase_auction(dev)
    bid_launches = bid.KERNEL.launches
    assert bid_launches > 0, "the auction path never launched bid_top2"
    log(f"  B2 launches on the auction path: {bid_launches} in "
        f"{ra['ticks']} ticks, rounds per tick {ra['rounds']}")
    log(f"phase time [{card}]:")
    t = phase_time(dev, N_TIMED, rr["samples"])
    tb = time_bid(dev, N_TIMED // 3)
    time_auction(ra, 3)
    entry = {"name": "fused_resident_tick", "route": "cuda",
             "source": fused_tick.SOURCE, "replaces": fused_tick.REPLACES,
             "launches": launches,
             "mismatches": rk["mismatches"] + rr["mismatches"],
             "max_abs_err": max(rk["max_abs_err"], rr["max_abs_err"]),
             "ms": t["loop"][0], "plain_ms": t[True][1],
             "bound_ms": t["loop"][1], "bound_by": "bytes",
             "library_ms": None}
    k_ms, p_ms, b_ms, by = tb["headline"]
    # no single PyTorch call computes the hashed top-2 bid
    entry_b2 = {"name": "bid_top2", "route": "cuda", "source": bid.SOURCE,
                "replaces": bid.REPLACES, "launches": bid_launches,
                "mismatches": rb["mismatches"] + ra["mismatches"],
                "max_abs_err": rb["max_abs_err"], "ms": k_ms,
                "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": by,
                "library_ms": None}
    log(f"card: {card}")
    print(json.dumps({"kernels": [entry, entry_b2]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
