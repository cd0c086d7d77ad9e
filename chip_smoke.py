"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (an H100 is the target).

    python3 chip_smoke.py      # every phase, at the headline shape

Phases, all run every time (each fails the run; nothing is caught and passed
over):

0. ``build``  — print the card's name and power limit, the torch and CUDA
   versions; build the libraries from ``tpu_faas_torch/csrc`` with nvcc for
   sm_90a, one nvcc per build, started together: the fused tick (B1, rank,
   auction and Sinkhorn branches), its probe build (``-DTPU_FAAS_PROBE``:
   each branch stamps block 0's clock at its phases) and the top-2 bid
   (B2); print each kernel's registers and shared memory.
1. ``kernel`` — the fused tick's rank branch against its plain PyTorch
   version on the card, at 51,200 pending x 4,096 workers x 65,536
   in-flight slots, priority admission on and off, several seeds: every
   output and every state leaf must be exactly equal. Then its edge
   states (``edge_case``), exactly equal too: a cold tick with every slot
   free, a priority threshold inside a tie of thousands, no valid slot,
   and -inf and NaN speeds on a live row with free slots and sizes on an
   admitted task, which alone must take the branch's full-length path (a
   count in its scratch); the cold tick is timed.
2. ``resident`` — the resident scheduler end to end at that shape: 4,096
   workers, 51,200 bulk-loaded tasks, then per tick 512 results, 128
   heartbeats and 512 arrivals with the clock advanced 5 ms, resolved in tick
   order two ticks deep; partway through 64 workers go silent past
   time_to_expire. Checks one kernel launch per steady tick, no host sync
   inside ``tick_resident`` (``torch.cuda.set_sync_debug_mode("error")``),
   state tensors that never move, no task over-booked, placed twice or lost,
   every in-flight slot of a purged worker redispatched, and every launch's
   outputs and state equal to the plain version's from the same state.
   Logs how many of the loop's rank ticks took the full-length path.
3. ``sim``    — ``SimFleet`` on the card: 4,096 workers x 4 processes, 5%
   churn per tick, 20,000 tasks; every task completes, none lost.
4. ``bid``    — kernel B2 against its plain version on the card, exactly
   equal on v1, best and v2: at bench config 7's headline bid (51,200 x
   32,768), at BASELINE config 3's shape (10,240 x 4,096), ragged, with no
   valid slot and one, with a max duplicated across lanes at zero jitter,
   with a hash index past 2^32 (row_offset, n_slots_total), and with
   ROADMAP C.3's NaN sizes, speed, prices and jitter and an inf - inf cell
   (4,096 x 32,768; a NaN equal to a NaN in the same place).
5. ``auction`` — ``SchedulerArrays(placement="auction")`` on the card, the
   batch auction tick with the price carry: config 3's uniform and
   lognormal legs (10,000 tasks, 1,000 workers x 4) over 4 ticks each, and
   3 ticks at the headline shape (51,200 pending, 4,096 workers x 8). Every
   tick's assignment is legal and complete, takes one B2 launch per
   bidding round, and equals a twin tick whose bids are the plain version,
   on assignment, rounds, prices, refresh and spilled count.
6. ``resident_auction`` — B1's auction branch: first against its plain
   version on synthetic headline states (refresh on and off, priority lanes
   on and off, two seeds; seed 0 also against the plain version with plain
   bids; a warm tick with 13 bidders and a cold tick in which every task
   bids; C.3's NaN sizes, cold and warm, NaN speeds and NaN carried
   prices), every output and state leaf exactly equal, prices, refresh,
   round and spilled counts included; then ``ResidentScheduler(placement=
   "auction")`` through phase 2's loop for 40 ticks (FCFS), with phase 2's
   checks, one cooperative launch per steady tick, and at least one cold
   (refresh) and one warm tick. The kernel also reports the bidder rows
   summed over its rounds, equal to the plain version's count. Then the
   round split: the probe build on the 13-bidder and every-bidder ticks and
   on the loop's last 10 states (each launch equal to the kernel proper's),
   block 0's clock at the opening, the seed or rebase, each round's bids
   (until the last block is done), their barrier, the install pass and the
   bidder collection with theirs, and the close.
7. ``resident_sinkhorn`` — B1's Sinkhorn branch: the kernel's ``expf`` and
   ``logf`` bit for bit against ``torch.exp``/``torch.log``; the branch
   against its plain version on synthetic headline states (bucketed route,
   priority lanes on and off, two seeds; one with -inf sizes and speeds,
   whose spill must take rank placement's own sorts) and on one
   dense-route state at 4,096 x 4,096, under the contract: (a) exact on
   every output and state leaf that placement does not decide, the count
   placed and the effective temperature; (b) final potentials within SINKHORN_TOL of tau; (c) the
   plain rounding from the kernel's own potentials equal to the kernel's
   tick on every output and leaf; (d) no row over-booked, no task placed
   twice, placed = min(KP, valid, capacity). Ticks placed otherwise than
   the plain version's own potentials are counted, not failed. Then
   ``ResidentScheduler(placement="sinkhorn")`` through phase 2's loop for 50
   ticks (FCFS) with phase 2's checks, every launch held to the contract
   from its pre-state; and ``SchedulerArrays(placement="sinkhorn")`` at
   BASELINE config 4, beside config 4's own solve, against the LP makespan
   bound.
8. ``resident_tenancy`` — B1's tenancy lane (``NT`` = 32 tenant rows, the
   dispatcher's default) in its three branches: against the plain version on
   synthetic headline states (tenant rows past both ends of [0, NT) in the
   state and the arrival lane, deficits around the starvation threshold and
   at the cap, caps of 0, at ``ahead``, below and above it; priority lanes
   off and on), rank and auction ticks and the flush exactly equal on every
   output and state leaf (``t_deficit`` and the eligibility included; one
   auction state also against plain bids), Sinkhorn under its contract with
   the eligibility added to (a); each branch timed with the lane off and
   on, on the same state. Then a resident loop per branch (phase 2's loop
   and checks, shortened: 60 rank, 16 auction and 20 Sinkhorn ticks) with
   config 16's shares and caps (light=8, heavy=1, heavy capped at the
   fleet's slots minus one) and four more capped tenants, arrivals tagged
   across all 32 rows, the table's inflight counts kept as the dispatcher
   keeps them; every launch holds each tenant within its allowance. A rank
   and an auction tick with 4,096 tenant rows (past the 1,024 whose counts
   block 0 keeps in shared memory) are exactly equal too, and a rank tick
   at 1,100 rows with priorities. Last, the rank branch with the lane on
   the rank loop's own states, beside its plain version and its bound,
   and its split by the probe build.
9. ``resident_spec`` — B1's speculation lane (config 18's knobs: straggler
   multiplier 3, floor 0.02 s) in its three branches: against the plain
   version on synthetic headline states with the tenancy lane off and on
   (in-flight slots past, at and under their threshold, on dead rows, with
   pred <= 0 and NaN; packet pred and avoid lanes with clears and wrapped
   negative indices; the avoid rows of more than 64 tasks on the rows
   placement gives them, so the veto fires and the fixup's bound binds;
   over-cap free counts), rank and auction ticks and the flush exactly
   equal on every output and state leaf (the straggler slots and the
   ``infl_start``/``infl_pred``/``avoid`` leaves included), Sinkhorn under
   its contract with the fixup added to (c) and (d); each branch timed with
   the lane off and on, on the same state. Then a resident loop per branch
   (phase 2's loop and checks: 60 rank ticks with priority, 16 auction, 20
   Sinkhorn, and 25 rank ticks with the tenancy lane too) in which 64 live
   workers never return results, so their slots flag; each tick re-submits
   the newly flagged slots (at most KG) as hedges avoiding the original's
   row, as the dispatcher does; no hedge lands on its avoid row. Last, the
   rank branch with the lane on the rank loop's own states, beside its
   plain version and its bound, and its split by the probe build.
10. ``time``  — CUDA-event medians of B1's rank branch (on the resident run's
   own states and packets, and on a synthetic state), the probe build's
   split of the rank branch on the same states (block 0's clock at the end
   of each phase: packet, liveness, lists, tenancy, select, admission,
   sorts, pairing, fixup, deficit, compaction; the valid slots, admitted
   tasks, select passes and full-length ticks), and of B2 (at both bid
   shapes), and CUDA-event means of B1's auction branch over the resident
   auction run's own states (its warm and cold ticks differ forty-fold in
   bidders; each kind's medians are printed too), and of their plain
   versions, each beside its bound (the auction's counts the cells its
   bidders swept); the auction's plain version bids with the plain top-2,
   and each of its ticks is held exactly against the kernel's; the bids'
   bound counts each cell's instructions per issue pipe, read from the
   compiled loop, at the card's clock; CUDA-event
   means of B1's Sinkhorn branch and its plain version over the resident
   Sinkhorn run's states, with a launch's split by block 0's clock, a grid
   barrier timed alone, the probe build's split of each state (f-updates,
   g-updates and their barriers, the close's sorts and spill, candidates
   and spilled tasks), the bound per pipe (one exp a cell on the SFU
   against 5 issue slots) and the iterations' library yardstick (40
   torch.logsumexp calls over the materialized matrix, context only); host-clock medians of the integrated
   ``tick_resident`` (rank, auction and Sinkhorn), of the batch tick and of
   the auction tick cold and warm, all printed beside the card's name and
   power limit. Each timed launch is queued behind a spin kernel, so its
   events measure device time and not the host's launch gap.

The last line of stdout is ``{"ok": true, "device": {...}}``; the line before
it lists each kernel's launches on its main path (the resident run for B1's
rank branch, the auction ticks for B2, the resident auction run for B1's
auction branch, the resident Sinkhorn run for its Sinkhorn branch, and the
resident tenancy rank run for its tenancy lane, and the resident
speculation rank run for its speculation lane), errors and times. Without a
CUDA device the script exits non-zero and prints no result.
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
N_AUCTION_TICKS = 30  # checked resident auction ticks
N_AUCTION_TIMED = 10  # timed resident auction ticks
#: spin queued ahead of each timed launch (about 10 ms at 1.98 GHz), so the
#: host has enqueued the launch before the card reaches its start event
SPIN_CYCLES = 20_000_000
#: the tenancy lane: the dispatcher's default max_tenants
#: (tpu_faas/dispatch/tpu_push.py:104), and the statics that turn it on
NT_HEADLINE = 32
TENANCY_KW = dict(use_tenancy=True, NT=NT_HEADLINE)
#: tenant rows past the 1,024 whose counts block 0 keeps in shared memory
#: (ROADMAP C.2's cases)
NT_MID, NT_WIDE = 1100, 4096
#: the resident loops' arrival mix over the 32 rows: default, light, heavy,
#: then the 29 other tenants evenly
TENANT_MIX = np.array([0.05, 0.15, 0.6] + [0.2 / 29] * 29)
#: (checked, timed) resident ticks with the tenancy lane, per branch
TENANCY_TICKS = {"rank": (40, 20), "auction": (12, 4), "sinkhorn": (15, 5)}
#: the speculation lane: config 18's knobs (tpu_faas/bench/configs.py:3169),
#: the scheduler's straggler output, the prediction stamped on every
#: dispatch (seconds; flagged past 3 x 0.02 s = 12 ticks of 5 ms) and the
#: live workers that never return a result
SPEC_MULT, SPEC_MIN_S, KG = 3.0, 0.02, 64
SPEC_KW = dict(use_spec=True, KG=KG)
SPEC_PRED = 0.02
N_STUCK = 64
#: (checked, timed) resident ticks with the speculation lane, per loop
SPEC_TICKS = {"rank": (40, 20), "auction": (12, 4), "sinkhorn": (15, 5),
              "rank+tenancy": (20, 5)}


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
def random_case(rng: np.random.Generator, use_priority: bool, now: float,
                shape: dict = SHAPE):
    """A resident state and one full delta packet with ties, zero (and
    negative-zero) sizes, dead and silent workers, never-heard rows,
    negative and over-cap free counts, an over-KP backlog and negative free
    deltas, at ``shape`` (the headline by default)."""
    T, W, I = shape["T"], shape["W"], shape["I"]
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
    S = shape
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


def same(x: torch.Tensor, y: torch.Tensor) -> bool:
    """torch.equal, with a NaN equal to a NaN in the same place (the
    speculation lane carries NaN predictions as values)."""
    if torch.equal(x, y):
        return True
    if not x.is_floating_point() or x.shape != y.shape:
        return False
    nx, ny = torch.isnan(x), torch.isnan(y)
    return torch.equal(nx, ny) and torch.equal(x[~nx], y[~ny])


def compare(a, b, what: str) -> tuple[int, float]:
    """(mismatched fields, max abs error) between two tuples of tensors."""
    bad, err = 0, 0.0
    for name, x, y in zip(a._fields, a, b):
        if x is None and y is None:
            continue
        if x.shape != y.shape or x.dtype != y.dtype or not same(x, y):
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


#: the rank branch's edge states (``edge_case``); the fallback ones take
#: its full-length path
RANK_EDGES = ("cold", "tie", "no_slots", "inf_speed", "nan_speed",
              "inf_size", "nan_size")
RANK_FALLBACKS = ("inf_speed", "nan_speed", "inf_size", "nan_size")


def edge_case(kind: str, use_priority: bool):
    """``random_case``'s state and packet (seed 30) made into one of the
    rank branch's edge states. ``cold``: every slot free (every row live
    with free counts past K) under 95% valid tasks, more than the slots;
    ``tie``: priorities 0 on nine tasks in ten and 5 on the rest, so the
    admission's threshold falls inside a tie of thousands; ``no_slots``:
    every row inactive; ``inf_speed``/``nan_speed``: a live row with free
    slots whose speed is -inf/NaN; ``inf_size``/``nan_size``: task 0,
    valid and first in the admission, of size -inf/NaN. Each but ``tie``
    and ``no_slots`` drops the packet's heartbeat, free, speed and active
    scatters, which would change the rows it set."""
    leaves, pkt = random_case(np.random.default_rng(30), use_priority,
                              now=100.0)
    T, W = SHAPE["T"], SHAPE["W"]
    leaves = {k: np.array(v) for k, v in leaves.items()}
    rng = np.random.default_rng(31)
    if kind not in ("tie", "no_slots"):
        pkt[[2, 3, 5, 6]] = 0
    if kind == "cold":
        leaves["valid"] = rng.random(T) < 0.95
        leaves["free"][:] = MAX_SLOTS + 2
        leaves["active"][:] = True
        leaves["last_hb"][:] = 100.0
    elif kind == "tie":
        leaves["valid"] = rng.random(T) < 0.95
        leaves["prio"] = np.where(rng.random(T) < 0.1, 5, 0).astype(np.int32)
    elif kind == "no_slots":
        leaves["active"][:] = False
        pkt[6] = 0
    elif kind in ("inf_speed", "nan_speed"):
        leaves["active"][0] = True
        leaves["last_hb"][0] = 100.0
        leaves["free"][0] = MAX_SLOTS
        leaves["speed"][0] = -np.inf if kind == "inf_speed" else np.nan
    elif kind in ("inf_size", "nan_size"):
        leaves["valid"][0] = True
        leaves["prio"][0] = 100
        leaves["sizes"][0] = -np.inf if kind == "inf_size" else np.nan
    return leaves, pkt


def rank_edges(dev) -> dict:
    """The rank branch on ``edge_case``'s states, priority lanes off and on
    (``tie`` with priorities alone): every output and state leaf exactly
    equal to the plain version's, and the fallback states, and they alone,
    counted on the full-length path. Then the cold state timed, kernel and
    plain version, with priority."""
    from tpu_faas_torch.sched.fused_tick import KERNEL
    from tpu_faas_torch.sched.resident import (
        _resident_tick_impl, state_from_numpy,
    )

    S = SHAPE
    bad, err, cases = 0, 0.0, 0
    for kind in RANK_EDGES:
        for use_priority in ((True,) if kind == "tie" else (False, True)):
            leaves, pkt = edge_case(kind, use_priority)
            packet = torch.from_numpy(pkt).to(dev)
            kw = dict(S, max_slots=MAX_SLOTS, use_priority=use_priority)
            res_p, new_p = _resident_tick_impl(
                packet, state_from_numpy(leaves, dev), **kw)
            before = KERNEL.rank_fallbacks(dev, S["T"], S["W"], MAX_SLOTS)
            res_k, new_k = KERNEL(packet, state_from_numpy(leaves, dev),
                                  flush=False, **kw)
            took = KERNEL.rank_fallbacks(dev, S["T"], S["W"],
                                         MAX_SLOTS) - before
            b1, e1 = compare(res_k, res_p, f"{kind} out")
            b2, e2 = compare(new_k, new_p, f"{kind} state")
            want = int(kind in RANK_FALLBACKS)
            if took != want:
                b1 += 1
                log(f"  MISMATCH {kind}: full-length path taken {took} "
                    f"times, expected {want}")
            log(f"  {kind} prio={use_priority}: placed "
                f"{int((res_k.placed_slots >= 0).sum())}/{S['KP']} (KP), "
                f"n_pending {int(res_k.n_pending)}, full-length path "
                f"{bool(took)}, mismatched fields {b1 + b2}")
            bad += b1 + b2
            err = max(err, e1, e2)
            cases += 1
    if bad:
        raise SystemExit(f"rank edge states disagree with the plain version: "
                         f"{bad} mismatched fields")
    leaves, pkt = edge_case("cold", True)
    base = state_from_numpy(leaves, dev)
    packet = torch.from_numpy(pkt).to(dev)
    kw = dict(S, max_slots=MAX_SLOTS, use_priority=True)
    k_ms = event_ms(lambda st: KERNEL(packet, st, flush=False, **kw),
                    N_TIMED, setup=lambda: clone_state(base))
    p_ms = event_ms(lambda _: _resident_tick_impl(packet, base, **kw), 10)
    cold = (statistics.median(k_ms), statistics.median(p_ms))
    log(f"phase rank edges: {cases} ticks exactly equal; the cold tick "
        f"(every slot free, priority): kernel {cold[0]:.4f} ms (min "
        f"{min(k_ms):.4f}), plain version {cold[1]:.4f} ms, medians of "
        f"{len(k_ms)} and {len(p_ms)}")
    return {"mismatches": bad, "max_abs_err": err, "cold": cold}


# -- phase 2: the resident path end to end ------------------------------------
def make_checked_scheduler(dev, clock, use_priority: bool, placement: str,
                           tenancy=None, spec: bool = False):
    """A ResidentScheduler that records, for each kernel launch, the packet
    and a copy of the state before it, so the run can replay every launch
    through the plain version and compare. Recording makes only device
    copies inside the tick (no host sync). ``tenancy`` is its TenantTable
    (None: the lane off); ``spec`` turns the speculation lane on with
    config 18's knobs."""
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
        placement=placement, tenancy=tenancy,
        **(dict(spec_mult=SPEC_MULT, spec_min_s=SPEC_MIN_S, KG=KG)
           if spec else {}),
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
            res, st = _resident_tick_impl(packet, st, placement=rs.placement,
                                          **kw)
            b, e = compare(out[0], res, "out")
            bad, err = bad + b, max(err, e)
    b, e = compare(rs._r_state, st, "state")
    return bad + b, max(err, e)


def phase_resident(dev, n_ticks: int, timed_ticks: int,
                   placement: str = "rank", tenancy: bool = False,
                   spec: bool = False) -> dict:
    """The resident loop (see the module docstring); ``tenancy`` runs it with
    the tenancy lane on: ``tenant_table``'s shares and caps, arrivals
    tagged across its tenants, the table's inflight counts kept with
    note_dispatched/note_done as the dispatcher keeps them, and every
    launch's placements held to each tenant's allowance. ``spec`` runs it
    with the speculation lane on: every dispatch stamped with SPEC_PRED,
    N_STUCK live workers that never return a result, each resolved tick's
    newly flagged slots re-submitted as hedges that avoid the original's
    row, and every launch's placements held off their avoid rows."""
    from tpu_faas_torch.sched.fused_tick import KERNEL

    def n_launches():  # rank ticks and flushes, auction and Sinkhorn ticks
        return (KERNEL.launches + KERNEL.auction_launches
                + KERNEL.sinkhorn_launches)

    auction = placement == "auction"
    sinkhorn = placement == "sinkhorn"
    W, T = SHAPE["W"], SHAPE["T"]
    # per tick: 512 results and 512 arrivals (one full arrival lane), 128
    # heartbeats; 64 rows go silent — bench.py's churn at the headline shape
    n_churn, n_hb, n_silent = SHAPE["KA"], SHAPE["KH"] // 4, W // 64
    rng = np.random.default_rng(7)
    clock_box = [1000.0]
    procs = rng.integers(1, MAX_SLOTS + 1, W)
    speeds = rng.uniform(0.5, 4.0, W)
    ten = tenant_table(int(procs.sum())) if tenancy else None
    # tenant tags draw from their own generator: the loop's other draws
    # stay those of the run without tenancy
    trng = np.random.default_rng(17)
    tenant_of: dict[str, int] = {}

    def tag(tid: str) -> int:
        tenant_of[tid] = int(trng.choice(NT_HEADLINE, p=TENANT_MIX)) \
            if tenancy else 0
        return tenant_of[tid]

    # the auction and Sinkhorn ignore priorities: their loops run FCFS
    rs = make_checked_scheduler(dev, lambda: clock_box[0],
                                use_priority=placement == "rank",
                                placement=placement, tenancy=ten, spec=spec)
    # the speculation lane's stuck rows and hedges draw from their own
    # generator too
    srng = np.random.default_rng(27)
    stuck = (set(int(x) for x in srng.choice(W, N_STUCK, replace=False))
             if spec else set())
    hedge_avoid: dict[str, int] = {}  # hedge id -> its original's row
    hedged: set[str] = set()
    # hedges queued since the last tick's arrivals: they take the place of
    # as many new arrivals, so a tick's arrivals still fill one packet lane
    queued_hedges = [0]
    for i in range(W):
        rs.register(b"w%d" % i, int(procs[i]), speed=float(speeds[i]))
    sizes: dict[str, float] = {}
    prios: dict[str, int] = {}
    ids = [f"bulk-{i}" for i in range(T)]
    bulk_sizes = rng.uniform(0.1, 10.0, T).astype(np.float32)
    bulk_prio = rng.integers(0, 4, T).astype(np.int32)
    for tid, s, p in zip(ids, bulk_sizes, bulk_prio):
        sizes[tid], prios[tid] = float(s), int(p)
    bulk_tenants = np.array([tag(tid) for tid in ids], np.int32)
    rs.pending_bulk_load(ids, bulk_sizes, bulk_prio,
                         bulk_tenants if tenancy else None)
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
                 max_abs_err=0.0, cold_ticks=0, warm_ticks=0, rounds=[],
                 spilled=[], bid_rows=[], max_df=0.0, differs=0,
                 scale=0.0, over_allowance=0, on_avoid=0, flagged=0,
                 flag_ticks=0, hedges=0, hedges_placed=0,
                 placed_by_tenant=np.zeros(NT_HEADLINE, np.int64))
    expected_redispatch: set[int] | None = None
    expected_purge: set[int] | None = None
    tick_of_purge = None
    launches_at_start = n_launches()

    def resolve_one():
        nonlocal expected_redispatch, expected_purge
        r = rs.resolve_next()
        for tid, row in r.placed:
            assert tid not in inflight and tid not in completed, (
                f"{tid} placed twice")
            if tid in hedge_avoid:
                assert row != hedge_avoid[tid], f"{tid} on its avoid row"
                stats["hedges_placed"] += 1
            rs.inflight_add(tid, row, pred=SPEC_PRED if spec else 0.0)
            inflight[tid] = row
            infl_list.append(tid)
            running[row] += 1
            stats["placed"] += 1
            if ten is not None:
                ten.note_dispatched(tenant_of[tid])
                stats["placed_by_tenant"][tenant_of[tid]] += 1
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
        assert not set(r.straggler_slots) & set(r.redispatch_slots), (
            "a slot both flagged and redispatched")
        stats["flagged"] += len(r.straggler_slots)
        stats["flag_ticks"] += bool(r.straggler_slots)
        for slot in r.straggler_slots:
            # the dispatcher's hedge: the same work again, once per task,
            # kept off the worker that runs the original
            tid = rs.inflight_task[slot]
            if tid is None or tid in hedged or tid in hedge_avoid:
                continue
            hedged.add(tid)
            hid = f"hedge-{tid}"
            sizes[hid], prios[hid] = sizes[tid], prios[tid]
            tenant_of[hid] = tenant_of[tid]
            hedge_avoid[hid] = int(rs.inflight_worker[slot])
            rs.pending_add(hid, sizes[hid], prios[hid], tenant_of[hid],
                           avoid=hedge_avoid[hid])
            stats["hedges"] += 1
            queued_hedges[0] += 1
        for slot in r.redispatch_slots:
            tid = rs.inflight_clear_slot(slot)
            if tid is None:
                continue  # already reclaimed by an earlier resolve
            row = inflight.pop(tid)
            running[row] -= 1
            if ten is not None:
                ten.note_done(tenant_of[tid])
            rs.pending_add(tid, sizes[tid], prios[tid], tenant_of[tid],
                           avoid=hedge_avoid.get(tid, -1))
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
            if row in silenced or row in stuck:
                infl_list.insert(0, tid)
                done += 1
                continue
            del inflight[tid]
            running[row] -= 1
            completed.add(tid)
            if ten is not None:
                ten.note_done(tenant_of[tid])
            rs.release_slot(rs.inflight_done(tid))
            done += 1
        for i in range(n_hb):
            w = (k * n_hb + i) % W
            if w not in silenced:
                rs.heartbeat(b"w%d" % w)
        for _ in range(n_churn - min(queued_hedges[0], n_churn)):
            tid = f"new-{n_new}"
            n_new += 1
            sizes[tid] = float(rng.uniform(0.1, 10.0))
            prios[tid] = int(rng.integers(0, 4))
            rs.pending_add(tid, sizes[tid], prios[tid], tag(tid))
        queued_hedges[0] = 0
        if k == silence_tick:
            expected_purge = set(silenced)
            expected_redispatch = {
                int(s) for s in np.flatnonzero(
                    np.isin(rs.inflight_worker, list(silenced)))
            }
            tick_of_purge = k
        before = n_launches()
        torch.cuda.set_sync_debug_mode("error")
        t0 = time.perf_counter()
        try:
            rs.tick_resident()
            t1 = time.perf_counter()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        n_launch = n_launches() - before
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
            if sinkhorn:
                c = replay_sinkhorn(rs)
                b = c["bad"]
                stats["max_abs_err"] = max(stats["max_abs_err"], c["dg"])
                stats["max_df"] = max(stats["max_df"], c["df"])
                stats["differs"] += c["differs"]
                stats["scale"] = max(stats["scale"], c["scale"])
            else:
                b, e = replay_plain(rs, rs.launch_log[0][2])
                stats["max_abs_err"] = max(stats["max_abs_err"], e)
            stats["mismatches"] += b
            assert b == 0, f"tick {k}: kernel != plain version ({placement})"
            pkt, _, pre, out = rs.launch_log[-1]
            if tenancy:
                over = tenancy_violations(out[0], rs._r_state.tenant, pkt)
                stats["over_allowance"] += over
                assert not over, f"tick {k}: {over} tenancy violations"
            if spec:
                on = spec_violations(out[0], rs._r_state.avoid)
                stats["on_avoid"] += on
                assert not on, f"tick {k}: {on} tasks on their avoid row"
            if auction:
                cold = bool(pre.refresh)
                stats["cold_ticks" if cold else "warm_ticks"] += 1
                stats["rounds"].append(int(out[0].auction_rounds))
                stats["spilled"].append(int(out[0].auction_spilled))
                stats["bid_rows"].append(int(out[0].auction_bid_rows))
            if n_launch == 1 and k >= n_ticks - timed_ticks:
                # the last steady ticks' packets and input states, for
                # timing the kernel alone on the main path's own data
                samples.append((torch.from_numpy(pkt).to(dev), pre,
                                stats["bid_rows"][-1] if auction else None))
        while len(rs._unresolved) > 1:  # stay two ticks deep
            resolve_one()
    while rs._unresolved:
        resolve_one()
    assert tick_of_purge is not None and expected_purge is None, (
        "the silenced rows were never purged")
    launches = n_launches() - launches_at_start
    # nothing lost: every task is completed, in flight, or pending
    pending = set(rs.slot_task.values()) | {a.task_id for a in rs._arrivals}
    pending |= {a.task_id for a in rs._rejected}
    every = set(sizes)
    accounted = completed | set(inflight) | pending
    assert accounted == every, (
        f"lost {len(every - accounted)}, unknown {len(accounted - every)}")
    assert not (completed & set(inflight)) and not (completed & pending)
    assert not (set(inflight) & pending), "a task both in flight and pending"
    if auction:
        assert stats["cold_ticks"] and stats["warm_ticks"], (
            "the auction loop needs a cold (refresh) and a warm tick")
        log(f"  auction ticks: {stats['cold_ticks']} cold, "
            f"{stats['warm_ticks']} warm; rounds {stats['rounds']}; "
            f"spilled {stats['spilled']}; bidder rows over the rounds "
            f"{stats['bid_rows']}")
    if tenancy:
        by = stats["placed_by_tenant"]
        log(f"  tenancy: placements light {by[1]}, heavy {by[2]}, the other "
            f"{NT_HEADLINE - 2} rows {by.sum() - by[1] - by[2]}; no launch "
            f"placed a tenant past its allowance; deficits at the end "
            f"{np.round(rs.tenant_deficits(), 2).tolist()}")
    if spec:
        assert stats["hedges_placed"] > 0, "no hedge was placed"
        log(f"  speculation: {stats['flagged']} straggler slots reported on "
            f"{stats['flag_ticks']} ticks, {stats['hedges']} hedges "
            f"submitted, {stats['hedges_placed']} placed, none on its avoid "
            f"row; {N_STUCK} live rows never returned a result")
    if sinkhorn:
        log(f"  Sinkhorn ticks held to the contract: max |df|/tau "
            f"{stats['max_df']:.3e}, max |dg|/tau {stats['max_abs_err']:.3e} "
            f"(bound {SINKHORN_TOL:g}), largest finite |f|/tau or |g|/tau "
            f"{stats['scale']:.3f}; {stats['differs']} checked ticks "
            f"placed otherwise than the plain version's own potentials")
    log(f"phase resident ({placement}{', tenancy' if tenancy else ''}"
        f"{', speculation' if spec else ''}): "
        f"{n_ticks + timed_ticks} ticks, "
        f"{launches} kernel "
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
#: The bids' inner loop (csrc/bid_top2.cuh::warp_top2, 4 rows) as nvcc
#: compiles it (CUDA 12.8, sm_90a), counted in the SASS of the built
#: libraries (cuobjdump -sass): one pass sweeps BID_LOOP_CELLS cells (4 rows
#: x 1 slot). Per pass, by issue pipe, in kernel B2 (bid_top2_kernel) and
#: in B1's auction branch (fused_auction_kernel):
#:   ALU (integer add, logic, shift, compare, select, min/max):
#:     SHF.R.U32.HI 16, LOP3.LUT 12, FSETP 5, FSEL 4, FMNMX 4, ISETP 1, and
#:     B2 IADD3 3 + VIADD 4, B1 VIADD 1: B2 49, B1 43;
#:   FMA-heavy (integer multiply, and the moves nvcc spells with it):
#:     B2 IMAD 9, IMAD.MOV.U32 22, IMAD.X 3: 34; B1 IMAD 12,
#:     IMAD.MOV.U32 16, IMAD.WIDE 3: 31;
#:   FMA heavy or lite (float32): FMUL 12, FADD 8 = 20;
#:   XU (conversion): I2FP.F32.S32 4;
#:   besides 3 loads and a branch (B2), and a uniform and 3 constant loads
#:   (B1): 111 instructions in all in B2, 106 in B1. The bound takes the
#:   fewer of the two copies on each pipe and in all: the least the same
#:   work has compiled to.
BID_LOOP_CELLS = 4
BID_ALU, BID_IMAD, BID_F32, BID_CVT, BID_ALL = 43, 31, 20, 4, 106
#: instructions each pipe of an SM issues per clock on sm_90 (NVIDIA's
#: arithmetic instruction throughputs, compute capability 9.0): integer,
#: logic and compare 64; integer multiply 64, on the FMA-heavy half;
#: float32 add and multiply 128, on both halves; conversions 16; and any
#: instruction 128 (each of the 4 schedulers issues one warp's a clock)
ALU_PER_SM_CLOCK, IMAD_PER_SM_CLOCK = 64, 64
F32_PER_SM_CLOCK, CVT_PER_SM_CLOCK, ISSUE_PER_SM_CLOCK = 128, 16, 128


#: the pipe each SASS opcode of the bid loop issues to (its base name, the
#: text before the first dot); None: a load or branch unit
SASS_PIPE = {"IMAD": "FMA-heavy", "FMUL": "float32", "FADD": "float32",
             "FFMA": "float32", "I2FP": "conversion", "I2F": "conversion",
             "LDG": None, "LD": None, "LDC": None, "ULDC": None, "BRA": None}


def sass_loop_counts(lib, kernel: str) -> dict:
    """The bid loop of ``kernel`` in the built library ``lib``, counted
    from ``cuobjdump -sass``: the shortest loop (a backward branch and the
    code it jumps over) with four int->float conversions. Returns its
    instructions by pipe (``SASS_PIPE``, ALU for the rest) and by
    opcode."""
    import collections
    import os
    import re

    from tpu_faas_torch.build import nvcc_path

    tool = os.path.join(os.path.dirname(nvcc_path()), "cuobjdump")
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    funcs = text.split("Function : ")
    (body,) = [f for f in funcs[1:] if kernel in f.splitlines()[0]]
    code = []  # (address, opcode, branch target or None)
    for line in body.splitlines():
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
                      r"([A-Z][A-Z0-9_.]*)(?:\s+(0x[0-9a-f]+))?", line)
        if m:
            target = int(m[3], 16) if m[2].startswith("BRA") and m[3] else None
            code.append((int(m[1], 16), m[2], target))
    loops = []
    for at, op, target in code:
        if target is not None and target < at:
            ops = [o for a, o, _ in code if target <= a <= at]
            if sum(o.startswith("I2F") for o in ops) == 4:
                loops.append(ops)
    ops = min(loops, key=len)
    by_op = collections.Counter(ops)
    by_pipe = collections.Counter()
    for o, n in by_op.items():
        pipe = SASS_PIPE.get(o.split(".")[0], "ALU")
        if pipe:
            by_pipe[pipe] += n
    return {"pipes": dict(by_pipe), "ops": dict(by_op), "n": len(ops)}


def log_bid_loops() -> None:
    """Count the bid loop of B2 and of B1's auction branch in the built
    libraries and set them beside the bound's constants."""
    from tpu_faas_torch.build import library_path

    counts = []
    for lib, kernel in (("bid_top2", "bid_top2_kernel"),
                        ("fused_tick", "fused_auction_kernel")):
        c = sass_loop_counts(library_path(lib), kernel)
        counts.append(dict(c["pipes"], all=c["n"]))
        log(f"  SASS of {kernel}'s bid loop ({c['n']} instructions per "
            f"{BID_LOOP_CELLS} cells): by pipe {c['pipes']}; by opcode "
            f"{c['ops']}")
    least = {p: min(c.get(p, 0) for c in counts)
             for p in ("ALU", "FMA-heavy", "float32", "conversion", "all")}
    want = {"ALU": BID_ALU, "FMA-heavy": BID_IMAD, "float32": BID_F32,
            "conversion": BID_CVT, "all": BID_ALL}
    log(f"  the fewer of the two per pipe {least}; the bound's constants "
        f"{want}" + ("" if least == want else
                      " -- they differ: recount the constants"))


def bid_cell_clocks() -> tuple[float, str]:
    """SM clocks per (row, slot) cell of the bids on the pipe that binds,
    and its name: the ALU's, the FMA pipes' (IMAD on the heavy half alone,
    float32 on either), the conversion's, or the schedulers' issue of
    every instruction."""
    per = {
        "ALU": BID_ALU / ALU_PER_SM_CLOCK,
        "FMA": max(BID_IMAD / IMAD_PER_SM_CLOCK,
                   (BID_IMAD + BID_F32) / F32_PER_SM_CLOCK),
        "conversion": BID_CVT / CVT_PER_SM_CLOCK,
        "issue": BID_ALL / ISSUE_PER_SM_CLOCK,
    }
    pipe = max(per, key=per.get)
    return per[pipe] / BID_LOOP_CELLS, pipe


def bid_pipe_text(clock_hz: float) -> str:
    clocks, pipe = bid_cell_clocks()
    return (f"{clocks:.4f} SM clocks a cell on the {pipe} pipe "
            f"({BID_ALL} instructions per {BID_LOOP_CELLS} cells: {BID_ALU} "
            f"ALU, {BID_IMAD} IMAD, {BID_F32} float32, {BID_CVT} "
            f"conversions), "
            f"{torch.cuda.get_device_properties(0).multi_processor_count} "
            f"SMs at {clock_hz / 1e9:.3f} GHz")


def bid_cells_ms(cells: int, clock_hz: float) -> float:
    """The least time for ``cells`` bid cells spread over every SM at
    ``clock_hz``, on the pipe that binds."""
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    return cells * bid_cell_clocks()[0] / (n_sm * clock_hz) * 1e3


def bid_inputs(dev, T: int, S: int, seed: int, frac_valid: float = 1.0):
    """Config 7's bid inputs: lognormal sizes, inv_speed U(0.25, 2), price
    U(0, 1)."""
    rng = np.random.default_rng(seed)
    valid = (rng.random(S) < frac_valid) if frac_valid < 1 else np.ones(S)
    return [torch.from_numpy(a.astype(np.float32)).to(dev) for a in (
        rng.lognormal(0.0, 1.0, T), rng.uniform(0.25, 2.0, S),
        valid, rng.uniform(0.0, 1.0, S))]


def bid_bound_ms(T: int, S: int, clock_hz: float) -> tuple[float, str]:
    """The least time for one bid: the larger of its cells' instructions
    on the pipe that binds (``bid_cell_clocks``) and its bytes (inputs
    once, outputs once) at the HBM rate."""
    ops_ms = bid_cells_ms(T * S, clock_hz)
    bytes_ms = (4 * T + 12 * S + 12 * T) / HBM_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms,
                                                              "bytes")


def bid_nan_cases(dev) -> list:
    """ROADMAP C.3's inputs for B2: a NaN size on some rows, a NaN speed on
    one valid slot, a NaN price on two valid slots, a NaN jitter, and an
    infinite product against an infinite price (inf - inf), each at the
    headline's slot count and beside finite rows."""
    T, S = 4096, BID_HEADLINE[1]
    cases = []
    for name in ("NaN size", "NaN speed on one valid slot", "NaN price",
                 "NaN jitter", "inf - inf"):
        ts, inv, valid, price = bid_inputs(dev, T, S, 70 + len(cases), 0.9)
        js = 1e-4
        slot = 20_011
        valid[slot] = 1.0
        if name == "NaN size":
            ts[[3, 999, 1000, T - 1]] = float("nan")
        elif name == "NaN speed on one valid slot":
            inv[slot] = float("nan")
        elif name == "NaN price":
            price[[slot, S - 1]] = float("nan")
            valid[S - 1] = 1.0
        elif name == "NaN jitter":
            js = float("nan")
        else:
            ts[[5, 6]] = float("-inf")
            price[slot] = float("inf")
        cases.append((f"C.3 {name}", [ts, inv, valid, price], js, {}))
    return cases


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
    cases += bid_nan_cases(dev)
    mismatches = 0
    for name, args, js, kw in cases:
        js = float(np.float32(js))
        got = KERNEL(*args, js, **kw)
        want = bid_top2_stream_impl(*args, js, **kw)
        torch.cuda.synchronize()
        # a NaN equals a NaN in the same place (C.3's cases)
        bad = [f for f, a, b in zip(("v1", "best", "v2"), got, want)
               if not same(a, b)]
        if name.startswith("C.3"):
            nan_v1 = int(torch.isnan(got[0]).sum())
            bits = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                       for a, b in zip(got[0::2], want[0::2]))
            log(f"  {name}: rows with v1 NaN {nan_v1}, with v2 NaN "
                f"{int(torch.isnan(got[2]).sum())}, float bits "
                f"{'equal' if bits else 'differ in a NaN payload'}")
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
            bad += [f for f in ("auction_rounds", "auction_bid_rows")
                    if getattr(out, f) != getattr(ref, f)]
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


# -- phase 6: the resident auction (B1's auction branch) ---------------------
def auction_bound_ms(bid_rows: int, packet: torch.Tensor,
                     clock_hz: float) -> tuple[float, str]:
    """The least time for one resident auction tick: the larger of the
    bids' instructions on the pipe that binds (``bid_cell_clocks``) over
    the (bidder, slot) cells this tick's rounds needed (``bid_rows``, the
    bidders summed over the rounds, times S), and its bytes at the HBM
    rate: the rank tick's, plus the carried prices read and written, the
    refresh flag and the aux counts."""
    S = SHAPE["W"] * MAX_SLOTS
    ops_ms = bid_cells_ms(bid_rows * S, clock_hz)
    bytes_ms = (bound_ms(False, packet)
                + (8 * S + 2 + 12) / HBM_BYTES_PER_S * 1e3)
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms,
                                                              "bytes")


def auction_case(seed: int, use_priority: bool, refresh: bool):
    """``random_case``'s state and packet, with carried prices k/16 and the
    refresh flag set as asked."""
    rng = np.random.default_rng(seed)
    leaves, pkt = random_case(rng, use_priority, now=100.0)
    S = SHAPE["W"] * MAX_SLOTS
    leaves["price"] = (rng.integers(0, 64, S) / 16).astype(np.float32)
    leaves["refresh"] = np.asarray(refresh)
    return leaves, pkt


def compare_auction_tick(dev, leaves, pkt, use_priority: bool, label: str,
                         plain_twin: bool, tenancy: bool = False,
                         spec: bool = False, nt: int = NT_HEADLINE):
    """The auction kernel against its plain version from the same state,
    and (``plain_twin``) against the plain version with plain bids:
    (mismatched fields and tenancy or avoid-row violations, max abs error,
    rounds, spilled, bidder rows). ``tenancy``, ``spec``: the packet
    carries that lane (``nt`` tenant rows)."""
    from tpu_faas_torch.sched.fused_tick import KERNEL
    from tpu_faas_torch.sched.resident import (
        _resident_tick_impl, state_from_numpy,
    )

    kw = dict(SHAPE, max_slots=MAX_SLOTS, use_priority=use_priority,
              **(dict(use_tenancy=True, NT=nt) if tenancy else {}),
              **(SPEC_KW if spec else {}))
    st_k = state_from_numpy(leaves, dev)
    packet = torch.from_numpy(pkt).to(dev)
    ptrs = [t.data_ptr() for t in st_k]
    res_k, new_k = KERNEL.auction(packet, st_k, **kw)
    torch.cuda.synchronize()
    assert [t.data_ptr() for t in new_k] == ptrs, "state moved"
    bad, err = 0, 0.0
    twins = [("B2 bids", None)] + ([("plain bids", plain_bids)]
                                   if plain_twin else [])
    for twin, bids in twins:
        if bids is None:
            res_p, new_p = _resident_tick_impl(
                packet, state_from_numpy(leaves, dev), placement="auction",
                **kw)
        else:
            with bids():
                res_p, new_p = _resident_tick_impl(
                    packet, state_from_numpy(leaves, dev),
                    placement="auction", **kw)
        b1, e1 = compare(res_k, res_p, f"{label} vs {twin}: out")
        b2, e2 = compare(new_k, new_p, f"{label} vs {twin}: state")
        bad, err = bad + b1 + b2, max(err, e1, e2)
    if tenancy:
        bad += tenancy_violations(res_k, new_k.tenant, pkt, nt)
    if spec:
        bad += spec_violations(res_k, new_k.avoid)
    return (bad, err, int(res_k.auction_rounds), int(res_k.auction_spilled),
            int(res_k.auction_bid_rows))


def few_bidder_case(seed: int):
    """A warm tick with few bidders: ``auction_case``'s state with carried
    prices, 13 free slots on live rows and 14 valid tasks (one slot short),
    and a packet with no deltas, so every round has at most 13 bidders."""
    leaves, pkt = auction_case(seed, False, refresh=False)
    rng = np.random.default_rng(100 + seed)
    T, W = SHAPE["T"], SHAPE["W"]
    now, tte = np.float32(pkt[0]), np.float32(pkt[8])
    live = np.flatnonzero(leaves["active"]
                          & (now - leaves["last_hb"] <= tte))
    free = np.zeros(W, np.int32)
    free[rng.choice(live, 13, replace=False)] = 1
    valid = np.zeros(T, bool)
    valid[rng.choice(T, 14, replace=False)] = True
    pkt = pkt.copy()
    pkt[1:7] = 0
    return dict(leaves, free=free, valid=valid), pkt


def all_bid_case(seed: int):
    """A cold tick in which every admitted task bids: ``auction_case``'s
    state from the seed (refresh set), every task valid and every row's
    slots free, and a packet with no deltas, so the first round's bidders
    are as many as the live rows' slots."""
    leaves, pkt = auction_case(seed, False, refresh=True)
    pkt = pkt.copy()
    pkt[1:7] = 0
    return dict(leaves, free=np.full(SHAPE["W"], MAX_SLOTS, np.int32),
                valid=np.ones(SHAPE["T"], bool)), pkt


def nan_auction_cases():
    """ROADMAP C.3's inputs for B1's auction branch, on ``auction_case``'s
    states: NaN sizes in the state and the arrival lane (cold and warm), a
    NaN speed on live rows with free slots, and NaN carried prices (warm)."""
    out = []
    for label, refresh in (("C.3 NaN sizes, cold", True),
                           ("C.3 NaN sizes, warm", False),
                           ("C.3 NaN speeds", True),
                           ("C.3 NaN prices, warm", False)):
        leaves, pkt = auction_case(40 + len(out), False, refresh)
        rng = np.random.default_rng(50 + len(out))
        leaves = dict(leaves)
        if "sizes" in label:
            sizes = leaves["sizes"].copy()
            sizes[rng.choice(SHAPE["T"], 64, replace=False)] = np.nan
            leaves["sizes"] = sizes
            pkt = pkt.copy()
            pkt[9 + rng.choice(int(pkt[1]), 8, replace=False)] = np.nan
        elif "speeds" in label:
            speed = leaves["speed"].copy()
            rows = rng.choice(SHAPE["W"], 3, replace=False)
            speed[rows] = np.nan
            free = leaves["free"].copy()
            free[rows] = MAX_SLOTS
            leaves.update(speed=speed, free=free,
                          active=leaves["active"] | np.isin(
                              np.arange(SHAPE["W"]), rows))
        else:
            price = leaves["price"].copy()
            price[rng.choice(price.size, 16, replace=False)] = np.nan
            leaves["price"] = price
        out.append((label, (leaves, pkt)))
    return out


def phase_auction_kernel(dev, probe) -> dict:
    """B1's auction branch against its plain version on the card, at the
    headline shape: refresh on and off, priority lanes on and off, two
    seeds; a warm tick with few bidders and a cold tick in which every
    admitted task bids; every output and state leaf exactly equal, round
    and spilled counts included. Seed 0 is also held against the plain
    version with plain bids. The few-bidder and every-bidder ticks are also
    run once on ``probe`` (the probe build) for their round split."""
    from tpu_faas_torch.sched.resident import state_from_numpy

    mismatches, max_err, cases = 0, 0.0, 0
    for refresh in (True, False):
        for use_priority in (False, True):
            for seed in (0, 1):
                leaves, pkt = auction_case(seed, use_priority, refresh)
                label = f"refresh={refresh} prio={use_priority} seed={seed}"
                # the plain-bid twin costs up to 64 plain sweeps of 1.7e9
                # cells: seed 0 only
                b, e, rounds, spilled, bid_rows = compare_auction_tick(
                    dev, leaves, pkt, use_priority, label,
                    plain_twin=seed == 0)
                log(f"  {label}: rounds {rounds}, spilled {spilled}, bidder "
                    f"rows {bid_rows}, mismatched fields {b}")
                mismatches += b
                max_err = max(max_err, e)
                cases += 1
    for label, (leaves, pkt) in nan_auction_cases():
        # C.3: each bid's NaN cells take JAX's rule in the kernel too
        b, e, rounds, spilled, bid_rows = compare_auction_tick(
            dev, leaves, pkt, False, label, plain_twin=label.endswith(
                "NaN sizes, cold"))
        log(f"  {label}: rounds {rounds}, spilled {spilled}, bidder rows "
            f"{bid_rows}, mismatched fields {b}")
        mismatches += b
        max_err = max(max_err, e)
        cases += 1
    for label, (leaves, pkt) in (("few bidders", few_bidder_case(3)),
                                 ("every task bids", all_bid_case(4))):
        b, e, rounds, spilled, bid_rows = compare_auction_tick(
            dev, leaves, pkt, False, label, plain_twin=False)
        packet = torch.from_numpy(pkt).to(dev)
        sp, bp = auction_split(dev, probe, packet,
                               state_from_numpy(leaves, dev))
        log(f"  {label}: rounds {rounds}, spilled {spilled}, bidder rows "
            f"{bid_rows}, mismatched fields {b + bp}; split (probe build, "
            f"block 0's clock): {split_text(sp)}; rounds (bidders: bids us) "
            f"{rounds_text(sp)}")
        mismatches += b + bp
        max_err = max(max_err, e)
        cases += 1
    if mismatches:
        raise SystemExit(f"the auction kernel disagrees with its plain "
                         f"version: {mismatches} mismatched fields")
    log(f"phase auction kernel: {cases} ticks exactly equal")
    return {"mismatches": 0, "max_abs_err": max_err}


def auction_split(dev, probe, packet, pre) -> tuple[dict, int]:
    """One launch of the probe build from ``pre`` (left untouched), beside
    one of the kernel proper: (the probe's split, fields that differ
    between the two launches)."""
    from tpu_faas_torch.sched.fused_tick import KERNEL

    kw = dict(SHAPE, max_slots=MAX_SLOTS, use_priority=False)
    res_k, st_k = KERNEL.auction(packet, clone_state(pre), **kw)
    res_p, st_p = probe.auction(packet, clone_state(pre), **kw)
    sp = probe.auction_split(dev, SHAPE["T"], SHAPE["W"], MAX_SLOTS)
    b1, _ = compare(res_p, res_k, "probe build: out")
    b2, _ = compare(st_p, st_k, "probe build: state")
    return sp, b1 + b2


def resident_auction_split(dev, probe, samples: list) -> dict:
    """The round split on the resident auction loop's own states: one
    launch of the probe build each, beside the kernel proper; then each
    round's parts averaged over every round of those launches, and the bid
    time of the rounds grouped by their bidders."""
    splits, bad = [], 0
    for i, (packet, pre, _) in enumerate(samples):
        sp, b = auction_split(dev, probe, packet, pre)
        bad += b
        splits.append(sp)
        log(f"  state {i} ({'cold' if bool(pre.refresh) else 'warm'}): "
            f"{split_text(sp)}")
        log(f"    rounds (bidders: bids us) {rounds_text(sp)}")
    rounds = [r for sp in splits for r in sp["rounds"]]
    means = [statistics.mean(r[i] for r in rounds) * 1e3 for i in range(1, 5)]
    log(f"  per round, means over the {len(rounds)} rounds of the "
        f"{len(splits)} states: bids {means[0]:.2f} us, their barrier "
        f"{means[1]:.2f} us, install+barrier {means[2]:.2f} us, "
        f"collection+barrier {means[3]:.2f} us")
    for lo, hi in ((1, 32), (33, 256), (257, 1024), (1025, 1 << 30)):
        sel = [r[1] * 1e3 for r in rounds if lo <= r[0] <= hi]
        if sel:
            log(f"  rounds with {lo}-{min(hi, SHAPE['T'])} bidders: "
                f"{len(sel)}, bids {statistics.mean(sel):.2f} us mean "
                f"(min {min(sel):.2f}, max {max(sel):.2f})")
    return {"mismatches": bad, "splits": splits, "round_means_us": means}


def split_text(sp: dict) -> str:
    """A split with its rounds summed: bids, their barriers, installs and
    collections (each with its barrier)."""
    bids, bar, inst, coll = (sum(r[i] for r in sp["rounds"])
                             for i in range(1, 5))
    return (f"opening {sp['open']:.4f} ms + seed/rebase {sp['seed']:.4f} ms "
            f"+ first barrier {sp['start']:.4f} ms; {len(sp['rounds'])} "
            f"rounds: bids {bids:.4f} ms, their barriers {bar:.4f} ms, "
            f"install+barrier {inst:.4f} ms, collection+barrier {coll:.4f} "
            f"ms; close {sp['close']:.4f} ms, fixup/deficit/compaction "
            f"{sp['end']:.4f} ms; launch {sp['total']:.4f} ms")


def rounds_text(sp: dict) -> str:
    return " ".join(f"{n}:{b * 1e3:.1f}" for n, b, *_ in sp["rounds"])


def time_resident_auction(dev, samples: list) -> dict:
    """The auction kernel per tick on the resident auction loop's own
    states, beside its bound and its plain version on the card, each state
    timed once by each. The plain version bids with the plain top-2, and
    each of its ticks is also held exactly against the kernel's from the
    same state: the comparison on the loop's states that shares no code
    with the kernel. The plain tick with B2's bids is context. Warm and
    cold ticks differ forty-fold in their bidders, so the entry's numbers
    are means over the same states, and each kind's medians are logged."""
    from tpu_faas_torch.sched.fused_tick import KERNEL
    from tpu_faas_torch.sched.resident import _resident_tick_impl

    kw = dict(SHAPE, max_slots=MAX_SLOTS, use_priority=False)
    n = len(samples)
    order = iter(range(10**9))

    def next_sample():
        packet, pre, _ = samples[next(order) % n]
        return packet, clone_state(pre)

    def plain(a):
        return _resident_tick_impl(a[0], a[1], placement="auction", **kw)

    # n consecutive timed calls after 3 warm-ups: every state once; the
    # kernel's timed call j ran state (j + 3) % n
    k_ms = event_ms(lambda a: KERNEL.auction(a[0], a[1], **kw), n,
                    setup=next_sample)
    k_of = {(j + 3) % n: t for j, t in enumerate(k_ms)}
    b2_ms = event_ms(plain, n, setup=next_sample)
    bad, err, p_ms = 0, 0.0, []
    for i, (packet, pre, _) in enumerate(samples):
        res_k, st_k = KERNEL.auction(packet, clone_state(pre), **kw)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        with plain_bids():
            a.record()
            res_p, st_p = plain((packet, clone_state(pre)))
            b.record()
        torch.cuda.synchronize()
        p_ms.append(a.elapsed_time(b))
        b1, e1 = compare(res_k, res_p, f"loop state {i} vs plain bids: out")
        b2, e2 = compare(st_k, st_p, f"loop state {i} vs plain bids: state")
        bad, err = bad + b1 + b2, max(err, e1, e2)
    if bad:
        raise SystemExit(f"the auction kernel disagrees with its plain "
                         f"version with plain bids on the loop's states: "
                         f"{bad} mismatched fields")
    clock = sm_clock_hz()
    bounds = [auction_bound_ms(r, p.cpu(), clock) for p, _, r in samples]
    out = {"ms": statistics.mean(k_ms), "plain_ms": statistics.mean(p_ms),
           "bound_ms": statistics.mean(b for b, _ in bounds),
           "bound_by": statistics.mode(by for _, by in bounds),
           "mismatches": bad, "max_abs_err": err}
    for kind in ("warm", "cold"):
        idx = [i for i, (_, pre, _) in enumerate(samples)
               if bool(pre.refresh) == (kind == "cold")]
        if not idx:
            continue
        log(f"  {kind} states ({len(idx)}): bidder rows "
            f"{[samples[i][2] for i in idx]}; medians: kernel "
            f"{statistics.median(k_of[i] for i in idx):.4f} ms, bound "
            f"{statistics.median(bounds[i][0] for i in idx):.4f} ms, plain "
            f"version with plain bids "
            f"{statistics.median(p_ms[i] for i in idx):.1f} ms")
    every_row = bid_cells_ms(64 * SHAPE["T"] * SHAPE["W"] * MAX_SLOTS, clock)
    log(f"  auction kernel on the resident auction run's {n} states, means: "
        f"{out['ms']:.4f} ms (min {min(k_ms):.4f}, max {max(k_ms):.4f}); "
        f"bound {out['bound_ms']:.4f} ms ({out['bound_by']}: bidder rows x "
        f"{SHAPE['W'] * MAX_SLOTS} slots x {bid_pipe_text(clock)}), "
        f"kernel/bound "
        f"{out['ms'] / out['bound_ms']:.1f}; plain version with plain bids "
        f"{out['plain_ms']:.1f} ms, exactly equal on every state; plain "
        f"tick with B2's bids {statistics.mean(b2_ms):.4f} ms; were every "
        f"row to bid in 64 rounds, {every_row:.4f} ms")
    return out


# -- phase 7: the resident Sinkhorn tick (B1's Sinkhorn branch) -------------
#: contract (b): the largest |df|/tau and |dg|/tau allowed between the kernel's
#: final potentials and the plain version's from the same state (PERF.md)
SINKHORN_TOL = 1e-4
N_SINKHORN_TICKS = 40  # checked resident Sinkhorn ticks
N_SINKHORN_TIMED = 10  # timed resident Sinkhorn ticks
#: exps per SM per clock on the special function units (Hopper)
SFU_PER_SM_CLOCK = 16
#: the dense route's check: T*W = 2^24, so 60 iterations on [T+1, W+1]
DENSE_SHAPE = dict(SHAPE, T=4_096)


def potential_err(a: torch.Tensor, b: torch.Tensor, tau: float) -> float:
    """max |a - b| / tau over the finite entries; inf unless the non-finite
    entries are the same values in the same places."""
    fa, fb = torch.isfinite(a), torch.isfinite(b)
    if not torch.equal(fa, fb) or not torch.equal(a[~fa], b[~fb]):
        return float("inf")
    if not bool(fa.any()):
        return 0.0
    return float((a[fa].double() - b[fa].double()).abs().max()) / tau


def sinkhorn_legal(pre, res, new, K: int, KP: int,
                   spec_counts: tuple[int, int] | None = None) -> list[str]:
    """Contract (d) on one launch's outputs: no row over its capacity, no
    dead row, no task placed twice or placed without being pending, and
    the count placed = min(KP, valid tasks, total capacity). With the
    speculation lane (``spec_counts``: the tasks the main pass and the
    fixup placed in all, and the vetoed tasks the fixup left queued): a
    row's capacity is the fixup's, its raw free count; no task lands on
    its avoid row; and the count placed = min(KP, the main pass's count
    less the vetoed tasks left queued), the main pass's count being
    min(valid tasks, total capacity)."""
    W = new.free.shape[0]
    ok = res.placed_slots >= 0
    slots = res.placed_slots[ok].long()
    rows = res.placed_rows[ok].long()
    per_row = torch.bincount(rows, minlength=W).to(torch.int32)
    free_before = new.free + per_row  # the tick took one slot per placement
    cap = torch.where(res.live, free_before.clamp(max=K), 0).clamp_min(0)
    raw = torch.where(res.live, free_before, 0).clamp_min(0)
    n = int(ok.sum())
    pending = pre.valid.clone()
    arr = res.arrival_slots[res.arrival_slots >= 0].long()
    pending[arr] = True
    bad = []
    if bool((per_row > (cap if spec_counts is None else raw)).any()):
        bad.append("a row over its capacity")
    if not bool(res.live[rows].all()):
        bad.append("a dead row placed")
    if slots.unique().numel() != n:
        bad.append("a task placed twice")
    if not bool(pending[slots].all()) or bool(new.valid[slots].any()):
        bad.append("a placed task that was not pending")
    valid = n + int(res.n_pending)
    if res.tenant_eligible is not None:  # tenancy: placement's valid set
        valid = int(res.tenant_eligible.sum())
        if not bool(res.tenant_eligible[slots].all()):
            bad.append("a placed task that was not eligible")
    if spec_counts is None:
        if n != min(KP, valid, int(cap.sum())):
            bad.append("placed != min(KP, valid, capacity)")
        return bad
    total, left = spec_counts
    if bool((new.avoid[slots] == rows).any()):
        bad.append("a task placed on its avoid row")
    if n != min(KP, total) or total != min(valid, int(cap.sum())) - left:
        bad.append("placed != min(KP, valid, capacity) - vetoed left queued")
    return bad


def spec_fixup_counts(pre, packet, res_k, avoid, kw: dict) -> tuple[int,
                                                                    int]:
    """For contract (d) with the speculation lane: the kernel's main-pass
    assignment, as the plain rounding takes it from the kernel's own
    potentials with no avoid row anywhere and every placement reported;
    then the plain fixup on it, with ``avoid`` the avoid leaf after the
    packet. Returns (tasks placed in all, vetoed tasks left queued)."""
    from tpu_faas_torch.sched.resident import _resident_tick_impl
    from tpu_faas_torch.spec.straggler import hedge_fixup_impl

    T = kw["T"]
    lanes = 1 + int(kw["use_priority"]) + int(kw.get("use_tenancy", False))
    at = 9 + kw["KA"] * lanes  # the arrivals' avoid lane
    pk = packet.clone()
    pk[at : at + kw["KA"]] = -1.0
    st0 = clone_state(pre)
    st0.avoid.fill_(-1)
    res0, new0 = _resident_tick_impl(
        pk, st0, placement="sinkhorn",
        sinkhorn_potentials=(res_k.sinkhorn_f, res_k.sinkhorn_g),
        **dict(kw, KP=T))
    ok = res0.placed_slots >= 0
    a0 = torch.full((T,), -1, dtype=torch.int32, device=packet.device)
    a0[res0.placed_slots[ok].long()] = res0.placed_rows[ok]
    free = new0.free + torch.bincount(
        res0.placed_rows[ok].long(), minlength=kw["W"]).to(torch.int32)
    a1 = hedge_fixup_impl(a0, avoid, new0.speed, free, res0.live)
    vetoed = (avoid >= 0) & (a0 == avoid)
    return int((a1 >= 0).sum()), int((vetoed & (a1 < 0)).sum())


def sinkhorn_check(pre, packet, res_k, new_k, kw: dict, label: str) -> dict:
    """One Sinkhorn launch from its pre-state against the contract:
    (a) exact on every output and state leaf that placement does not
    decide, the count placed and the effective temperature; (b) potentials
    within SINKHORN_TOL of the plain version's; (c) the plain version's
    rounding from the kernel's own potentials reproduces every output and
    state leaf exactly; (d) legal. Also whether the placements differ from
    the plain version's own (reported, not failed)."""
    from tpu_faas_torch.sched.resident import _resident_tick_impl

    res_p, new_p = _resident_tick_impl(packet, clone_state(pre),
                                       placement="sinkhorn", **kw)
    res_r, new_r = _resident_tick_impl(
        packet, clone_state(pre), placement="sinkhorn",
        sinkhorn_potentials=(res_k.sinkhorn_f, res_k.sinkhorn_g), **kw)
    bad = []
    differs = not (torch.equal(res_k.placed_slots, res_p.placed_slots)
                   and torch.equal(res_k.placed_rows, res_p.placed_rows))
    for f in ("arrival_slots", "redispatch_slots", "purged", "live",
              "n_pending", "straggler_slots", "sinkhorn_tau",
              "tenant_eligible"):
        a, b = getattr(res_k, f), getattr(res_p, f)
        if (a is None) != (b is None) or (a is not None
                                          and not torch.equal(a, b)):
            bad.append(f"(a) {f}")
    if int((res_k.placed_slots >= 0).sum()) != int(
            (res_p.placed_slots >= 0).sum()):
        bad.append("(a) placed count")
    # the deficit carry follows the per-tenant placements: exact in (a)
    # whenever they are the plain version's own, and always in (c)
    decided = ("valid", "free") + (("t_deficit",) if differs else ())
    for f in new_k._fields:
        if f not in decided and not same(getattr(new_k, f),
                                         getattr(new_p, f)):
            bad.append(f"(a) state.{f}")
    tau = float(res_k.sinkhorn_tau)
    df = potential_err(res_k.sinkhorn_f, res_p.sinkhorn_f, tau)
    dg = potential_err(res_k.sinkhorn_g, res_p.sinkhorn_g, tau)
    if not (df <= SINKHORN_TOL and dg <= SINKHORN_TOL):
        bad.append(f"(b) potentials: |df|/tau {df:.3e}, |dg|/tau {dg:.3e}")
    b1, _ = compare(res_k, res_r, f"{label} replay: out")
    b2, _ = compare(new_k, new_r, f"{label} replay: state")
    if b1 + b2:
        bad.append(f"(c) {b1 + b2} fields of the replay")
    counts = (spec_fixup_counts(pre, packet, res_k, new_p.avoid, kw)
              if kw.get("use_spec") else None)
    bad += [f"(d) {x}" for x in sinkhorn_legal(pre, res_k, new_k,
                                                kw["max_slots"], kw["KP"],
                                                counts)]
    for x in bad:
        log(f"  MISMATCH {label}: {x}")
    pot = torch.cat([res_k.sinkhorn_f, res_k.sinkhorn_g])
    scale = float(pot[torch.isfinite(pot)].abs().max()) / tau
    return {"bad": len(bad), "df": df, "dg": dg, "differs": int(differs),
            "placed": int((res_k.placed_slots >= 0).sum()), "scale": scale}


def replay_sinkhorn(rs) -> dict:
    """The last resident tick's launches, each from its own pre-state: an
    overflow flush exactly against the plain flush, the Sinkhorn tick
    against the contract (``sinkhorn_check``)."""
    from tpu_faas_torch.sched.resident import _flush_kernel_impl

    kw = dict(rs._statics(), KP=rs.KP, KR=rs.KR, max_slots=rs.max_slots)
    out = {"bad": 0, "df": 0.0, "dg": 0.0, "differs": 0, "scale": 0.0}
    n = len(rs.launch_log)
    for i, (pkt, flush, pre, res) in enumerate(rs.launch_log):
        packet = torch.from_numpy(pkt).to(rs.device)
        post = rs.launch_log[i + 1][2] if i + 1 < n else rs._r_state
        if flush:
            st, arr = _flush_kernel_impl(packet, clone_state(pre),
                                         **rs._statics())
            b, _ = compare(post, st, "flush-state")
            out["bad"] += b + (0 if torch.equal(arr, res[1]) else 1)
            continue
        c = sinkhorn_check(pre, packet, res[0], post, kw, "loop tick")
        out["bad"] += c["bad"]
        out["differs"] += c["differs"]
        out["df"] = max(out["df"], c["df"])
        out["dg"] = max(out["dg"], c["dg"])
        out["scale"] = max(out["scale"], c["scale"])
    return out


def check_math(dev) -> int:
    """expf and logf as the Sinkhorn branch compiles them, bit for bit
    against torch.exp and torch.log on the card, over 2^22 values: lognormal
    sizes and the ranges the iterations take (-cost/tau in [-40, 0], shifts
    around 0). Returns the values that differ."""
    from tpu_faas_torch.sched.fused_tick import KERNEL

    rng = np.random.default_rng(11)
    n = 1 << 20
    x = np.concatenate([
        rng.lognormal(0.0, 3.0, n), rng.uniform(-40.0, 0.0, n),
        rng.uniform(-1.0, 1.0, n), rng.uniform(1e-30, 60_000.0, n),
    ]).astype(np.float32)
    xt = torch.from_numpy(x).to(dev)
    e, lg = KERNEL.math_probe(xt)
    want_e, want_l = torch.exp(xt), torch.log(xt)
    same_e = (e == want_e) | (torch.isnan(e) & torch.isnan(want_e))
    same_l = (lg == want_l) | (torch.isnan(lg) & torch.isnan(want_l))
    bad = int((~same_e).sum()) + int((~same_l).sum())
    log(f"  expf/logf of the kernel against torch.exp/torch.log on the card: "
        f"{x.size} values each, {bad} differ")
    return bad


def phase_sinkhorn_kernel(dev, probe) -> dict:
    """B1's Sinkhorn branch against its plain version under the contract:
    synthetic headline states (bucketed route, priority lanes on and off,
    two seeds) and one dense-route state at 4,096 x 4,096; and the
    kernel's expf/logf against torch's."""
    from tpu_faas_torch.sched.fused_tick import KERNEL
    from tpu_faas_torch.sched.resident import state_from_numpy

    bad = check_math(dev)
    out = {"df": 0.0, "dg": 0.0, "differs": 0, "cases": 0}
    cases = [(SHAPE, prio, seed) for prio in (False, True) for seed in (0, 1)]
    cases.append((DENSE_SHAPE, False, 5))
    # a -inf speed on a live row with free slots and a -inf size on a valid
    # task sort among the invalid ones in rank placement, so the close's
    # spill takes rank placement's own sorts; on row 0 and task 0 they sort
    # first among those, so the placements stay legal (contract (d))
    cases.append((SHAPE, False, 6))
    for shape, use_priority, seed in cases:
        leaves, pkt = random_case(np.random.default_rng(seed), use_priority,
                                  now=100.0, shape=shape)
        if seed == 6:
            leaves["valid"][0], leaves["sizes"][0] = True, -np.inf
            leaves["speed"][0], leaves["free"][0] = -np.inf, 3
            leaves["active"][0], leaves["last_hb"][0] = True, 99.0
            # the packet's row lanes leave row 0 alone (index W: dropped)
            off = 9 + shape["KA"]
            for K, n in ((shape["KH"], pkt[2]), (shape["KF"], pkt[3]),
                         (shape["KI"], 0), (shape["KS"], pkt[5]),
                         (shape["KB"], pkt[6])):
                lane = pkt[off : off + int(n)]
                lane[lane == 0] = shape["W"]
                off += 2 * K
        kw = dict(shape, max_slots=MAX_SLOTS, use_priority=use_priority)
        pre = state_from_numpy(leaves, dev)
        packet = torch.from_numpy(pkt).to(dev)
        st = clone_state(pre)
        ptrs = [t.data_ptr() for t in st]
        res_k, new_k = KERNEL.sinkhorn(packet, st, **kw)
        torch.cuda.synchronize()
        assert [t.data_ptr() for t in new_k] == ptrs, "state moved"
        route = "dense" if shape is DENSE_SHAPE else "bucketed"
        label = f"{route} {shape['T']}x{shape['W']} prio={use_priority} " \
                f"seed={seed}" + (", a -inf size and speed" if seed == 6
                                  else "")
        phases = KERNEL.sinkhorn_phase_ms(dev, shape["T"], shape["W"],
                                          MAX_SLOTS)
        c = sinkhorn_check(pre, packet, res_k, new_k, kw, label)
        log(f"  {label}: placed {c['placed']}, |df|/tau {c['df']:.3e}, "
            f"|dg|/tau {c['dg']:.3e}, tau {float(res_k.sinkhorn_tau):.6g}, "
            f"largest |f|/tau or |g|/tau {c['scale']:.3f}, "
            f"contract violations {c['bad']}, placements "
            f"{'differ from' if c['differs'] else 'equal'} the plain "
            f"version's; phases {phase_text(phases)}")
        if shape is DENSE_SHAPE or seed in (0, 6):
            sp, b = sinkhorn_probe(dev, probe, packet, pre, kw)
            log(f"    split (probe build): {sinkhorn_split_text(sp)}; probe "
                f"fields differing from the kernel proper's {b}")
            bad += b
            if seed == 6 and not sp["rank_spill"]:
                log("  MISMATCH: the -inf state's spill kept its compacted "
                    "sorts")
                bad += 1
        bad += c["bad"]
        out["differs"] += c["differs"]
        out["df"] = max(out["df"], c["df"])
        out["dg"] = max(out["dg"], c["dg"])
        out["cases"] += 1
    if bad:
        raise SystemExit(f"the Sinkhorn kernel breaks its contract: {bad} "
                         f"violations")
    log(f"phase sinkhorn kernel: {out['cases']} ticks within the contract, "
        f"{out['differs']} placed otherwise than the plain version's own "
        f"potentials")
    out["mismatches"] = bad
    return out


def phase_sinkhorn_batch(dev) -> dict:
    """SchedulerArrays(placement="sinkhorn") on the card at BASELINE config
    4 (tpu_faas/bench/configs.py:296): seed 4, 50,000 lognormal tasks on
    4,000 workers with 1-8 free slots, padded to 51,200 x 4,096 — the
    batch tick's route (bucketed, 20 iterations, bucket rounding) — and
    config 4's own solve on the same inputs (bucketed, 60 iterations, exact
    rounding); each placement's makespan over the LP bound of its placed
    subset (BASELINE's target: 1.05), beside the host greedy's."""
    from tpu_faas_torch.sched.greedy import host_greedy_reference, makespan
    from tpu_faas_torch.sched.oracle import makespan_lower_bound
    from tpu_faas_torch.sched.sinkhorn import sinkhorn_placement_bucketed_impl
    from tpu_faas_torch.sched.state import SchedulerArrays

    rng = np.random.default_rng(4)
    n_tasks, n_workers, K = 50_000, 4_000, MAX_SLOTS
    T, W = SHAPE["T"], SHAPE["W"]
    sizes = rng.lognormal(0.0, 1.0, n_tasks).astype(np.float32)
    speeds = rng.uniform(0.5, 4.0, n_workers).astype(np.float32)
    free = rng.integers(1, K + 1, n_workers).astype(np.int32)
    live = np.ones(n_workers, dtype=bool)
    sa = SchedulerArrays(max_workers=W, max_pending=T, max_inflight=4096,
                         max_slots=K, clock=lambda: 1000.0,
                         placement="sinkhorn", device=dev)
    for i in range(n_workers):
        sa.register(b"w%d" % i, int(free[i]), speed=float(speeds[i]))

    def ratio(a):
        placed = a >= 0
        lb = makespan_lower_bound(sizes[placed], speeds, free, live, K)
        return makespan(a, sizes, speeds, K) / lb

    t0 = time.perf_counter()
    tick = sa.tick(sizes).assignment.cpu().numpy()[:n_tasks]
    wall_ms = (time.perf_counter() - t0) * 1e3
    padded = [torch.zeros(T, device=dev), torch.zeros(T, dtype=torch.bool,
                                                      device=dev),
              torch.zeros(W, device=dev),
              torch.zeros(W, dtype=torch.int32, device=dev),
              torch.zeros(W, dtype=torch.bool, device=dev)]
    for t, host in zip(padded, (sizes, np.ones(n_tasks, bool), speeds, free,
                                live)):
        t[: len(host)] = torch.from_numpy(host).to(dev)
    solve = sinkhorn_placement_bucketed_impl(
        *padded, tau=0.05, n_iters=60, max_slots=K,
    ).assignment.cpu().numpy()[:n_tasks]
    greedy = host_greedy_reference(sizes, speeds, np.minimum(free, K), live)
    cap = int(np.minimum(free, K).sum())
    for name, a in (("batch tick", tick), ("config 4 solve", solve)):
        check_assignment(a, np.ones(n_tasks, bool), np.minimum(free, K), live)
        assert int((a >= 0).sum()) == min(n_tasks, cap), name
    out = {"tick": ratio(tick), "solve": ratio(solve),
           "greedy": ratio(greedy), "wall_ms": wall_ms,
           "lb": makespan_lower_bound(sizes[tick >= 0], speeds, free, live,
                                      K)}
    log(f"phase sinkhorn batch (config 4: 50,000 tasks, 4,000 workers, "
        f"{cap} slots): makespan / LP bound {out['tick']:.4f} for the batch "
        f"tick (bucketed, 20 iterations, bucket rounding; first tick "
        f"{wall_ms:.1f} ms with the read back), {out['solve']:.4f} for "
        f"config 4's solve (60 iterations, exact rounding), host greedy "
        f"{out['greedy']:.4f}; the bound on the batch tick's subset "
        f"{out['lb']:.4f} s")
    return out


SINKHORN_PHASES = ("packet+liveness", "reductions", "setup", "iterations",
                   "candidates", "repair+spill", "compaction")


def phase_text(ms: list[float]) -> str:
    return ", ".join(f"{n} {t:.4f} ms" for n, t in zip(SINKHORN_PHASES, ms))


#: a logsumexp cell's work, counted from the plain expression (sinkhorn.py:
#: ``_logsumexp(negc + g/tau)``) with its row and column factors hoisted
#: out of the cell: the cell (one fma), the max, the shift, the exp and
#: the sum: 5 issue slots, one of them the exp on the SFU. The count does
#: not move with the kernel's code.
SK_CELL_ISSUE, SK_CELL_SFU = 5, 1


def sinkhorn_pipes_ms(clock_hz: float) -> dict:
    """The headline iterations' least time on each pipe: 2 x 20 x 1,025 x
    4,097 cells (one per cell of the [R, C] problem for f and for g in each
    of 20 iterations), their exps at the SFU's 16 a clock per SM and their
    issue slots at the schedulers' 128, on every SM at ``clock_hz``."""
    from tpu_faas_torch.sched.state import BUCKETED_ITERS, N_BUCKETS

    R, C = N_BUCKETS + 1, SHAPE["W"] + 1
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    cells = 2 * BUCKETED_ITERS * R * C
    per_s = n_sm * clock_hz / 1e3
    return {"cells": cells,
            "SFU": cells * SK_CELL_SFU / SFU_PER_SM_CLOCK / per_s,
            "issue": cells * SK_CELL_ISSUE / ISSUE_PER_SM_CLOCK / per_s}


def sinkhorn_bound_ms(packet: torch.Tensor, clock_hz: float) -> tuple[
        float, str]:
    """The least time for one headline Sinkhorn tick: the larger of the
    iterations' operations on the pipe that binds (``sinkhorn_pipes_ms``)
    and the rank tick's bytes plus the potentials written."""
    from tpu_faas_torch.sched.state import N_BUCKETS

    R, C = N_BUCKETS + 1, SHAPE["W"] + 1
    pipes = sinkhorn_pipes_ms(clock_hz)
    ops_ms = max(pipes["SFU"], pipes["issue"])
    bytes_ms = bound_ms(False, packet) + 4 * (R + C + 1) / HBM_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms,
                                                              "bytes")


def sinkhorn_library_ms(dev, samples: list) -> float:
    """The iterations' library yardstick (context only; the port never
    calls it): 20 iterations of torch.logsumexp over the materialized
    [1,025, 4,097] matrix of -cost/tau (16.8 MB), plus g/tau by rows and
    f/tau by columns, on the loop's first state; CUDA-event mean of one
    tick's 40 calls."""
    from tpu_faas_torch.sched.state import BUCKETED_ITERS, N_BUCKETS

    st = samples[0][1]
    R, C = N_BUCKETS + 1, SHAPE["W"] + 1
    rng = np.random.default_rng(3)
    rep = torch.exp(torch.linspace(-3.0, 3.0, R - 1, device=dev))
    inv = 1.0 / st.speed.clamp_min(1e-6)
    tau = float(0.05 * rep.max() * inv.max())
    negc = torch.full((R, C), float("-inf"), device=dev)
    negc[:-1, :-1] = -(rep[:, None] * inv[None, :]) / tau
    negc[:-1, -1] = -(float(rep.max() * inv.max()) + 1.0) / tau
    negc[-1, :-1] = 0.0
    g = torch.from_numpy(rng.uniform(-5, 5, C).astype(np.float32)).to(dev)
    f = torch.from_numpy(rng.uniform(-5, 5, R).astype(np.float32)).to(dev)

    def iterations(_):
        for _ in range(BUCKETED_ITERS):
            torch.logsumexp(negc + g[None, :], dim=1)
            torch.logsumexp(negc + f[:, None], dim=0)

    return statistics.mean(event_ms(iterations, 10))


def sm_clock_hz() -> float:
    """The card's maximum SM clock, from nvidia-smi."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def time_resident_sinkhorn(dev, samples: list, probe) -> dict:
    """The Sinkhorn kernel per tick on the resident Sinkhorn loop's own
    states (CUDA-event means), beside its bound and its plain version on
    the card, with the plain bucketed 20-iteration solve alone as
    context."""
    from tpu_faas_torch.sched.fused_tick import KERNEL
    from tpu_faas_torch.sched.resident import _resident_tick_impl
    from tpu_faas_torch.sched.sinkhorn import sinkhorn_placement_bucketed_impl

    kw = dict(SHAPE, max_slots=MAX_SLOTS, use_priority=False)
    n = len(samples)
    order = iter(range(10**9))

    def next_sample():
        packet, pre, _ = samples[next(order) % n]
        return packet, clone_state(pre)

    k_ms = event_ms(lambda a: KERNEL.sinkhorn(a[0], a[1], **kw), n,
                    setup=next_sample)
    p_ms = event_ms(lambda a: _resident_tick_impl(
        a[0], a[1], placement="sinkhorn", **kw), n, setup=next_sample)

    def solve(a):
        st = a[1]
        sinkhorn_placement_bucketed_impl(
            st.sizes, st.valid, st.speed, st.free, st.active,
            max_slots=MAX_SLOTS, n_iters=20, rounding="bucket")

    s_ms = event_ms(solve, n, setup=next_sample)
    # the split: block 0's clock at each phase of one launch per state, and
    # a grid barrier alone on the same grid
    phases = []
    for packet, pre, _ in samples:
        KERNEL.sinkhorn(packet, clone_state(pre), **kw)
        phases.append(KERNEL.sinkhorn_phase_ms(dev, SHAPE["T"], SHAPE["W"],
                                               MAX_SLOTS))
    split = [statistics.mean(p[i] for p in phases)
             for i in range(len(SINKHORN_PHASES))]
    n_bar = 400
    bar0 = statistics.median(event_ms(lambda _: KERNEL.barrier_probe(0), 10))
    bar1 = statistics.median(event_ms(lambda _: KERNEL.barrier_probe(n_bar),
                                      10))
    per_barrier = (bar1 - bar0) / n_bar
    clock = sm_clock_hz()
    bounds = [sinkhorn_bound_ms(p.cpu(), clock) for p, _, _ in samples]
    pipes = sinkhorn_pipes_ms(clock)
    lib_ms = sinkhorn_library_ms(dev, samples)
    out = {"ms": statistics.mean(k_ms), "plain_ms": statistics.mean(p_ms),
           "solve_ms": statistics.mean(s_ms), "split": split,
           "barrier_ms": per_barrier,
           "bound_ms": statistics.mean(b for b, _ in bounds),
           "bound_by": statistics.mode(by for _, by in bounds),
           "pipes": pipes, "library_iters_ms": lib_ms}
    pipe = max(("SFU", "issue"), key=pipes.get)
    log(f"  Sinkhorn kernel on the resident Sinkhorn run's {n} states, "
        f"means: {out['ms']:.4f} ms (min {min(k_ms):.4f}, max "
        f"{max(k_ms):.4f}); bound {out['bound_ms']:.4f} ms "
        f"({out['bound_by']}, the {pipe} pipe: {pipes['cells']} cells "
        f"(2 x 20 x 1,025 x 4,097), one exp each at {SFU_PER_SM_CLOCK} per "
        f"SM per clock {pipes['SFU']:.4f} ms, {SK_CELL_ISSUE} issue slots "
        f"each at {ISSUE_PER_SM_CLOCK} {pipes['issue']:.4f} ms; "
        f"{torch.cuda.get_device_properties(0).multi_processor_count} SMs "
        f"at {clock / 1e9:.3f} GHz), kernel/bound "
        f"{out['ms'] / out['bound_ms']:.1f}; plain version "
        f"{out['plain_ms']:.4f} ms; the plain bucketed 20-iteration solve "
        f"alone {out['solve_ms']:.4f} ms; the iterations' library "
        f"yardstick, 40 torch.logsumexp calls over the materialized "
        f"[1,025, 4,097] matrix: {lib_ms:.4f} ms")
    log(f"  its split (block 0's clock, means over the {n} states): "
        f"{phase_text(split)}; a grid barrier alone {per_barrier * 1e3:.3f} "
        f"us, so the iterations' 40 barriers {40 * per_barrier:.4f} ms and "
        f"their compute {split[3] - 40 * per_barrier:.4f} ms")
    out.update(resident_sinkhorn_split(dev, probe, samples))
    return out


def sinkhorn_probe(dev, probe, packet, pre, kw: dict) -> tuple[dict, int]:
    """One launch of the probe build from ``pre`` (left untouched), beside
    one of the kernel proper: (the probe's split, fields that differ
    between the two launches, potentials included)."""
    from tpu_faas_torch.sched.fused_tick import KERNEL

    res_k, st_k = KERNEL.sinkhorn(packet, clone_state(pre), **kw)
    res_p, st_p = probe.sinkhorn(packet, clone_state(pre), **kw)
    sp = probe.sinkhorn_split(dev, kw["T"], kw["W"], kw["max_slots"])
    b1, _ = compare(res_p, res_k, "probe build: out")
    b2, _ = compare(st_p, st_k, "probe build: state")
    return sp, b1 + b2


def sinkhorn_split_text(sp: dict) -> str:
    """A probe split with its iterations summed."""
    f, fb, g, gb = (sum(it[i] for it in sp["iters"]) for i in range(4))
    c = sp["close"]
    return (f"{len(sp['iters'])} iterations: f-updates {f:.4f} ms, their "
            f"barriers {fb:.4f} ms, g-updates {g:.4f} ms, their barriers "
            f"{gb:.4f} ms; close {c['total']:.4f} ms: candidates' keys "
            f"{c['keys']:.4f}, sorts {c['sort1']:.4f} + {c['sort2']:.4f}, "
            f"repair {c['repair']:.4f}, spill admission and slot sort "
            f"{c['slots']:.4f}, spill task sort and pairs {c['spill']:.4f} "
            f"ms; candidates {sp['candidates']}, "
            f"spilled {sp['spilled']}, spilled pairs placed {sp['pairs']}"
            + ("; the spill took rank placement's own sorts"
               if sp["rank_spill"] else ""))


def resident_sinkhorn_split(dev, probe, samples: list) -> dict:
    """The probe build's split on the resident Sinkhorn loop's own states,
    each launch beside the kernel proper's (exactly equal), and its means
    over them."""
    kw = dict(SHAPE, max_slots=MAX_SLOTS, use_priority=False)
    splits, bad = [], 0
    for i, (packet, pre, _) in enumerate(samples):
        sp, b = sinkhorn_probe(dev, probe, packet, pre, kw)
        bad += b
        splits.append(sp)
        log(f"  state {i}: {sinkhorn_split_text(sp)}")
    mean = {k: statistics.mean(sum(it[i] for it in sp["iters"])
                               for sp in splits)
            for i, k in enumerate(("f_ms", "f_bar_ms", "g_ms", "g_bar_ms"))}
    for k in ("keys", "sort1", "sort2", "repair", "slots", "spill", "total"):
        mean["close_" + k] = statistics.mean(sp["close"][k] for sp in splits)
    for k in ("candidates", "spilled", "pairs"):
        mean[k] = statistics.mean(sp[k] for sp in splits)
    log(f"  split means over the {len(splits)} states (probe build, block "
        f"0's clock): f-updates {mean['f_ms']:.4f} ms, barriers "
        f"{mean['f_bar_ms']:.4f} ms, g-updates {mean['g_ms']:.4f} ms, "
        f"barriers {mean['g_bar_ms']:.4f} ms; close {mean['close_total']:.4f}"
        f" ms (candidates' keys {mean['close_keys']:.4f}, sorts "
        f"{mean['close_sort1']:.4f} + {mean['close_sort2']:.4f}, repair "
        f"{mean['close_repair']:.4f}, spill admission and slot sort "
        f"{mean['close_slots']:.4f}, spill task sort and pairs "
        f"{mean['close_spill']:.4f}); "
        f"candidates {mean['candidates']:.1f}, spilled {mean['spilled']:.1f},"
        f" spilled pairs placed {mean['pairs']:.1f} a tick; probe launches "
        f"differing from the kernel proper's: {bad} fields")
    if bad:
        raise SystemExit(f"the Sinkhorn probe build differs from the kernel "
                         f"proper: {bad} fields")
    return {"split_means": mean}


# -- phase 9: times -----------------------------------------------------------
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
    this packet's counts (scatters); and the compacted outputs (the
    straggler output is its length-1 pad: the speculation lane's own bytes
    are ``spec_bound_ms``)."""
    S = SHAPE
    T, W, I = S["T"], S["W"], S["I"]
    n_arr, n_hb, n_fr, n_if, n_sp, n_ac = (int(x) for x in packet[1:7])
    lanes = 2 if use_priority else 1
    pkt = 4 * (9 + n_arr * lanes + 2 * (n_hb + n_fr + n_if + n_sp + n_ac))
    reads = T * (4 + 1 + 4 * (lanes - 1)) + W * (4 + 4 + 1 + 4 + 1) + I * 4
    writes = (T + W * (4 + 1) + 4 * n_arr * lanes
              + 4 * (n_hb + n_if + n_sp) + n_ac)
    outs = 4 * (2 * S["KP"] + S["KA"] + S["KR"] + 1 + 1) + 2 * W
    return (pkt + reads + writes + outs) / HBM_BYTES_PER_S * 1e3


def rank_split_text(sp: dict) -> str:
    from tpu_faas_torch.sched.fused_tick import RANK_COUNTS, RANK_PHASES

    return (" + ".join(f"{k} {sp[k]:.4f}" for k in RANK_PHASES)
            + f" = {sp['total']:.4f} ms; "
            + ", ".join(f"{k} {sp[k]}" for k in RANK_COUNTS))


def resident_rank_split(dev, probe, samples: list, kw: dict,
                        label: str) -> dict:
    """The rank branch's split on a resident loop's own states: one launch
    of the probe build each, beside one of the kernel proper (every output
    and state leaf equal); the phases' means over the states."""
    from tpu_faas_torch.sched.fused_tick import (
        KERNEL, RANK_COUNTS, RANK_PHASES,
    )

    splits, bad = [], 0
    for packet, pre, _ in samples:
        res_k, st_k = KERNEL(packet, clone_state(pre), flush=False, **kw)
        res_p, st_p = probe(packet, clone_state(pre), flush=False, **kw)
        splits.append(probe.rank_split(dev, SHAPE["T"], SHAPE["W"],
                                       MAX_SLOTS))
        b1, _ = compare(res_p, res_k, "probe build: out")
        b2, _ = compare(st_p, st_k, "probe build: state")
        bad += b1 + b2
    mean = {k: statistics.mean(sp[k] for sp in splits)
            for k in (*RANK_PHASES, "total", *RANK_COUNTS)}
    log(f"  rank split, {label} (probe build, means over {len(splits)} "
        f"states): {rank_split_text(mean)}")
    if bad:
        raise SystemExit(f"rank probe build differs from the kernel: {bad} "
                         f"mismatched fields")
    return mean


def phase_time(dev, n: int, samples: list, probe) -> dict:
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
        packet, pre, _ = samples[next(order) % len(samples)]
        return packet, clone_state(pre)

    loop_ms = event_ms(lambda a: KERNEL(a[0], a[1], flush=False, **kw),
                       len(samples), setup=next_sample)
    loop_bound = statistics.median(bound_ms(True, p.cpu())
                                   for p, _, _ in samples)
    out = {"loop": (statistics.median(loop_ms), loop_bound)}
    log(f"  kernel on the resident run's own states (prio=True): "
        f"{out['loop'][0]:.4f} ms (min {min(loop_ms):.4f}), bound "
        f"{loop_bound:.6f} ms, medians of {len(loop_ms)}")
    out["split"] = resident_rank_split(dev, probe, samples, kw,
                                       "the resident loop's states")
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
    clock = sm_clock_hz()
    for name, (T, S), seed in (("headline", BID_HEADLINE, 7),
                               ("config3", BID_CONFIG3, 33)):
        args = bid_inputs(dev, T, S, seed)
        js = float(np.float32(1e-4))
        k_ms = event_ms(lambda _: KERNEL(*args, js), n)
        p_ms = event_ms(lambda _: bid_top2_stream_impl(*args, js),
                        max(3, n // 10))
        bound, by = bid_bound_ms(T, S, clock)
        out[name] = (statistics.median(k_ms), statistics.median(p_ms),
                     bound, by)
        log(f"  bid_top2 {T} x {S}: kernel {out[name][0]:.4f} ms (min "
            f"{min(k_ms):.4f}), plain version on the card "
            f"{out[name][1]:.4f} ms, bound {bound:.4f} ms ({by}: "
            f"{bid_pipe_text(clock)}), kernel/bound "
            f"{out[name][0] / bound:.2f}, the kernel at "
            f"{100 * bound / out[name][0]:.1f}% of its bound")
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


# -- phase 8: the tenancy lane (B1 with use_tenancy, all three branches) ----
def tenant_table(total_slots: int):
    """Config 16's tenancy (tpu_faas/bench/configs.py:2840): shares
    light=8, heavy=1, heavy capped at the fleet's slots minus one; four more
    tenants capped at 8, 64, 512 and 2,048 in flight, and the rest of the
    32 rows registered uncapped at share 1. Rows: 0 default, 1 light,
    2 heavy, 3.. the others."""
    from tpu_faas_torch.tenancy import TenantTable

    ten = TenantTable(max_tenants=NT_HEADLINE)
    ten.apply_specs("light=8,heavy=1",
                    f"heavy={total_slots - 1},t3=8,t4=64,t5=512,t6=2048")
    for i in range(7, NT_HEADLINE):
        ten.row_for(f"t{i}")
    assert (ten.row_for("light"), ten.row_for("heavy")) == (1, 2)
    assert ten.n_tenants == NT_HEADLINE
    return ten


def with_tenancy(leaves: dict, pkt: np.ndarray, rng, use_priority: bool,
                 NT: int = NT_HEADLINE):
    """``random_case``'s state and packet with the tenancy lane at ``NT``
    rows (NT_HEADLINE by default): tenant rows in the state over every row
    and past both ends; deficits on both sides of the starvation threshold
    (1,024) and at the cap (4,096); in the arrival lane rows past both
    ends, a NaN, a saturating and two truncating values; caps of 0
    (uncapped), at ``ahead``, below it and above it."""
    T, KA = SHAPE["T"], SHAPE["KA"]
    f32 = np.float32
    leaves = dict(
        leaves, tenant=rng.integers(-2, NT + 2, T).astype(np.int32),
        t_deficit=rng.choice(np.array([0.0, 5.5, 1023.75, 1024.0, 1500.0,
                                       4096.0], f32), NT))
    arr = rng.integers(-3, NT + 3, KA).astype(f32)
    arr[:5] = [1e10, -1e10, np.nan, 2.7, -0.5]
    share = rng.choice(np.array([8.0, 1.0, 2.0, 0.5, 3.0], f32), NT)
    ahead = rng.integers(0, 2000, NT)
    # half the rows uncapped, then at ahead, below it and above it: more
    # tasks eligible than the fleet has slots, so the admission order
    # decides which are placed
    kind = np.minimum(np.arange(NT) % 8, 4)
    cap = np.select(
        [kind <= 1, kind == 2, kind == 3],
        [0, ahead, np.maximum(ahead - rng.integers(1, 500, NT), 1)],
        ahead + rng.integers(1, 1200, NT))
    cut = 9 + KA * (2 if use_priority else 1)
    pkt = np.concatenate([pkt[:cut], arr, pkt[cut:], share, ahead,
                          cap]).astype(f32)
    return leaves, pkt


def tenancy_violations(res, tenant_leaf: torch.Tensor, pkt,
                       NT: int = NT_HEADLINE) -> int:
    """Tenants one launch placed past their allowance (cap minus inflight
    off the packet's tail, for the capped ones), plus placed tasks outside
    the launch's eligibility mask."""
    tail = np.asarray(pkt, np.float32)[-3 * NT:].astype(np.int64)
    ahead, cap = tail[NT : 2 * NT], tail[2 * NT :]
    slots = res.placed_slots[res.placed_slots >= 0].long()
    rows = tenant_leaf[slots].clamp(0, NT - 1).long()
    per = torch.bincount(rows, minlength=NT).cpu().numpy()
    allow = np.where(cap > 0, np.maximum(cap - ahead, 0), np.iinfo(np.int64).max)
    return int((per > allow).sum()) + int((~res.tenant_eligible[slots]).sum())


def tenancy_bound_ms(packet: torch.Tensor) -> float:
    """The lane's own bytes at the HBM rate: the tenant leaf read and the
    eligibility written (T each), the arrivals' tenant lane read and their
    rows written, the deficits read and written and the packet's tail."""
    T, NT = SHAPE["T"], NT_HEADLINE
    n_arr = int(packet[1])
    return (4 * T + T + 8 * n_arr + 8 * NT + 12 * NT) / HBM_BYTES_PER_S * 1e3


def phase_resident_tenancy(dev, card: str, probe) -> dict:
    """B1's tenancy lane in its three branches: against the plain version on
    synthetic headline states (priority lanes off and on); its time with
    the lane on against the same states with it off; then a resident loop
    per branch with config 16's shares and caps (``phase_resident`` with
    ``tenancy=True``), each launch counted with the counts set to 0 just
    before the loop and read just after; and the rank branch with the lane
    on the rank loop's own states, beside its plain version and its bound,
    for the kernels line."""
    from tpu_faas_torch.sched.fused_tick import KERNEL
    from tpu_faas_torch.sched.resident import (
        _flush_kernel_impl, _resident_tick_impl, state_from_numpy,
    )

    bad = {"rank": 0, "auction": 0, "sinkhorn": 0}
    err = dict.fromkeys(bad, 0.0)  # Sinkhorn: max |dg|/tau (contract b)
    lane = {}  # branch -> (ms with the lane off, ms with it on)
    for use_priority in (False, True):
        rng = np.random.default_rng(20 + int(use_priority))
        base, bpkt = random_case(rng, use_priority, now=100.0)
        leaves, pkt = with_tenancy(base, bpkt, rng, use_priority)
        kw = dict(SHAPE, max_slots=MAX_SLOTS, use_priority=use_priority,
                  **TENANCY_KW)
        packet = torch.from_numpy(pkt).to(dev)
        # rank, and the flush on the same packet
        res_p, new_p = _resident_tick_impl(
            packet, state_from_numpy(leaves, dev), **kw)
        res_k, new_k = KERNEL(packet, state_from_numpy(leaves, dev),
                              flush=False, **kw)
        fkw = {k: v for k, v in kw.items() if k not in ("KP", "KR",
                                                         "max_slots")}
        fst_p, farr_p = _flush_kernel_impl(
            packet, state_from_numpy(leaves, dev), **fkw)
        fst_k, farr_k = KERNEL(packet, state_from_numpy(leaves, dev),
                               flush=True, **kw)
        torch.cuda.synchronize()
        b1, e1 = compare(res_k, res_p, "tenancy rank out")
        b2, e2 = compare(new_k, new_p, "tenancy rank state")
        b3, e3 = compare(fst_k, fst_p, "tenancy flush state")
        b4 = 0 if torch.equal(farr_k, farr_p) else 1
        over = tenancy_violations(res_k, new_k.tenant, pkt)
        b = b1 + b2 + b3 + b4 + over
        bad["rank"] += b
        err["rank"] = max(err["rank"], e1, e2, e3)
        n_elig = int(res_k.tenant_eligible.sum())
        valid = int(leaves["valid"].sum())
        slots = int(torch.where(res_k.live, new_k.free.clamp(0, MAX_SLOTS),
                                0).sum()) + int(SHAPE["KP"])
        assert n_elig > slots, "the admission order decides nothing"
        log(f"  rank prio={use_priority}: eligible {n_elig} of the "
            f"{valid} valid before arrivals, more than the fleet's "
            f"{slots} slots, placed (reported) "
            f"{int((res_k.placed_slots >= 0).sum())}, deficits "
            f"{int((new_k.t_deficit > 0).sum())} of {NT_HEADLINE} positive, "
            f"flush equal {not (b3 + b4)}, mismatched fields and violations "
            f"{b}")
        # the auction, cold from the seed; the plain-bid twin on one state
        aleaves = dict(leaves,
                       price=(rng.integers(0, 64, SHAPE["W"] * MAX_SLOTS)
                              / 16).astype(np.float32),
                       refresh=np.asarray(True))
        b, e, rounds, spilled, rows = compare_auction_tick(
            dev, aleaves, pkt, use_priority,
            f"tenancy auction prio={use_priority}",
            plain_twin=not use_priority, tenancy=True)
        bad["auction"] += b
        err["auction"] = max(err["auction"], e)
        log(f"  auction prio={use_priority}: rounds {rounds}, spilled "
            f"{spilled}, bidder rows {rows}, mismatched fields and "
            f"violations {b}" + ("; also against plain bids"
                                 if not use_priority else ""))
        # Sinkhorn, under its contract, eligibility and deficits added
        pre = state_from_numpy(leaves, dev)
        res_s, new_s = KERNEL.sinkhorn(packet, clone_state(pre), **kw)
        torch.cuda.synchronize()
        c = sinkhorn_check(pre, packet, res_s, new_s, kw,
                           f"tenancy sinkhorn prio={use_priority}")
        over = tenancy_violations(res_s, new_s.tenant, pkt)
        bad["sinkhorn"] += c["bad"] + over
        err["sinkhorn"] = max(err["sinkhorn"], c["dg"])
        log(f"  sinkhorn prio={use_priority}: placed {c['placed']}, |df|/tau "
            f"{c['df']:.3e}, |dg|/tau {c['dg']:.3e}, contract violations "
            f"{c['bad']}, tenancy violations {over}, placements "
            f"{'differ from' if c['differs'] else 'equal'} the plain "
            f"version's")
        if use_priority:
            continue
        # the lane's cost: the same state with the lane off and on
        off = state_from_numpy(base, dev)
        on = state_from_numpy(leaves, dev)
        off_pkt = torch.from_numpy(bpkt).to(dev)
        kw_off = dict(SHAPE, max_slots=MAX_SLOTS, use_priority=use_priority)
        aoff = state_from_numpy(dict(aleaves, tenant=base["tenant"],
                                     t_deficit=base["t_deficit"]), dev)
        aon = state_from_numpy(aleaves, dev)
        for name, call, n, s_off, s_on in (
            ("rank", lambda p, st, k: KERNEL(p, st, flush=False, **k),
             N_TIMED, off, on),
            ("auction", lambda p, st, k: KERNEL.auction(p, st, **k), 3,
             aoff, aon),
            ("sinkhorn", lambda p, st, k: KERNEL.sinkhorn(p, st, **k), 10,
             off, on),
        ):
            t_off = event_ms(lambda st: call(off_pkt, st, kw_off), n,
                             setup=lambda s0=s_off: clone_state(s0))
            t_on = event_ms(lambda st: call(packet, st, kw), n,
                            setup=lambda s0=s_on: clone_state(s0))
            lane[name] = (statistics.median(t_off), statistics.median(t_on))
            log(f"  {name} kernel on one synthetic state, lane off "
                f"{lane[name][0]:.4f} ms, on {lane[name][1]:.4f} ms "
                f"(+{lane[name][1] - lane[name][0]:.4f} ms), medians of "
                f"{n} [{card}]")
    # tenant rows past the 1,024 block 0 counts in shared memory: their
    # counts live in global scratch; the rank grid's tiles count every row
    # in global scratch; rank (NT = 1,100 and 4,096) and auction (4,096)
    # exactly equal
    for nt in (NT_MID, NT_WIDE):
        rng = np.random.default_rng(24)
        base, bpkt = random_case(rng, nt == NT_MID, now=100.0)
        leaves, pkt = with_tenancy(base, bpkt, rng, nt == NT_MID, NT=nt)
        kw = dict(SHAPE, max_slots=MAX_SLOTS, use_priority=nt == NT_MID,
                  use_tenancy=True, NT=nt)
        packet = torch.from_numpy(pkt).to(dev)
        res_p, new_p = _resident_tick_impl(
            packet, state_from_numpy(leaves, dev), **kw)
        res_k, new_k = KERNEL(packet, state_from_numpy(leaves, dev),
                              flush=False, **kw)
        torch.cuda.synchronize()
        b1, e1 = compare(res_k, res_p, f"tenancy NT={nt} rank out")
        b2, e2 = compare(new_k, new_p, f"tenancy NT={nt} rank state")
        over = tenancy_violations(res_k, new_k.tenant, pkt, nt)
        bad["rank"] += b1 + b2 + over
        err["rank"] = max(err["rank"], e1, e2)
        log(f"  NT={nt} tenant rows, prio={nt == NT_MID}: rank placed "
            f"{int((res_k.placed_slots >= 0).sum())}, deficits "
            f"{int((new_k.t_deficit > 0).sum())} of {nt} positive, "
            f"mismatched fields and violations {b1 + b2 + over}")
    aleaves = dict(leaves,
                   price=(rng.integers(0, 64, SHAPE["W"] * MAX_SLOTS)
                          / 16).astype(np.float32),
                   refresh=np.asarray(True))
    b, e, rounds, spilled, rows = compare_auction_tick(
        dev, aleaves, pkt, False, f"tenancy auction NT={NT_WIDE}",
        plain_twin=False, tenancy=True, nt=NT_WIDE)
    bad["auction"] += b
    err["auction"] = max(err["auction"], e)
    log(f"  NT={NT_WIDE} tenant rows: auction rounds {rounds}, bidder rows "
        f"{rows}, mismatched fields and violations {b}")
    total = sum(bad.values())
    if total:
        raise SystemExit(f"the tenancy lane disagrees with its plain "
                         f"version: {bad}")
    log("phase tenancy kernel: rank and auction ticks and flushes exactly "
        "equal, Sinkhorn within its contract, every tenant within its "
        "allowance")

    loops = {}
    for placement in ("rank", "auction", "sinkhorn"):
        n_checked, n_timed = TENANCY_TICKS[placement]
        KERNEL.launches = KERNEL.auction_launches = 0
        KERNEL.sinkhorn_launches = KERNEL.tenancy_launches = 0
        r = phase_resident(dev, n_checked, n_timed, placement=placement,
                           tenancy=True)
        r["tenancy_launches"] = KERNEL.tenancy_launches
        r["branch_launches"] = {"rank": KERNEL.launches,
                                "auction": KERNEL.auction_launches,
                                "sinkhorn": KERNEL.sinkhorn_launches}
        assert r["tenancy_launches"] > 0, f"{placement}: the lane never ran"
        assert r["branch_launches"][placement] > 0
        bad[placement] += r["mismatches"] + r["over_allowance"]
        err[placement] = max(err[placement], r["max_abs_err"])
        loops[placement] = r
        log(f"  integrated tick_resident with tenancy, {placement} (diff, "
            f"pack, upload, kernel; synchronized): "
            f"{statistics.median(r['tick_ms']):.4f} ms against the 5 ms "
            f"period, host enqueue alone "
            f"{statistics.median(r['tick_enqueue_ms']):.4f} ms, packet "
            f"upload + kernel on the card "
            f"{statistics.median(r['launch_ms']):.4f} ms, medians of "
            f"{len(r['tick_ms'])} ticks; launches with the lane "
            f"{r['tenancy_launches']} [{card}]")

    # the main path's entry: the rank branch with the lane on the rank
    # loop's own states, its plain version on the same states, its bound
    samples = loops["rank"]["samples"]
    kw = dict(SHAPE, max_slots=MAX_SLOTS, use_priority=True, **TENANCY_KW)
    order = iter(range(10**9))

    def next_sample():
        packet, pre, _ = samples[next(order) % len(samples)]
        return packet, clone_state(pre)

    k_ms = event_ms(lambda a: KERNEL(a[0], a[1], flush=False, **kw),
                    len(samples), setup=next_sample)
    p_ms = event_ms(lambda a: _resident_tick_impl(a[0], a[1], **kw),
                    len(samples), setup=next_sample)
    lane_b = statistics.median(tenancy_bound_ms(p.cpu()) for p, _, _ in samples)
    bound = statistics.median(bound_ms(True, p.cpu()) for p, _, _ in samples)
    log(f"  rank kernel with the lane on the tenancy loop's own states: "
        f"{statistics.median(k_ms):.4f} ms (min {min(k_ms):.4f}), plain "
        f"version {statistics.median(p_ms):.4f} ms, bound {bound + lane_b:.6f}"
        f" ms (bytes: the rank tick's {bound:.6f} ms plus the lane's own "
        f"{lane_b:.6f} ms), medians of {len(k_ms)} [{card}]")
    resident_rank_split(dev, probe, samples, kw,
                        "the tenancy rank loop's states")
    return {"mismatches": bad, "max_abs_err": err, "lane": lane,
            "loops": loops, "ms": statistics.median(k_ms),
            "plain_ms": statistics.median(p_ms), "bound_ms": bound + lane_b,
            "lane_bound_ms": lane_b,
            "launches": loops["rank"]["tenancy_launches"]}


# -- phase 9: the speculation lane ------------------------------------------
def with_spec(leaves: dict, pkt: np.ndarray, rng, use_priority: bool,
              tenancy: bool, now: float):
    """``random_case``'s state and packet (``with_tenancy``'s with
    ``tenancy``) with the speculation lane: in-flight slots past, about at
    and under their threshold (on live rows, dead rows and empty slots
    alike), with pred 0, negative and NaN; avoid rows of -1, real rows and
    rows past both ends; arrivals' avoid rows likewise, with a NaN, a
    saturating and a truncating value; the in-flight scatter's pred lane
    with clears and indices wrapped once from below."""
    T, W, I, KA, KI = (SHAPE[k] for k in ("T", "W", "I", "KA", "KI"))
    f32 = np.float32
    pred = rng.choice(np.array([0.0, -1.0, 0.005, 0.02, 0.5, 2.0], f32), I)
    pred[rng.random(I) < 0.01] = np.nan
    thr = np.maximum(SPEC_MULT * np.nan_to_num(pred.astype(np.float64)),
                     SPEC_MIN_S)
    factor = rng.choice(np.array([0.25, 1.0, 1.5, 4.0]), I)
    leaves = dict(leaves, infl_pred=pred,
                  infl_start=(now - thr * factor).astype(f32),
                  avoid=np.where(rng.random(T) < 0.8, -1,
                                 rng.integers(-2, W + 2, T)).astype(np.int32))
    lanes = 1 + int(use_priority) + int(tenancy)
    cut = 9 + KA * lanes
    at_idx = cut + 2 * (SHAPE["KH"] + SHAPE["KF"])
    infl_end = at_idx + 2 * KI
    body_end = len(pkt) - (3 * NT_HEADLINE if tenancy else 0)
    pkt = pkt.copy()
    n_if = int(pkt[4])
    wrap = rng.random(n_if) < 0.3
    pkt[at_idx : at_idx + n_if][wrap] -= I  # wraps once onto the same slot
    arr = np.where(rng.random(KA) < 0.5, -1,
                   rng.integers(-2, W + 2, KA)).astype(f32)
    arr[:3] = [np.nan, 1e10, 7.9]
    pred_lane = rng.choice(np.array([0.0, 0.02, 0.5, -1.0, np.nan], f32), KI)
    pkt = np.concatenate([pkt[:cut], arr, pkt[cut:infl_end], pred_lane,
                          pkt[infl_end:body_end],
                          np.array([SPEC_MULT, SPEC_MIN_S], f32),
                          pkt[body_end:]]).astype(f32)
    return leaves, pkt


def spec_violations(res, avoid_leaf: torch.Tensor) -> int:
    """Tasks one launch placed (reported) on their avoid row."""
    ok = res.placed_slots >= 0
    slots = res.placed_slots[ok].long()
    return int((avoid_leaf[slots] == res.placed_rows[ok]).sum())


def spec_bound_ms(packet: torch.Tensor) -> float:
    """The lane's own bytes at the HBM rate: infl_start and infl_pred read
    over I, the avoid leaf read over T, the KG straggler slots written; the
    arrivals' avoid lane read and their rows written; the pred lane read
    and each scattered slot's stamp and prediction written; the 2-float
    tail. The fixup's reads of speed, free and liveness are the rank
    tick's own."""
    T, I = SHAPE["T"], SHAPE["I"]
    n_arr, n_if = int(packet[1]), int(packet[4])
    return ((8 * I + 4 * T + 4 * KG + 8 * n_arr + 12 * n_if + 8)
            / HBM_BYTES_PER_S * 1e3)


def spec_branch(name: str):
    from tpu_faas_torch.sched.fused_tick import KERNEL

    return {"rank": lambda p, st, k: KERNEL(p, st, flush=False, **k),
            "auction": lambda p, st, k: KERNEL.auction(p, st, **k),
            "sinkhorn": lambda p, st, k: KERNEL.sinkhorn(p, st, **k)}[name]


def phase_resident_spec(dev, card: str, probe) -> dict:
    """B1's speculation lane in its three branches: against the plain version
    on synthetic headline states (tenancy lane off and on); its time with
    the lane on against the same state with it off; then a resident loop
    per branch (``phase_resident`` with ``spec=True``), and the rank loop
    with the tenancy lane too, each launch counted with the counts set to 0
    just before the loop and read just after; and the rank branch with the
    lane on the rank loop's own states, beside its plain version and its
    bound, for the kernels line."""
    from tpu_faas_torch.sched.fused_tick import KERNEL
    from tpu_faas_torch.sched.resident import (
        _flush_kernel_impl, _resident_tick_impl, state_from_numpy,
    )

    bad = {"rank": 0, "auction": 0, "sinkhorn": 0}
    err = dict.fromkeys(bad, 0.0)  # Sinkhorn: max |dg|/tau (contract b)
    lane = {}  # branch -> (ms with the lane off, ms with it on)
    most_vetoed = 0
    for tenancy in (False, True):
        rng = np.random.default_rng(30 + int(tenancy))
        base, bpkt = random_case(rng, True, now=100.0)
        leaves, pkt = (with_tenancy(base, bpkt, rng, True) if tenancy
                       else (base, bpkt))
        leaves, pkt = with_spec(leaves, pkt, rng, True, tenancy, now=100.0)
        kw = dict(SHAPE, max_slots=MAX_SLOTS, use_priority=True, **SPEC_KW,
                  **(TENANCY_KW if tenancy else {}))
        packet = torch.from_numpy(pkt).to(dev)
        tag = f"spec{' tenancy' if tenancy else ''}"
        by_branch = {}
        for name in ("rank", "auction", "sinkhorn"):
            lv = dict(leaves)
            if name == "auction":
                lv.update(price=(rng.integers(0, 64, SHAPE["W"] * MAX_SLOTS)
                                 / 16).astype(np.float32),
                          refresh=np.asarray(True))
            # the veto's target: each task this branch's main pass places
            # (the first KP reported, with no avoid row anywhere) avoids the
            # very row it gets, so the veto fires on all of them and the
            # fixup's bound of 64 binds
            res0, _ = spec_branch(name)(packet, state_from_numpy(
                dict(lv, avoid=np.full(SHAPE["T"], -1, np.int32)), dev), kw)
            ok = res0.placed_slots >= 0
            slots = res0.placed_slots[ok].long().cpu().numpy()
            lv["avoid"] = lv["avoid"].copy()
            lv["avoid"][slots] = res0.placed_rows[ok].cpu().numpy()
            assert len(slots) > 64 + SHAPE["KA"], "the fixup's bound idles"
            most_vetoed = max(most_vetoed, len(slots))
            by_branch[name] = lv
            pre = state_from_numpy(lv, dev)
            if name == "auction":
                b, e, rounds, spilled, rows = compare_auction_tick(
                    dev, lv, pkt, True, f"{tag} auction", plain_twin=False,
                    tenancy=tenancy, spec=True)
                res_k, _ = spec_branch(name)(packet, clone_state(pre), kw)
                log(f"  {tag} auction: rounds {rounds}, spilled {spilled}, "
                    f"bidder rows {rows}, mismatched fields and violations "
                    f"{b}")
            elif name == "sinkhorn":
                res_k, new_k = KERNEL.sinkhorn(packet, clone_state(pre), **kw)
                torch.cuda.synchronize()
                c = sinkhorn_check(pre, packet, res_k, new_k, kw,
                                   f"{tag} sinkhorn")
                b = c["bad"] + (tenancy_violations(res_k, new_k.tenant, pkt)
                                if tenancy else 0)
                e = c["dg"]
                log(f"  {tag} sinkhorn: placed {c['placed']}, |dg|/tau "
                    f"{c['dg']:.3e}, contract violations {c['bad']}, "
                    f"placements {'differ from' if c['differs'] else 'equal'}"
                    f" the plain version's")
            else:
                res_p, new_p = _resident_tick_impl(packet, clone_state(pre),
                                                   **kw)
                res_k, new_k = KERNEL(packet, clone_state(pre), flush=False,
                                      **kw)
                fkw = {k: v for k, v in kw.items()
                       if k not in ("KP", "KR", "max_slots")}
                fst_p, farr_p = _flush_kernel_impl(packet, clone_state(pre),
                                                   **fkw)
                fst_k, farr_k = KERNEL(packet, clone_state(pre), flush=True,
                                       **kw)
                torch.cuda.synchronize()
                b1, e1 = compare(res_k, res_p, f"{tag} rank out")
                b2, e2 = compare(new_k, new_p, f"{tag} rank state")
                b3, e3 = compare(fst_k, fst_p, f"{tag} flush state")
                b = (b1 + b2 + b3 + int(not torch.equal(farr_k, farr_p))
                     + spec_violations(res_k, new_k.avoid)
                     + (tenancy_violations(res_k, new_k.tenant, pkt)
                        if tenancy else 0))
                e = max(e1, e2, e3)
            # the vetoed tasks placed after all (arrivals carry the
            # packet's avoid rows, not these)
            arrived = res_k.arrival_slots.cpu().numpy()
            placed = res_k.placed_slots.cpu().numpy()
            rehomed = int((np.isin(placed, slots)
                           & ~np.isin(placed, arrived)).sum())
            n_flag = int((res_k.straggler_slots >= 0).sum())
            log(f"  {tag} {name}: {len(slots)} tasks avoid the row placement "
                f"gives them, {rehomed} re-placed by the fixup (at most 64), "
                f"{n_flag} of KG={KG} straggler slots reported, mismatched "
                f"fields and violations {b}")
            assert rehomed <= 64 and n_flag == KG
            bad[name] += b
            err[name] = max(err[name], e)
        if tenancy:
            continue
        # the lane's cost: the same state with the lane off and on
        kw_off = dict(SHAPE, max_slots=MAX_SLOTS, use_priority=True)
        off_pkt = torch.from_numpy(bpkt).to(dev)
        for name, n in (("rank", N_TIMED), ("auction", 3), ("sinkhorn", 10)):
            s_on = state_from_numpy(by_branch[name], dev)
            s_off = state_from_numpy(dict(
                by_branch[name], infl_start=base["infl_start"],
                infl_pred=base["infl_pred"], avoid=base["avoid"]), dev)
            call = spec_branch(name)
            t_off = event_ms(lambda st: call(off_pkt, st, kw_off), n,
                             setup=lambda s0=s_off: clone_state(s0))
            t_on = event_ms(lambda st: call(packet, st, kw), n,
                            setup=lambda s0=s_on: clone_state(s0))
            lane[name] = (statistics.median(t_off), statistics.median(t_on))
            log(f"  {name} kernel on one synthetic state, speculation lane "
                f"off {lane[name][0]:.4f} ms, on {lane[name][1]:.4f} ms "
                f"(+{lane[name][1] - lane[name][0]:.4f} ms), medians of {n} "
                f"[{card}]")
    # the plain fixup reads nothing back to the host: its 64 steps under
    # the sync check, every task vetoed (its avoid row is its placement)
    from tpu_faas_torch.spec.straggler import hedge_fixup_impl

    lv = by_branch["rank"]
    assign = torch.from_numpy(np.where(lv["valid"], lv["avoid"], -1)).to(dev)
    args = (assign, assign, torch.from_numpy(lv["speed"]).to(dev),
            torch.from_numpy(lv["free"]).to(dev),
            torch.from_numpy(lv["active"]).to(dev))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fixed = hedge_fixup_impl(*args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    n_fixed = int(((assign >= 0) & (fixed >= 0)).sum())
    assert 0 < n_fixed <= 64, f"the plain fixup re-placed {n_fixed}"
    fix_ms = statistics.median(event_ms(lambda _: hedge_fixup_impl(*args),
                                        10))
    log(f"  the plain fixup alone (64 steps of torch ops, no host read): "
        f"{fix_ms:.4f} ms on the card, {n_fixed} tasks re-placed [{card}]")
    if sum(bad.values()):
        raise SystemExit(f"the speculation lane disagrees with its plain "
                         f"version: {bad}")
    log(f"phase speculation kernel: rank and auction ticks and flushes "
        f"exactly equal, Sinkhorn within its contract, no task on its avoid "
        f"row; up to {most_vetoed} tasks vetoed in one state")

    loops = {}
    for name, (n_checked, n_timed) in SPEC_TICKS.items():
        placement = name.split("+")[0]
        KERNEL.launches = KERNEL.auction_launches = 0
        KERNEL.sinkhorn_launches = KERNEL.tenancy_launches = 0
        KERNEL.spec_launches = 0
        r = phase_resident(dev, n_checked, n_timed, placement=placement,
                           tenancy="tenancy" in name, spec=True)
        r["spec_launches"] = KERNEL.spec_launches
        assert r["spec_launches"] > 0, f"{name}: the lane never ran"
        assert r["flagged"] > 0, f"{name}: no straggler flagged"
        bad[placement] += r["mismatches"] + r["on_avoid"]
        err[placement] = max(err[placement], r["max_abs_err"])
        loops[name] = r
        log(f"  integrated tick_resident with speculation, {name} (diff, "
            f"pack, upload, kernel; synchronized): "
            f"{statistics.median(r['tick_ms']):.4f} ms against the 5 ms "
            f"period, host enqueue alone "
            f"{statistics.median(r['tick_enqueue_ms']):.4f} ms, packet "
            f"upload + kernel on the card "
            f"{statistics.median(r['launch_ms']):.4f} ms, medians of "
            f"{len(r['tick_ms'])} ticks; launches with the lane "
            f"{r['spec_launches']} [{card}]")

    # the main path's entry: the rank branch with the lane on the rank
    # loop's own states, its plain version on the same states, its bound
    samples = loops["rank"]["samples"]
    kw = dict(SHAPE, max_slots=MAX_SLOTS, use_priority=True, **SPEC_KW)
    order = iter(range(10**9))

    def next_sample():
        packet, pre, _ = samples[next(order) % len(samples)]
        return packet, clone_state(pre)

    k_ms = event_ms(lambda a: KERNEL(a[0], a[1], flush=False, **kw),
                    len(samples), setup=next_sample)
    p_ms = event_ms(lambda a: _resident_tick_impl(a[0], a[1], **kw),
                    len(samples), setup=next_sample)
    lane_b = statistics.median(spec_bound_ms(p.cpu()) for p, _, _ in samples)
    bound = statistics.median(bound_ms(True, p.cpu()) for p, _, _ in samples)
    log(f"  rank kernel with the lane on the speculation loop's own states: "
        f"{statistics.median(k_ms):.4f} ms (min {min(k_ms):.4f}), plain "
        f"version {statistics.median(p_ms):.4f} ms, bound {bound + lane_b:.6f}"
        f" ms (bytes: the rank tick's {bound:.6f} ms plus the lane's own "
        f"{lane_b:.6f} ms), medians of {len(k_ms)} [{card}]")
    resident_rank_split(dev, probe, samples, kw,
                        "the speculation rank loop's states")
    return {"mismatches": bad, "max_abs_err": err, "lane": lane,
            "loops": loops, "ms": statistics.median(k_ms),
            "plain_ms": statistics.median(p_ms), "bound_ms": bound + lane_b,
            "lane_bound_ms": lane_b,
            "launches": loops["rank"]["spec_launches"]}


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
    t_start = time.perf_counter()
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python "
        f"{sys.version.split()[0]}, device {kind}")
    t0 = time.perf_counter()
    # the probe build: the fused tick with the auction's phase stamps
    probe = fused_tick.FusedTickKernel(probe=True)
    kernels = (fused_tick.KERNEL, probe, bid.KERNEL)
    with ThreadPoolExecutor(len(kernels)) as pool:  # one nvcc per build
        for f in [pool.submit(k.load) for k in kernels]:
            f.result()
    log(f"phase build: fused_tick, its probe build and bid_top2 built in "
        f"{time.perf_counter() - t0:.1f} s")
    for k in kernels:
        name = k.name + (" (probe)" if k is probe else "")
        for line in k.ptxas_report.splitlines():
            if any(w in line for w in ("registers", "spill", "smem",
                                       "Function properties")):
                log(f"  ptxas {name}: {line.strip()}")

    log_bid_loops()

    rk = phase_kernel(dev)
    re = rank_edges(dev)
    fused_tick.KERNEL.launches = 0  # count the main path alone
    fell = fused_tick.KERNEL.rank_fallbacks(dev, SHAPE["T"], SHAPE["W"],
                                            MAX_SLOTS)
    rr = phase_resident(dev, N_TICKS, N_TIMED)
    launches = fused_tick.KERNEL.launches
    assert launches > 0, "the main path never launched"
    fell = fused_tick.KERNEL.rank_fallbacks(dev, SHAPE["T"], SHAPE["W"],
                                            MAX_SLOTS) - fell
    log(f"  rank ticks of the loop that took the full-length path: {fell} "
        f"of {launches} launches")
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
    rka = phase_auction_kernel(dev, probe)
    fused_tick.KERNEL.launches = 0  # count the resident auction loop alone
    fused_tick.KERNEL.auction_launches = 0
    rra = phase_resident(dev, N_AUCTION_TICKS, N_AUCTION_TIMED,
                         placement="auction")
    auction_launches = fused_tick.KERNEL.auction_launches
    assert auction_launches > 0, "the resident auction never launched"
    log(f"  integrated tick_resident, auction (diff, pack, upload, kernel; "
        f"synchronized): {statistics.median(rra['tick_ms']):.4f} ms, host "
        f"enqueue alone {statistics.median(rra['tick_enqueue_ms']):.4f} ms, "
        f"packet upload + kernel on the card "
        f"{statistics.median(rra['launch_ms']):.4f} ms, medians of "
        f"{len(rra['tick_ms'])} ticks; auction launches {auction_launches} "
        f"[{card}]")
    log(f"  round split of the loop's states (probe build) [{card}]:")
    rsa = resident_auction_split(dev, probe, rra["samples"])
    rks = phase_sinkhorn_kernel(dev, probe)
    fused_tick.KERNEL.launches = 0  # count the resident Sinkhorn loop alone
    fused_tick.KERNEL.sinkhorn_launches = 0
    rrs = phase_resident(dev, N_SINKHORN_TICKS, N_SINKHORN_TIMED,
                         placement="sinkhorn")
    sinkhorn_launches = fused_tick.KERNEL.sinkhorn_launches
    assert sinkhorn_launches > 0, "the resident Sinkhorn never launched"
    log(f"  integrated tick_resident, Sinkhorn (diff, pack, upload, kernel; "
        f"synchronized): {statistics.median(rrs['tick_ms']):.4f} ms, host "
        f"enqueue alone {statistics.median(rrs['tick_enqueue_ms']):.4f} ms, "
        f"packet upload + kernel on the card "
        f"{statistics.median(rrs['launch_ms']):.4f} ms, medians of "
        f"{len(rrs['tick_ms'])} ticks; Sinkhorn launches "
        f"{sinkhorn_launches} [{card}]")
    phase_sinkhorn_batch(dev)
    rt = phase_resident_tenancy(dev, card, probe)
    t0 = time.perf_counter()
    rsp = phase_resident_spec(dev, card, probe)
    log(f"phase resident_spec: {time.perf_counter() - t0:.1f} s")
    log(f"phase time [{card}]:")
    t = phase_time(dev, N_TIMED, rr["samples"], probe)
    tb = time_bid(dev, N_TIMED // 3)
    time_auction(ra, 3)
    ta = time_resident_auction(dev, rra["samples"])
    ts = time_resident_sinkhorn(dev, rrs["samples"], probe)
    entry = {"name": "fused_resident_tick", "route": "cuda",
             "source": fused_tick.SOURCE, "replaces": fused_tick.REPLACES,
             "launches": launches,
             "mismatches": (rk["mismatches"] + re["mismatches"]
                            + rr["mismatches"] + rt["mismatches"]["rank"]),
             "max_abs_err": max(rk["max_abs_err"], re["max_abs_err"],
                                rr["max_abs_err"],
                                rt["max_abs_err"]["rank"]),
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
    # no single PyTorch call computes a resident auction tick
    entry_b1a = {"name": "fused_resident_tick_auction", "route": "cuda",
                 "source": fused_tick.SOURCE,
                 "replaces": fused_tick.AUCTION_REPLACES,
                 "launches": auction_launches,
                 "mismatches": (rka["mismatches"] + rra["mismatches"]
                                + rsa["mismatches"] + ta["mismatches"]
                                + rt["mismatches"]["auction"]),
                 "max_abs_err": max(rka["max_abs_err"], rra["max_abs_err"],
                                    ta["max_abs_err"],
                                    rt["max_abs_err"]["auction"]),
                 "ms": ta["ms"], "plain_ms": ta["plain_ms"],
                 "bound_ms": ta["bound_ms"], "bound_by": ta["bound_by"],
                 "library_ms": None}
    # no single PyTorch call computes a resident Sinkhorn tick
    entry_b1s = {"name": "fused_resident_tick_sinkhorn", "route": "cuda",
                 "source": fused_tick.SOURCE,
                 "replaces": fused_tick.SINKHORN_REPLACES,
                 "launches": sinkhorn_launches,
                 "mismatches": (rks["mismatches"] + rrs["mismatches"]
                                + rt["mismatches"]["sinkhorn"]),
                 "max_abs_err": max(rks["dg"], rrs["max_abs_err"],
                                    rt["max_abs_err"]["sinkhorn"]),
                 "ms": ts["ms"], "plain_ms": ts["plain_ms"],
                 "bound_ms": ts["bound_ms"], "bound_by": ts["bound_by"],
                 "library_ms": None}
    # the rank branch with the tenancy lane on; no single PyTorch call
    # computes a resident tick with fair admission
    entry_b1t = {"name": "fused_resident_tick_tenancy", "route": "cuda",
                 "source": fused_tick.SOURCE,
                 "replaces": fused_tick.TENANCY_REPLACES,
                 "launches": rt["launches"],
                 "mismatches": rt["mismatches"]["rank"],
                 "max_abs_err": rt["max_abs_err"]["rank"], "ms": rt["ms"],
                 "plain_ms": rt["plain_ms"], "bound_ms": rt["bound_ms"],
                 "bound_by": "bytes", "library_ms": None}
    # the rank branch with the speculation lane on; no single PyTorch call
    # computes a resident tick with straggler flags and the hedge fixup
    entry_b1g = {"name": "fused_resident_tick_spec", "route": "cuda",
                 "source": fused_tick.SOURCE,
                 "replaces": fused_tick.SPEC_REPLACES,
                 "launches": rsp["launches"],
                 "mismatches": rsp["mismatches"]["rank"],
                 "max_abs_err": rsp["max_abs_err"]["rank"], "ms": rsp["ms"],
                 "plain_ms": rsp["plain_ms"], "bound_ms": rsp["bound_ms"],
                 "bound_by": "bytes", "library_ms": None}
    log(f"card: {card}")
    log(f"chip_smoke wall time: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [entry, entry_b2, entry_b1a, entry_b1s,
                                  entry_b1t, entry_b1g]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
