"""Whether the timed path placed right: the program's answers, tick by
tick, against the plain reference (``benchmark/reference``), which works
the state out again from the benchmark's own inputs.

Every tick of the record is replayed, warm-up and window alike. The
reference applies the tick's results, heartbeats and arrivals to its own
state, then judges what the program reported for the tick:

- ``tick_mismatch`` (auction and rank): ticks whose placements (call id
  and worker row, in pending-slot order), pending count, purged rows,
  redispatches or rejected arrivals differ from the reference's, or under
  churn whose redispatched calls or returning workers' rows do. Both
  placements are exact: the auction bids in float32, each operation
  rounded on its own, in the program's documented order; rank matching
  sorts and pairs (``reference/rank.py``).
- ``infeasible_ticks`` (Sinkhorn, every tick): a placement of a call that
  is not pending, out of slot order or twice, on a row that is not live or
  past its capacity; a count other than min(KP, valid tasks, capacity); a
  pending count, purge, redispatch or rejection other than the
  reference's.
- ``potential_gap`` (Sinkhorn, the ticks the seed samples): the widest gap
  between the program's final potentials and the reference's from the
  same state, over the entries finite in both, in units of the
  reference's temperature.
- ``replay_mismatch`` (Sinkhorn, the sampled ticks): ticks whose
  placements differ from the reference's rounding of the program's own
  potentials, or whose temperature or set of finite potentials differs.
- ``state_mismatch``: after the window, the program's host mirrors (free
  counts, heartbeat stamps, the pending map, the calls in flight, which
  rows are registered and the ids both ways) and the state its kernel
  carries (pending sizes and flags, free counts, stamps, liveness,
  registration, speeds, the in-flight table, and the auction's prices and
  staleness flag) against the reference's; each that differs counts one.

Redispatched calls are compared by id, never by the program's in-flight
slot numbers: while at most ``KR`` are due, the program's must be the
reference's; above that, ``KR`` of them.

The reference follows the program's placements and redispatches from tick
to tick (where they are not its own the tick already failed): the closed
loop's later inputs were made from them.
"""

from __future__ import annotations

from collections import Counter
from dataclasses import dataclass, field

import numpy as np
import torch

from benchmark.reference import auction as ref_auction
from benchmark.reference import rank as ref_rank
from benchmark.reference import sinkhorn as ref_sinkhorn
from benchmark.reference.state import KR, RefState
from benchmark.traffic import ChurnView, Traffic

#: each compared number's limit (see PERF.md for the readings each was set
#: from); a number above its limit makes the run not correct
LIMITS = {
    "tick_mismatch": 0,
    "infeasible_ticks": 0,
    "potential_gap": 1e-4,
    "replay_mismatch": 0,
    "state_mismatch": 0,
}
#: the potential gap when there is none to read (no sampled tick): larger
#: than any limit
NO_GAP = 1e30


@dataclass
class Verdict:
    numbers: dict  # name -> value
    limits: dict  # name -> limit
    ticks: int = 0
    failed_ticks: int = 0
    #: per tick the reference's work counts (the roofline readers' input)
    work: dict = field(default_factory=dict)
    notes: list = field(default_factory=list)

    @property
    def correct(self) -> bool:
        return all(self.numbers[k] <= self.limits[k] for k in self.numbers)


def _snapshot_ok(final: dict, ref: RefState, last_placed, auction: bool):
    """The names of the final-state items that differ."""
    bad = []
    host, dev = final["host"], final["device"]
    if not np.array_equal(host["worker_free"], ref.free):
        bad.append("host worker_free")
    if not np.array_equal(host["last_heartbeat"], ref.last_hb):
        bad.append("host last_heartbeat")
    want_slots = {s: t for s, t in enumerate(ref.slot_id) if t is not None}
    if host["slot_task"] != want_slots:
        bad.append("host slot_task")
    if host["inflight"] != ref.inflight:
        bad.append("host in-flight table")
    if not np.array_equal(host["worker_active"], ref.active):
        bad.append("host worker_active")
    if host["worker_ids"] != ref.row_of:
        bad.append("host worker_ids")
    if host["row_ids"] != ref.wid_of:
        bad.append("host row_ids")
    # the last resolve's placements, redispatches and purges reach the
    # device with the next packet
    want = ref.device_view(last_placed)
    v = dev["valid"].astype(bool)
    if not np.array_equal(v, ref.valid):
        bad.append("device valid")
    elif not np.array_equal(dev["sizes"][v], ref.size[ref.valid]):
        bad.append("device sizes")
    if not np.array_equal(dev["free"].astype(np.int64), want["free"]):
        bad.append("device free")
    if not np.array_equal(dev["active"].astype(bool), want["active"]):
        bad.append("device active")
    if not np.array_equal(dev["speed"], ref.speed):
        bad.append("device speed")
    if not np.array_equal(dev["last_hb"],
                          ref.last_hb.astype(np.float32)):
        bad.append("device last_hb")
    if not np.array_equal(dev["prev_live"].astype(bool), ref.prev_live):
        bad.append("device prev_live")
    rows = dev["inflight"]
    if Counter(rows[rows >= 0].tolist()) != want["inflight"]:
        bad.append("device in-flight table")
    if auction:
        if not np.array_equal(dev["price"], ref.price):
            bad.append("device price")
        if bool(dev["refresh"]) != ref.refresh:
            bad.append("device refresh")
    return bad


class _Replay:
    """The reference's walk through a record, one tick at a time."""

    def __init__(self, config, tr: Traffic, outputs, device):
        self.ref = RefState(config, tr)
        self.tr, self.outputs, self.device = tr, outputs, device
        placement = config["placement"]
        if placement not in ("auction", "rank", "sinkhorn"):
            raise ValueError(f"no reference for {placement!r}")
        self.auction = placement == "auction"
        self.exact = placement != "sinkhorn"
        if not self.exact and not ref_sinkhorn.bucketed(self.ref.T,
                                                        self.ref.W):
            raise ValueError("the Sinkhorn reference covers the bucketed "
                             "route")
        self.view = None if tr.churn is None else ChurnView(tr.churn)
        self.bad_ticks = self.replay_bad = self.n_sampled = 0
        self.gap = 0.0
        self.work: dict = {}
        self.last_placed: list = []

    def tick(self, k, due, pos0, resolved, churn=()) -> list[str]:
        """Apply tick ``k``'s inputs, judge its answers, follow them;
        returns what was wrong with them. ``churn`` is a churn loop's
        (rows registered, calls redispatched) of the tick."""
        ref, tr = self.ref, self.tr
        ring = tr.arrival_sizes
        sizes = [ring[(pos0 + i) % len(ring)] for i in range(len(due))]
        now = k * tr.dt
        bad = []
        ref.results(due)
        if self.view is None:
            ref.heartbeats(tr.hb_bucket[k % tr.hb_period], now)
        else:
            ch = tr.churn
            rows = [ref.rejoin(ch.wid[w], ch.procs[w], ch.speed[w], now)
                    for w in self.view.step(k)]
            if rows != list(churn[0]):
                bad.append("returning workers registered on other rows")
            ref.heartbeats(self.view.beating(k, tr.hb_period), now)
        rejected = ref.arrive(zip(due, sizes))
        live, purged, redisp = ref.liveness(now)
        placed = [p for r in resolved for p in r.placed]
        bad += _tick_faults(ref, live, purged, redisp, rejected, resolved,
                            placed)
        if self.view is not None:
            got = churn[1]
            if (len(set(got)) != len(got) or not set(got) <= set(redisp)
                    or len(got) != min(len(redisp), KR)):
                bad.append("redispatched calls differ")
        if self.auction:
            bad += self._auction(k, live, placed)
        elif self.exact:
            bad += self._rank(k, live, placed)
        elif k in self.outputs:
            self.n_sampled += 1
            gap, r_bad, self.work[k] = _sinkhorn_check(
                ref, live, self.outputs[k], placed, self.device)
            self.gap = max(self.gap, gap)
            self.replay_bad += r_bad
            if r_bad:
                bad.append("placements differ from the rounding of the "
                           "program's potentials")
        self.bad_ticks += bool(bad)
        ref.place(placed, live)
        if self.view is not None:
            ref.reap(churn[1], purged)
        self.last_placed = placed
        return bad

    def _rank(self, k, live, placed) -> list[str]:
        ref = self.ref
        rt = ref_rank.rank_tick(ref.size, ref.valid, ref.speed, ref.free,
                                live, ref.K, ref.kp)
        self.work[k] = (rt.n_slots, rt.n_admitted, len(rt.task_slots))
        if placed != _pairs(ref, rt.task_slots, rt.rows):
            return ["placements differ from the reference's"]
        return []

    def _auction(self, k, live, placed) -> list[str]:
        ref = self.ref
        at = ref_auction.auction_tick(
            ref.size, ref.valid, ref.speed, ref.free, live, ref.K,
            ref.price, ref.refresh, n_free_pending=len(ref.free_slots))
        ref.price, ref.refresh = at.price, at.refresh
        self.work[k] = (at.rounds, at.bid_rows, at.n_match)
        if placed != _pairs(ref, at.task_slots, at.rows):
            return ["placements differ from the reference's"]
        return []


def judge(config: dict, tr: Traffic, record: list, final: dict,
          outputs: dict, device="cpu") -> Verdict:
    """Replay ``record`` through the reference and judge it.

    ``final`` is the program's state after the window (``snapshot``),
    ``outputs`` the program's tick outputs kept for the sampled Sinkhorn
    ticks."""
    rp = _Replay(config, tr, outputs, device)
    notes: list = []
    broken = None
    for n_done, (k, due, pos0, resolved, _, *churn) in enumerate(record):
        try:
            bad = rp.tick(k, due, pos0, resolved, churn)
        except (KeyError, IndexError, ValueError) as exc:
            # answers the reference cannot follow (a call placed twice, a
            # result for a call not in flight): this tick and every later
            # one fail, and the final state is not compared
            broken = f"tick {k}: the reference cannot follow: {exc!r}"
            rp.bad_ticks += len(record) - n_done
            break
        if bad and len(notes) < 5:
            notes.append(f"tick {k}: " + "; ".join(bad))
    if rp.exact:
        numbers = {"tick_mismatch": rp.bad_ticks}
    else:
        numbers = {"potential_gap": rp.gap if rp.n_sampled else NO_GAP,
                   "infeasible_ticks": rp.bad_ticks,
                   "replay_mismatch": rp.replay_bad}
        if not rp.n_sampled:
            notes.append("no sampled tick in the record")
    if broken:
        notes.append(broken)
    state_bad = (["not compared"] if broken else _snapshot_ok(
        final, rp.ref, rp.last_placed, rp.auction))
    if state_bad:
        notes.append("state differs: " + ", ".join(state_bad))
    numbers["state_mismatch"] = len(state_bad)
    return Verdict(numbers, {k: LIMITS[k] for k in numbers},
                   ticks=len(record), failed_ticks=rp.bad_ticks,
                   work=rp.work, notes=notes)


def _pairs(ref: RefState, task_slots, rows) -> list:
    """(call id, row) of the first KP placements, in pending-slot order."""
    return [(ref.slot_id[s], int(r)) for s, r in
            zip(task_slots[:ref.kp].tolist(), rows[:ref.kp].tolist())]


def _tick_faults(ref: RefState, live, purged, redisp, rejected, resolved,
                 placed) -> list[str]:
    """What is wrong with a tick's answers whatever the placement rule."""
    bad = []
    main = resolved[-1]
    if (main.n_pending != ref.n_valid - len(placed)
            or sorted(main.purged_rows.tolist()) != purged.tolist()
            or len(main.redispatch_slots) != min(len(redisp), KR)
            or sum(r.rejected for r in resolved) != rejected):
        bad.append("pending count, purge, redispatch or rejection")
    cap = ref.capacity(live)
    n_want = min(ref.kp, ref.n_valid, int(cap.sum()))
    slots = [ref.slot_of.get(tid, -1) for tid, _ in placed]
    rows = np.asarray([row for _, row in placed], dtype=np.int64)
    if len(rows) and (rows.min() < 0 or rows.max() >= ref.W):
        return bad + ["placements on rows outside the table"]
    per_row = np.bincount(rows, minlength=ref.W) if len(rows) else 0
    if (len(placed) != n_want or min(slots, default=0) < 0
            or any(b <= a for a, b in zip(slots, slots[1:]))
            or (len(rows) and not live[rows].all())
            or np.any(per_row > cap)):
        bad.append("placements infeasible")
    return bad


def _sinkhorn_check(ref: RefState, live, out, placed, device):
    """One sampled tick: (potential gap / tau, replay mismatches 0 or 1,
    the work counts (open buckets, open workers))."""
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    sz, vd, sp = t(ref.size), t(ref.valid), t(ref.speed)
    fr, lv = t(ref.free.astype(np.int32)), t(live)
    pb = ref_sinkhorn.problem(sz, vd, sp, fr, lv, ref.K)
    f, g = ref_sinkhorn.solve(pb)
    jf = out.sinkhorn_f.to(device).float()
    jg = out.sinkhorn_g.to(device).float()
    jtau = out.sinkhorn_tau.to(device).float().reshape(())
    fin_f, fin_g = torch.isfinite(f), torch.isfinite(g)
    both_f = fin_f & torch.isfinite(jf)
    both_g = fin_g & torch.isfinite(jg)
    gap = max(float((jf - f)[both_f].abs().max()) if both_f.any() else 0.0,
              float((jg - g)[both_g].abs().max()) if both_g.any() else 0.0
              ) / float(pb.tau)
    mismatch = 0
    if (not torch.equal(both_f, fin_f | torch.isfinite(jf))
            or not torch.equal(both_g, fin_g | torch.isfinite(jg))
            or not torch.equal(jtau, pb.tau.reshape(()))):
        # the program's temperature, or which potentials are finite,
        # differs from the reference's
        mismatch = 1
    # the program's placements are the rounding of its own potentials
    a = ref_sinkhorn.round_from(pb, jg, sz, vd, sp, fr, lv, ref.K)
    slots = torch.nonzero(a >= 0).flatten()
    if _pairs(ref, slots, a[slots]) != placed:
        mismatch = 1
    n_rows = int(torch.isfinite(pb.loga).sum())
    n_cols = int(torch.isfinite(pb.logb).sum())
    return gap, mismatch, (n_rows, n_cols)
