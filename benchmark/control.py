"""The readings the limits of ``judge.LIMITS`` are set from: for each seed
one window of the program at the cell's own size, judged (the lower
readings), and as many ticks of the same traffic with the control in the
program's place, judged by the same judge (the upper readings). The
control is the plain reference's own solve on sizes and speeds rounded to
bfloat16, the precision below the configuration's float32; it has to come
out not correct. The benchmark's own runs never run it.

    python3 -m benchmark.control --workload NAME --seconds S SEED [SEED ...]

prints one JSON line a seed, then one line with each number's largest
program reading and smallest control reading.
"""

from __future__ import annotations

import argparse
import json
import sys
from types import SimpleNamespace

import numpy as np
import torch

from benchmark import spec
from benchmark.judge import _pairs, judge
from benchmark.reference import auction as ref_auction
from benchmark.reference import rank as ref_rank
from benchmark.reference import sinkhorn as ref_sinkhorn
from benchmark.reference.state import KR, RefState
from benchmark.run import NoCard, card, run_cell
from benchmark.traffic import ChurnView, Traffic, due_after


def to_bf16(x: np.ndarray) -> np.ndarray:
    """float32 values rounded to bfloat16."""
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).to(
        torch.bfloat16).to(torch.float32).numpy()


def control_run(config: dict, tr: Traffic, n_ticks: int, device="cpu"
                ) -> tuple[list, dict, dict]:
    """``n_ticks`` ticks of ``tr``'s closed loop with the control as the
    scheduler: the record, the sampled ticks' outputs and the final state,
    in the shapes the program's run leaves them for the judge. Each tick
    applies its results, returning workers, heartbeats and arrivals to the
    reference's state, places by the control (rank matching or the
    auction on every tick, the auction carrying its own prices;
    Sinkhorn's solve and its rounding), redispatches and purges under
    churn, and files each placement under the tick its call will finish
    on, unless its worker is down by then, as the harness's loop does."""
    ref = RefState(config, tr)
    placement = config["placement"]
    view = None if tr.churn is None else ChurnView(tr.churn)
    row_worker = [w if wid is not None else -1
                  for w, wid in enumerate(tr.fleet.ids)]
    inv_speed = list(tr.inv_speed)
    price, refresh = ref.price, ref.refresh
    ring = tr.arrival_sizes
    buckets: dict[int, list] = {}
    for tid, row, due in zip(tr.inflight_ids, tr.inflight_rows.tolist(),
                             tr.inflight_due.tolist()):
        if view is None or not view.lost(row_worker[row], due):
            buckets.setdefault(due, []).append(tid)
    size_of = dict(zip(tr.inflight_ids, tr.inflight_sizes.tolist()))
    size_of.update(zip(tr.backlog_ids, tr.backlog_sizes.tolist()))

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    record, outputs, pos, mine = [], {}, 0, []
    for k in range(n_ticks):
        now = k * tr.dt
        due = buckets.pop(k, [])
        pos0 = pos % len(ring)
        sizes = [ring[(pos0 + i) % len(ring)] for i in range(len(due))]
        size_of.update(zip(due, sizes))
        ref.results(due)
        rows = []
        if view is None:
            ref.heartbeats(tr.hb_bucket[k % tr.hb_period], now)
        else:
            ch = tr.churn
            for w in view.step(k):
                row = ref.rejoin(ch.wid[w], ch.procs[w], ch.speed[w], now)
                rows.append(row)
                row_worker[row] = w
                inv_speed[row] = tr.inv_speed[w]
            ref.heartbeats(view.beating(k, tr.hb_period), now)
        rejected = ref.arrive(zip(due, sizes))
        live, purged, redisp = ref.liveness(now)
        redisp = redisp[:KR]
        speed_low = to_bf16(ref.speed)
        if placement == "rank":
            rt = ref_rank.rank_tick(to_bf16(ref.size), ref.valid, speed_low,
                                    ref.free, live, ref.K, ref.kp)
            mine = _pairs(ref, rt.task_slots, rt.rows)
        elif placement == "auction":
            ct = ref_auction.auction_tick(
                to_bf16(ref.size), ref.valid, speed_low, ref.free, live,
                ref.K, price, refresh, n_free_pending=len(ref.free_slots))
            price, refresh = ct.price, ct.refresh
            mine = _pairs(ref, ct.task_slots, ct.rows)
        else:
            sz, vd = t(to_bf16(ref.size)), t(ref.valid)
            sp, lv = t(speed_low), t(live)
            fr = t(ref.free.astype(np.int32))
            pb = ref_sinkhorn.problem(sz, vd, sp, fr, lv, ref.K)
            f, g = ref_sinkhorn.solve(pb)
            if k in tr.check_ticks:
                outputs[k] = SimpleNamespace(sinkhorn_f=f, sinkhorn_g=g,
                                             sinkhorn_tau=pb.tau)
            a = ref_sinkhorn.round_from(pb, g, sz, vd, sp, fr, lv, ref.K)
            slots = torch.nonzero(a >= 0).flatten()
            mine = _pairs(ref, slots, a[slots])
        tick = SimpleNamespace(  # what the judge reads of a resolved tick
            placed=mine, redispatch_slots=[-1] * len(redisp),
            purged_rows=purged, rejected=rejected,
            n_pending=ref.n_valid - len(mine))
        entry = (k, due, pos0, [tick], 1)
        ref.place(mine, live)
        if view is not None:
            entry += (rows, redisp)
            ref.reap(redisp, purged)
        record.append(entry)
        for tid, row in mine:
            d = due_after(k, size_of[tid], inv_speed[row], tr.dt)
            if view is None or not view.lost(row_worker[row], d):
                buckets.setdefault(d, []).append(tid)
        pos += len(due)
    return record, outputs, _final(ref, mine, price, refresh)


def _final(ref: RefState, last_placed, price, refresh) -> dict:
    """The reference's state as ``loop.snapshot`` reads the program's: the
    last resolve's placements, redispatches and purges reach the device
    with the next packet."""
    dv = ref.device_view(last_placed)
    return {
        "host": {
            "worker_free": ref.free.copy(),
            "last_heartbeat": ref.last_hb.copy(),
            "slot_task": {s: tid for s, tid in enumerate(ref.slot_id)
                          if tid is not None},
            "inflight": dict(ref.inflight),
            "worker_active": ref.active.copy(),
            "worker_ids": dict(ref.row_of),
            "row_ids": dict(ref.wid_of),
        },
        "device": {
            "valid": ref.valid.copy(),
            "sizes": ref.size.copy(),
            "free": dv["free"],
            "active": dv["active"],
            "speed": ref.speed.copy(),
            "last_hb": ref.last_hb.astype(np.float32),
            "prev_live": ref.prev_live.copy(),
            "inflight": np.fromiter(dv["inflight"].elements(),
                                    dtype=np.int64),
            "price": price,
            "refresh": refresh,
        },
    }


def readings(cell: spec.Cell, seed: int, seconds: float, device) -> dict:
    r = run_cell(cell, seed, seconds, False, device)
    v = r["verdict"]
    rec, outs, final = control_run(cell.config, r["traffic"],
                                   len(r["record"]), device)
    c = judge(cell.config, r["traffic"], rec, final, outs, device=device)
    return {"seed": seed, "ticks": v.ticks, "program": v.numbers,
            "program_correct": v.correct, "notes": v.notes,
            "control": c.numbers, "control_correct": c.correct,
            "control_notes": c.notes}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("seeds", type=int, nargs="+")
    args = ap.parse_args(argv)
    cell = spec.find_cell(args.workload)
    try:
        dev = card(cell.chips)
    except NoCard as exc:
        print(f"control: {exc}", file=sys.stderr)
        return 3
    lows: dict = {}
    highs: dict = {}
    for seed in args.seeds:
        out = readings(cell, seed, args.seconds, dev)
        print(json.dumps(out), flush=True)
        for k, v in out["program"].items():
            lows[k] = max(lows.get(k, v), v)
        for k, v in out["control"].items():
            highs[k] = min(highs.get(k, v), v)
    print(json.dumps({"workload": cell.name, "program_max": lows,
                      "control_min": highs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
