"""Rank placement under fleet churn, from data alone: a configuration
stating ``"placement": "rank"`` and a ``churn`` block runs through
``run_cell`` and is judged tick by tick against the plain reference; the
judge catches each fault planted in the loop, the program or the
reference; the reference's rank matching is the program's exactly; and a
configuration without churn draws what it drew before."""

import copy
import hashlib

import numpy as np
import pytest
import torch

from benchmark.loop import ChurnLoop
from benchmark.reference import rank as ref_rank
from benchmark.traffic import ChurnView, Traffic

from small_cells import AUCTION, RANK_CHURN, SINKHORN, run_small, small_cell


def _churn_counts(record):
    purged = sum(len(r.purged_rows) for e in record for r in e[3])
    return purged, sum(len(e[6]) for e in record), sum(
        len(e[5]) for e in record)


@pytest.mark.parametrize("seed", [2**31 + 41, 2**33 + 7, 12345])
def test_small_rank_churn_cell_is_correct(seed):
    r = run_small(RANK_CHURN, seed)
    v = r["verdict"]
    assert v.correct, (v.numbers, v.notes)
    assert set(v.numbers) == {"tick_mismatch", "state_mismatch"}
    purged, redispatched, rejoined = _churn_counts(r["record"])
    assert purged > 0 and redispatched > 0 and rejoined > 0
    assert r["placed"] > 0
    # the work counts a roofline reader takes: slots, admitted, placed
    k = r["ticks"][0]
    n_slots, n_admitted, n_placed = v.work[k]
    assert n_placed <= n_admitted <= n_slots


def test_churn_needs_down_above_expiry():
    cell = small_cell(RANK_CHURN)
    cell.config["churn"]["down_s"] = cell.config["time_to_expire_s"]
    with pytest.raises(ValueError, match="down_s"):
        Traffic(cell.config, cell.traffic, 1)


def test_start_is_the_schedules_steady_state():
    cell = small_cell(RANK_CHURN)
    tr = Traffic(cell.config, cell.traffic, 2**31 + 3)
    ch = tr.churn
    listed = np.flatnonzero(tr.fleet.active)
    # purged workers hold no row and no call; down ones beat before 0
    assert not tr.fleet.active[ch.purged0].any()
    assert set(tr.inflight_rows.tolist()) <= set(listed.tolist())
    down_listed = ch.down0 & tr.fleet.active
    assert down_listed.any() and ch.purged0.any()
    # each beat last on its phase's tick before 0 (before its failure)
    assert (ch.start_hb[down_listed] < 0).all()
    up_hb = ch.start_hb[tr.fleet.active & ~ch.down0]
    assert (up_hb < 0).all()
    assert (up_hb >= -cell.config["heartbeat_period_s"] - 1e-9).all()
    # every down worker returns within down_ticks (a later failure
    # returns after them); an up one fails after tick 0
    up = tr.fleet.active & ~ch.down0
    assert (ch.first_fail[up] >= 1).all()
    view = ChurnView(ch)
    back = set()
    for k in range(1, ch.down_ticks + 1):
        back.update(view.step(k))
    assert back == set(np.flatnonzero(ch.down0).tolist())


def _drop_requeue(monkeypatch):
    monkeypatch.setattr(ChurnLoop, "requeue", property(
        lambda self: [], lambda self, value: None), raising=False)


def _ties_other_way(monkeypatch):
    def reversed_ties(size, valid, speed, free, live, max_slots):
        # the documented rule with every tie broken toward the higher index
        per_row = np.where(live, np.minimum(free, max_slots), 0)
        rows = np.flatnonzero(per_row > 0)
        slot_row = np.repeat(rows, per_row[rows])
        n = len(slot_row)
        by_speed = slot_row[np.lexsort((-np.arange(n), -speed[slot_row]))]
        adm = np.flatnonzero(valid)[:n]
        by_size = adm[np.lexsort((-adm, -size[adm]))]
        out = np.full(len(size), -1, dtype=np.int64)
        out[by_size] = by_speed[:len(by_size)]
        return out

    monkeypatch.setattr(ref_rank, "assignment", reversed_ties)


def _rejoin_elsewhere(monkeypatch):
    from tpu_faas_torch.sched.resident import ResidentScheduler

    real = ResidentScheduler.register

    def highest_row(self, wid, num_processes, speed=1.0):
        if wid not in self.worker_ids:
            row = int(np.flatnonzero(~self.worker_active)[-1])
            self.worker_ids[wid] = row
            self.row_ids[row] = wid
        return real(self, wid, num_processes, speed)

    monkeypatch.setattr(ResidentScheduler, "register", highest_row)


def _redispatch_twice(monkeypatch):
    from tpu_faas_torch.sched.resident import ResidentScheduler

    real = ResidentScheduler.resolve_next
    last: list = []

    def twice(self):
        res = real(self)
        if res is not None:
            # each redispatched slot answered again on the next tick
            now = list(res.redispatch_slots)
            res.redispatch_slots = now + last
            last[:] = now
        return res

    monkeypatch.setattr(ResidentScheduler, "resolve_next", twice)


#: the reference's tie order is a fault only where ties exist: on this
#: fleet's continuous speeds and sizes only slots of one worker tie, and
#: they name the same row; it is planted on a fleet of one speed below
FAULTS = {
    "loop_drops_requeue": _drop_requeue,
    "rejoin_on_another_row": _rejoin_elsewhere,
    "redispatch_answered_twice": _redispatch_twice,
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_caught(monkeypatch, fault):
    FAULTS[fault](monkeypatch)
    v = run_small(RANK_CHURN, 2**31 + 43)["verdict"]
    assert not v.correct, (fault, v.numbers)
    # every one of them shows tick by tick
    assert v.numbers["tick_mismatch"] > 0, (fault, v.numbers, v.notes)


def test_ties_decide_on_an_equal_speed_fleet(monkeypatch):
    """On a fleet of one speed every slot ties, so the slot order decides
    which worker takes which task: the program follows it, and the
    reference whose ties break the other way is caught."""
    import small_cells

    cell = small_cell(RANK_CHURN)
    cell.config["worker_speed_range"] = [2.0, 2.0]
    monkeypatch.setattr(small_cells, "small_cell", lambda name: cell)
    seed = 2**31 + 47
    v = run_small(RANK_CHURN, seed)["verdict"]
    assert v.correct, (v.numbers, v.notes)
    _ties_other_way(monkeypatch)
    v = run_small(RANK_CHURN, seed)["verdict"]
    assert v.numbers["tick_mismatch"] > 0, v.numbers


def _state(seed, T=300, W=40, K=8):
    """A rank tick's inputs with ties in speeds and sizes, workers with no
    free process or more than K, and dead workers."""
    rng = np.random.default_rng(seed)
    size = rng.choice(np.float32([0.5, 1.0, 1.0, 2.0, 3.5]), T)
    size[rng.random(T) < 0.1] = 0.0
    valid = rng.random(T) < 0.6
    speed = rng.choice(np.float32([0.5, 1.0, 1.0, 4.0]), W)
    free = rng.integers(-1, K + 3, W).astype(np.int32)
    free[rng.random(W) < 0.2] = 0
    live = rng.random(W) < 0.8
    return size, valid, speed, free, live, K


@pytest.mark.parametrize("seed", range(6))
def test_rank_reference_is_the_programs_rule(seed):
    from tpu_faas_torch.sched.greedy import rank_match_placement_impl

    size, valid, speed, free, live, K = _state(seed)
    want = rank_match_placement_impl(
        torch.from_numpy(size), torch.from_numpy(valid),
        torch.from_numpy(speed), torch.from_numpy(free),
        torch.from_numpy(live), K).numpy()
    got = ref_rank.assignment(size, valid, speed, free, live, K)
    np.testing.assert_array_equal(got, want)
    # more slots than tasks, and no slot at all
    for v in (np.ones_like(valid), np.zeros_like(valid)):
        want = rank_match_placement_impl(
            torch.from_numpy(size), torch.from_numpy(v),
            torch.from_numpy(speed), torch.from_numpy(free),
            torch.from_numpy(live), K).numpy()
        np.testing.assert_array_equal(
            ref_rank.assignment(size, v, speed, free, live, K), want)
    none = np.zeros_like(live)
    assert (ref_rank.assignment(size, valid, speed, free, none, K)
            == -1).all()


def test_rank_tick_reports_the_first_kp_in_slot_order():
    size, valid, speed, free, live, K = _state(3)
    a = ref_rank.assignment(size, valid, speed, free, live, K)
    rt = ref_rank.rank_tick(size, valid, speed, free, live, K, kp=5)
    placed = np.flatnonzero(a >= 0)
    assert rt.task_slots.tolist() == placed[:5].tolist()
    assert rt.rows.tolist() == a[placed[:5]].tolist()
    assert rt.n_admitted == len(placed) > 5


def _digest(tr: Traffic) -> str:
    h = hashlib.sha256()
    f = tr.fleet
    for a in (f.speed, f.procs, f.active, tr.inflight_rows,
              tr.inflight_sizes, tr.inflight_due, tr.backlog_sizes,
              np.asarray(tr.arrival_sizes, dtype=np.float64),
              np.asarray(sorted(tr.check_ticks), dtype=np.int64)):
        h.update(np.ascontiguousarray(a).tobytes())
    for ids in (f.ids, tr.inflight_ids, tr.backlog_ids):
        h.update(repr(ids).encode())
    h.update(repr(tr.hb_bucket).encode())
    return h.hexdigest()[:32]


#: the draws of the benchmark's cells at their small sizes, as the harness
#: drew them before a configuration could state churn
DRAWS = {
    (AUCTION, 2**31 + 11): "2f5e7db7d18550093e0be52fccec7f80",
    (AUCTION, 7): "c3372f231623e37d69e3ceca4a755698",
    (SINKHORN, 2**31 + 11): "fe74f1d7c40a118bf0e19606137b6936",
    (SINKHORN, 7): "b60b43c13ad89d1833e7dfbce2c72c09",
}


@pytest.mark.parametrize("name, seed", sorted(DRAWS))
def test_cells_without_churn_draw_as_before(name, seed):
    cell = small_cell(name)
    tr = Traffic(cell.config, cell.traffic, seed)
    assert tr.churn is None
    assert _digest(tr) == DRAWS[(name, seed)]
    # a churn block draws after everything else
    churned = copy.deepcopy(cell.config)
    churned["churn"] = {"fail_per_s": 0.05, "down_s": 15.0}
    tc = Traffic(churned, cell.traffic, seed)
    assert tc.arrival_sizes == tr.arrival_sizes
    assert tc.check_ticks == tr.check_ticks
    assert tc.backlog_ids == tr.backlog_ids
