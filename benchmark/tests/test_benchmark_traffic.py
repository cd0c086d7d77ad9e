"""The traffic is the seed's: the same seed gives the same fleet, calls
and schedule, another seed other ones; the loop is closed."""

import numpy as np
import pytest

from benchmark import spec
from benchmark.traffic import Traffic

from small_cells import AUCTION, SINKHORN, run_small, small_cell


def _draw(seed, name=AUCTION):
    cell = small_cell(name)
    return Traffic(cell.config, cell.traffic, seed)


def _same(a: Traffic, b: Traffic) -> bool:
    return (np.array_equal(a.fleet.speed, b.fleet.speed)
            and np.array_equal(a.fleet.procs, b.fleet.procs)
            and np.array_equal(a.fleet.active, b.fleet.active)
            and a.hb_bucket == b.hb_bucket
            and a.inflight_ids == b.inflight_ids
            and np.array_equal(a.inflight_rows, b.inflight_rows)
            and np.array_equal(a.inflight_sizes, b.inflight_sizes)
            and np.array_equal(a.inflight_due, b.inflight_due)
            and a.backlog_ids == b.backlog_ids
            and np.array_equal(a.backlog_sizes, b.backlog_sizes)
            and a.arrival_sizes == b.arrival_sizes
            and a.check_ticks == b.check_ticks)


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5, 2**40 + 3, -12])
def test_same_seed_same_traffic(seed):
    assert _same(_draw(seed), _draw(seed))


def test_other_seed_other_traffic():
    a, b = _draw(2**31 + 1), _draw(2**31 + 2)
    assert not np.array_equal(a.fleet.speed, b.fleet.speed)
    assert a.backlog_ids != b.backlog_ids
    assert a.arrival_sizes != b.arrival_sizes


def test_fleet_shape_follows_the_config():
    cell = spec.find_cell(AUCTION)
    tr = Traffic(cell.config, cell.traffic, 3)
    W = cell.config["max_workers"]
    assert len(tr.fleet.speed) == W
    assert (~tr.fleet.active).sum() == round(0.05 * W)
    assert tr.fleet.speed.min() >= 0.5 and tr.fleet.speed.max() <= 4.0
    assert set(np.unique(tr.fleet.procs)) <= set(range(1, 9))
    busy = int(tr.fleet.procs[tr.fleet.active].sum())
    assert len(tr.inflight_ids) == busy
    assert len(tr.backlog_ids) == (cell.config["max_pending"]
                                   - cell.config["pending_headroom"])
    # every live worker heartbeats once a period
    assert sum(len(b) for b in tr.hb_bucket) == int(tr.fleet.active.sum())
    # the mean size is the mix's
    sizes = np.asarray(tr.arrival_sizes)
    assert abs(sizes.mean() / cell.traffic["work_mean_s"] - 1) < 0.02


@pytest.mark.parametrize("name", [AUCTION, SINKHORN])
def test_closed_loop_holds_the_backlog(name):
    r = run_small(name, seconds=0.5)
    for k, due, _, resolved, _ in r["record"]:
        # every finished call's caller submits the next under its id
        assert len(set(due)) == len(due)
    pending = [res[3][-1].n_pending for res in r["record"]]
    backlog = len(r["traffic"].backlog_ids)
    # each tick's arrivals replace its results, and the free processes
    # they leave are filled: the backlog stays where it started
    assert min(pending) >= backlog - 64 and max(pending) <= backlog
