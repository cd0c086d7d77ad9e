"""The roofline counts: the work a tick needs, the least time it takes on
the card's peaks, and the share the readers report."""

import math

import pytest

from benchmark import spec
from benchmark.context import Context
from benchmark.roofline import PEAKS, least_seconds, share_pct
from benchmark.trace import Capture

AUCTION = spec.metric_reader("b1_auction_roofline")
SINKHORN = spec.metric_reader("b1_sinkhorn_roofline")
RATE = PEAKS["sm_count"] * PEAKS["sm_clock_hz"]


def test_least_seconds_is_the_slowest_pipe_or_the_bytes():
    per = PEAKS["per_sm_per_clock"]
    ops = {"int32": 64e6, "fp32": 64e6}
    want = 64e6 / (per["int32"] * RATE)
    assert math.isclose(least_seconds(ops, 0.0), want)
    # a byte bound above the compute bound wins
    n_bytes = 10 * want * PEAKS["hbm_bytes_per_s"]
    assert math.isclose(least_seconds(ops, n_bytes), 10 * want)


def test_auction_counts():
    # 350 admitted, 9,800 bidders over the rounds: base cells once, price
    # cells every round
    ops, n_bytes = AUCTION.tick_work(41, 9800, 350, 200000, 16384, 8)
    base, bids = 350 * 350, 9800 * 350
    assert ops["int32"] == 11 * base
    assert ops["conversion"] == base
    assert ops["fp32"] == 3 * base + 4 * bids
    assert ops["issue"] == 15 * base + 4 * bids
    assert n_bytes == 200000 + 16 * 350 + 9 * 16384 + 4 * 16384 * 8
    # no admitted task, no bid work
    ops0, _ = AUCTION.tick_work(0, 0, 0, 10, 4, 8)
    assert all(v == 0 for v in ops0.values())


def test_sinkhorn_counts():
    ops, n_bytes = SINKHORN.tick_work(900, 36, 200000, 16384, 8)
    lse = 2 * 20 * 900 * 36
    assert ops["sfu"] == lse + 200000
    assert ops["fp32"] == 3 * lse + 2 * 900 * 36
    assert n_bytes == 5 * 200000 + 9 * 16384 + 4 * (1025 + 16385)
    # the special function unit bounds it at these counts
    per = PEAKS["per_sm_per_clock"]
    t = least_seconds(ops, n_bytes)
    assert t >= ops["sfu"] / (per["sfu"] * RATE)


def test_share_reads_nothing_from_nothing():
    assert share_pct([], []) is None
    assert share_pct([1.0], []) is None
    assert share_pct([1.0], [0.0]) is None
    assert share_pct([1.0, 1.0], [4.0, 4.0]) == pytest.approx(25.0)


def _ctx(work, durations, ticks, config):
    cap = Capture((0.0, 10.0), [], [
        (float(i), float(i) + d, "void fused_auction_kernel<false>(...)"
         if "auction" in config["placement"] else
         "void fused_sinkhorn_kernel<false>(...)")
        for i, d in enumerate(durations)])
    import numpy as np
    return Context(config, np.zeros((len(ticks), 4)), ticks, work, cap)


def test_auction_reader_sums_over_the_window():
    config = {"placement": "auction", "max_pending": 200000,
              "max_workers": 16384, "max_slots": 8}
    work = {10: (41, 9800, 350), 11: (5, 500, 340)}
    ctx = _ctx(work, [4e-3, 3e-3], [10, 11], config)
    least = [least_seconds(*AUCTION.tick_work(*work[k], 200000, 16384, 8))
             for k in (10, 11)]
    assert AUCTION.read(ctx) == pytest.approx(100 * sum(least) / 7e-3)
    assert 0 < AUCTION.read(ctx) < 100
    # a tick the reference did not count: nothing to read
    assert AUCTION.read(_ctx({10: work[10]}, [4e-3, 3e-3], [10, 11],
                             config)) is None
    # a launch count other than one a tick: nothing to read
    assert AUCTION.read(_ctx(work, [4e-3], [10, 11], config)) is None


def test_sinkhorn_reader_takes_the_sampled_ticks():
    config = {"placement": "sinkhorn", "max_pending": 200000,
              "max_workers": 16384, "max_slots": 8}
    ctx = _ctx({11: (900, 36)}, [1e-3, 2e-3, 3e-3], [10, 11, 12], config)
    least = least_seconds(*SINKHORN.tick_work(900, 36, 200000, 16384, 8))
    assert SINKHORN.read(ctx) == pytest.approx(100 * least / 2e-3)
    assert SINKHORN.read(_ctx({}, [1e-3], [10], config)) is None


def test_capture_busy_and_idle():
    spans = [[(0.0, 1.0), (1.0, 2.0), (2.0, 4.0)],
             [(5.0, 6.0), (6.0, 7.0), (7.0, 9.0)]]
    ops = [(2.5, 3.5, "k"), (3.0, 3.8, "k"), (7.5, 8.0, "m")]
    cap = Capture((0.0, 9.0), spans, ops)
    assert cap.busy_s() == pytest.approx(1.3 + 0.5)
    gaps = dict(cap.idle_gaps())
    assert gaps["bench.intake"] == pytest.approx(2.0)
    assert gaps["bench.enqueue"] == pytest.approx(2.0)
    assert gaps["bench.resolve"] == pytest.approx(4.0 - 1.3 - 0.5)
    assert gaps["between"] == pytest.approx(1.0)
    assert cap.device_ops() == [["k", pytest.approx(1.8)],
                                ["m", pytest.approx(0.5)]]
