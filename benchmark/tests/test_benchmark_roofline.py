"""The roofline counts: the work a tick needs, the least time it takes on
the card's peaks, and the share the readers report."""

import math

import pytest

from benchmark import spec
from benchmark.context import Context
from benchmark.roofline import PEAKS, least_seconds, share_pct
from benchmark.trace import Capture, capture

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


def _ctx(work, durations, ticks, config, dispatches=None):
    """Window tick i from i to i + 1 s on the trace's clock, its launch
    starting 0.3 s in."""
    spans = [[(i, i + 0.25), (i + 0.25, i + 0.5), (i + 0.5, i + 1.0)]
             for i in range(len(ticks))]
    cap = Capture((0.0, float(len(ticks))), spans, [
        (i + 0.3, i + 0.3 + d, "void fused_auction_kernel<false>(...)"
         if "auction" in config["placement"] else
         "void fused_sinkhorn_kernel<false>(...)")
        for i, d in enumerate(durations)])
    import numpy as np
    return Context(config, np.zeros((len(ticks), 4)), ticks, work, cap,
                   dispatches)


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
    # a tick the capture holds no launch for is left out
    assert AUCTION.read(_ctx(work, [4e-3], [10, 11], config)) == (
        pytest.approx(100 * least[0] / 4e-3))
    # more launches in a tick than it dispatched: nothing to read
    assert AUCTION.read(_ctx(work, [4e-3, 3e-3], [10, 11], config,
                             dispatches=[1, 0])) is None


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


def _windows(n):
    """Window tick i from i to i + 1 s: intake, enqueue, resolve."""
    return [[(i, i + 0.25), (i + 0.25, i + 0.5), (i + 0.5, i + 1.0)]
            for i in range(n)]


def test_launches_sum_a_ticks_launches():
    """A tick that flushes issues two launches, both summed into it; a
    launch outside every tick counts for none; a tick whose record the
    capture lost is left out, not the whole window."""
    k = "void fused_sinkhorn_kernel<false>(float const*, ...)"
    ops = [(0.3, 0.301, k), (1.26, 1.262, k), (1.3, 1.304, k),
           (2.3, 2.303, k), (1.31, 1.5, "void other_kernel<false>(...)"),
           (4.5, 4.6, k)]
    cap = Capture((0.0, 5.0), _windows(4), ops)
    import numpy as np
    ctx = Context({}, np.zeros((4, 4)), [10, 11, 12, 13], {}, cap,
                  [1, 2, 1, 1])
    d = ctx.launches("fused_sinkhorn_kernel")
    assert list(d) == [10, 11, 12]
    assert d[10] == pytest.approx(1e-3)
    assert d[11] == pytest.approx(6e-3)
    assert d[12] == pytest.approx(3e-3)
    ms = spec.metric_reader("b1_sinkhorn_ms")
    assert ms.read(ctx) == pytest.approx(1e3 * 10e-3 / 3)
    # two launches in a tick that dispatched one: another kernel matched
    ctx.dispatches = [1, 1, 1, 1]
    assert ctx.launches("fused_sinkhorn_kernel") is None
    assert ms.read(ctx) is None
    # nothing of the kernel in the window
    assert ctx.launches("fused_rank_kernel") is None


def test_launches_one_a_tick_read_as_before():
    """Where every tick holds its one launch, each value is that launch's
    duration and the mean is the one the count-matching rule gave."""
    k = "void fused_auction_kernel<false>(...)"
    durations = [1e-3, 2.5e-3, 4e-3]
    ops = [(i + 0.3, i + 0.3 + d, k) for i, d in enumerate(durations)]
    cap = Capture((0.0, 3.0), _windows(3), ops)
    import numpy as np
    ctx = Context({}, np.zeros((3, 4)), [5, 6, 7], {}, cap, [1, 1, 1])
    d = ctx.launches("fused_auction_kernel")
    assert list(d.values()) == [e - s for s, e, _ in ops]
    assert spec.metric_reader("b1_auction_ms").read(ctx) == (
        1e3 * sum(e - s for s, e, _ in ops) / 3)


def test_launches_follow_the_host_call_not_the_device_clock():
    """The trace maps a device start onto the host's clock with an error
    of some tenths of a millisecond either way (on the card, starts read
    up to 0.33 ms before the calls that launched them): a start that reads
    early lands in the tick before, which then holds two launches against
    its one dispatch. Each launch goes to the tick whose span holds its
    host call."""
    k = "void fused_sinkhorn_kernel<false>(float const*, ...)"
    # tick 1's launch reads as starting at 0.95, in tick 0's resolve
    ops = [(0.40, 0.44, k), (0.95, 0.97, k), (2.40, 2.43, k)]
    calls = [0.38, 1.38, 2.38]
    import numpy as np
    skewed = Capture((0.0, 3.0), _windows(3), ops)
    ctx = Context({}, np.zeros((3, 4)), [7, 8, 9], {}, skewed, [1, 1, 1])
    assert ctx.launches("fused_sinkhorn_kernel") is None
    ctx.capture = Capture((0.0, 3.0), _windows(3), ops, calls)
    d = ctx.launches("fused_sinkhorn_kernel")
    assert list(d) == [7, 8, 9]
    assert [d[t] for t in (7, 8, 9)] == pytest.approx([0.04, 0.02, 0.03])
    # a launch whose call the capture lost falls back on its device start
    ctx.capture = Capture((0.0, 3.0), _windows(3), ops, [0.38, 1.38, None])
    assert list(ctx.launches("fused_sinkhorn_kernel")) == [7, 8, 9]


def test_capture_joins_each_kernel_to_its_launch_call():
    """``trace.capture`` reads the host call of each device operation from
    the runtime event of the same correlation id (Chrome trace, us)."""
    def span(name, s, e):
        return {"cat": "user_annotation", "name": name, "ts": s * 1e6,
                "dur": (e - s) * 1e6}

    events = []
    for i in range(2):
        events += [span("bench.intake", i, i + 0.25),
                   span("bench.enqueue", i + 0.25, i + 0.5),
                   span("bench.resolve", i + 0.5, i + 1.0)]
    events += [
        {"cat": "cuda_runtime", "name": "cudaLaunchCooperativeKernel",
         "ts": 0.38e6, "dur": 10.0, "args": {"correlation": 5}},
        {"cat": "kernel", "name": "k", "ts": 0.4e6, "dur": 4e4,
         "args": {"correlation": 5}},
        {"cat": "cuda_driver", "name": "cuLaunchKernel",
         "ts": 1.38e6, "dur": 10.0, "args": {"correlation": 9}},
        {"cat": "kernel", "name": "k", "ts": 0.95e6, "dur": 2e4,
         "args": {"correlation": 9}},
        {"cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 1.6e6,
         "dur": 1e3, "args": {"correlation": 11}},
        # before the window: left out with its call
        {"cat": "kernel", "name": "k", "ts": -0.5e6, "dur": 1e3,
         "args": {"correlation": 2}},
    ]
    cap = capture(events, 2)
    assert cap.window == (0.0, 2.0)
    assert [o[0] for o in cap.ops] == pytest.approx([0.4, 0.95, 1.6])
    assert cap.launched[:2] == pytest.approx([0.38, 1.38])
    assert cap.launched[2] is None
