"""The resident scheduler's spans and counters (``obs/profile.py``'s span
recorder): nothing recorded and no ``record_function`` entered without a
``torch.profiler`` capture; under one, the tick's diff, pack and launch
spans inside ``tick_resident`` and resolve's wait before its mapping, in
the span log and the Chrome trace alike; a span per flush packet; B1's
auction counts as its outputs hold them; and the benchmark's readers of
the log on its cut cells, the program's spans inside the harness's."""

import json
import sys
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tpu_faas_torch.obs import profile as obs_profile
from tpu_faas_torch.obs.profile import (
    COUNT_AUCTION_FULL_LENGTH,
    COUNT_AUCTION_ROUNDS,
    COUNT_AUCTION_SPILLED,
    COUNT_PLACED,
    SPAN_DIFF,
    SPAN_LAUNCH,
    SPAN_LOG,
    SPAN_PACK,
    SPAN_RESOLVE_MAP,
    SPAN_RESOLVE_WAIT,
    SpanLog,
    tracing,
)
from tpu_faas_torch.sched.resident import ResidentScheduler

SPANS = (SPAN_DIFF, SPAN_PACK, SPAN_LAUNCH, SPAN_RESOLVE_WAIT,
         SPAN_RESOLVE_MAP)
PLACEMENTS = ("rank", "auction", "sinkhorn")


def _mk(placement="rank", **kw):
    clock_box = [100.0]
    rs = ResidentScheduler(
        max_workers=16, max_pending=64, max_inflight=64, max_slots=4,
        time_to_expire=10.0, clock=lambda: clock_box[0], device="cpu",
        placement=placement, **kw,
    )
    rs._clock_box = clock_box
    for i in range(4):
        rs.register(f"w{i}".encode(), 4, speed=1.0 + i)
    return rs


def _tick(rs, arrivals, k):
    """One tick as the dispatcher drives it; returns the host stamps
    (enqueue start, resolve start, resolve end), the tick's output and its
    resolved ticks."""
    rs._clock_box[0] += 0.1
    for i in range(arrivals):
        rs.pending_add(f"t{k}.{i}", 0.5 + 0.25 * i)
    t0 = time.perf_counter()
    out = rs.tick_resident()
    t1 = time.perf_counter()
    resolved = []
    while (res := rs.resolve_next()) is not None:
        for tid, row in res.placed:
            rs.inflight_add(tid, row)
        resolved.append(res)
    t2 = time.perf_counter()
    return (t0, t1, t2), out, resolved


def _within(lo, hi):
    return [e for e in SPAN_LOG.entries if lo <= e[1] <= hi]


def _no_record_function(*a, **kw):
    raise AssertionError("record_function entered with no capture running")


@pytest.mark.parametrize("placement", PLACEMENTS)
def test_no_capture_records_nothing(placement, monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function",
                        _no_record_function)
    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        _no_record_function)
    SPAN_LOG.clear()
    rs = _mk(placement, KA=4)
    assert not tracing()
    placed = 0
    for k in range(4):
        # 6 arrivals over KA = 4: a flush packet each tick too
        _, _, resolved = _tick(rs, 6, k)
        placed += sum(len(r.placed) for r in resolved)
    assert placed > 0
    assert len(SPAN_LOG) == 0 and SPAN_LOG.appended == 0


def test_tracing_follows_the_profiler():
    assert not tracing()
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    try:
        assert tracing()
    finally:
        prof.stop()
    assert not tracing()


def test_span_log_keeps_the_newest_and_counts_the_dropped():
    log = SpanLog(capacity=4)
    for i in range(10):
        log.append(("x", float(i), float(i) + 0.5))
    assert len(log) == 4 and log.dropped == 6 and log.appended == 10
    assert [e[1] for e in log.entries] == [6.0, 7.0, 8.0, 9.0]
    assert log.nbytes() > 0
    log.clear()
    assert len(log) == 0 and log.dropped == 0
    assert obs_profile.SPAN_LOG_CAPACITY >= 1 << 18
    assert SPAN_LOG.entries.maxlen == obs_profile.SPAN_LOG_CAPACITY


@pytest.mark.parametrize("placement", PLACEMENTS)
def test_spans_nest_in_the_tick_under_a_capture(placement, tmp_path):
    rs = _mk(placement)
    _tick(rs, 5, -1)  # the state's first upload, before the capture
    SPAN_LOG.clear()
    stamps = []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for k in range(3):
            stamps.append(_tick(rs, 5, k)[0])
    for t0, t1, t2 in stamps:
        enq = _within(t0, t1)
        assert [e[0] for e in enq] == [SPAN_DIFF, SPAN_PACK, SPAN_LAUNCH]
        assert all(t0 <= e[1] <= e[2] <= t1 for e in enq)
        # spans in order, none overlapping
        assert all(a[2] <= b[1] for a, b in zip(enq, enq[1:]))
        res = [e for e in _within(t1, t2) if e[0] in SPANS]
        assert [e[0] for e in res] == [SPAN_RESOLVE_WAIT, SPAN_RESOLVE_MAP]
        wait, mapping = res
        assert t1 <= wait[1] <= wait[2] <= mapping[1] <= mapping[2] <= t2
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    names = {e.get("name") for e in events
             if e.get("cat") == "user_annotation"}
    assert set(SPANS) <= names
    # each tick's spans, three ticks
    for name in SPANS:
        assert sum(1 for e in events if e.get("name") == name
                   and e.get("cat") == "user_annotation") == 3, name


def test_overflow_burst_spans_each_flush_packet():
    rs = _mk(KA=8)
    SPAN_LOG.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        (t0, t1, t2), _, resolved = _tick(rs, 20, 0)  # 2 flushes + the tick
    assert rs.device_dispatches_last_tick == 3
    names = [e[0] for e in _within(t0, t1)]
    assert names == [SPAN_DIFF] + [SPAN_PACK, SPAN_LAUNCH] * 3
    # each flush and the tick resolve: a wait and a mapping each, the
    # placements counted on the tick alone
    res = [e[0] for e in _within(t1, t2)]
    assert res.count(SPAN_RESOLVE_WAIT) == len(resolved) == 3
    assert res.count(SPAN_RESOLVE_MAP) == 3
    placed = [e[2] for e in _within(t1, t2) if e[0] == COUNT_PLACED]
    assert placed == [len(resolved[-1].placed)]


@pytest.mark.parametrize("arrivals", [0, 6])
def test_auction_counters_equal_the_tick_outputs(arrivals):
    rs = _mk("auction")
    _tick(rs, 6, -1)
    SPAN_LOG.clear()
    for k in range(3):
        with profile(activities=[ProfilerActivity.CPU]):
            (_, t1, t2), out, resolved = _tick(rs, arrivals, k)
        got = {e[0]: e[2] for e in _within(t1, t2) if e[0] not in SPANS}
        assert got == {
            COUNT_PLACED: len(resolved[0].placed),
            COUNT_AUCTION_ROUNDS: int(out.auction_rounds),
            COUNT_AUCTION_SPILLED: int(out.auction_spilled),
        }


@pytest.mark.parametrize("word", [None, 0, 1], ids=["plain", "lists",
                                                     "full-length"])
def test_full_length_counter_is_the_kernels_word(word, monkeypatch):
    """B1's fourth aux word (the card's auction: 1 on a tick that took the
    full-length path) becomes the counter, read back with the rounds, only
    while a capture runs; the plain version has no such word (None) and
    the counter is absent."""
    from tpu_faas_torch.sched import fused_tick

    if word is not None:
        plain = fused_tick.fused_resident_tick

        def card_like(packet, st, *, flush=False, **kw):
            out = plain(packet, st, flush=flush, **kw)
            if flush:
                return out
            res, new = out
            return res._replace(auction_full_length=torch.tensor(
                word, dtype=torch.int32)), new

        monkeypatch.setattr(fused_tick, "fused_resident_tick", card_like)
    rs = _mk("auction")
    _tick(rs, 6, -1)
    SPAN_LOG.clear()
    _, out, _ = _tick(rs, 6, 0)
    assert len(SPAN_LOG) == 0  # no capture, no counter
    assert (out.auction_full_length is None) == (word is None)
    with profile(activities=[ProfilerActivity.CPU]):
        (_, t1, t2), out, resolved = _tick(rs, 6, 1)
    got = {e[0]: e[2] for e in _within(t1, t2) if e[0] not in SPANS}
    want = {
        COUNT_PLACED: len(resolved[0].placed),
        COUNT_AUCTION_ROUNDS: int(out.auction_rounds),
        COUNT_AUCTION_SPILLED: int(out.auction_spilled),
    }
    if word is not None:
        want[COUNT_AUCTION_FULL_LENGTH] = word
    assert got == want


def test_rank_and_sinkhorn_ticks_count_placements_alone():
    for placement in ("rank", "sinkhorn"):
        rs = _mk(placement)
        SPAN_LOG.clear()
        with profile(activities=[ProfilerActivity.CPU]):
            _, _, resolved = _tick(rs, 6, 0)
        counters = [(e[0], e[2]) for e in SPAN_LOG.entries
                    if e[0] not in SPANS]
        assert counters == [(COUNT_PLACED, len(resolved[0].placed))]


# -- the benchmark's readers on its cut cells, traced on the CPU -----------

NEW_METRICS = ("diff_ms", "pack_ms", "launch_ms", "resolve_wait_ms",
               "resolve_map_ms")
AUCTION_METRICS = ("b1_auction_rounds", "b1_auction_spilled_pct")


@pytest.fixture(scope="module")
def small():
    from benchmark import spec

    sys.path.insert(0, str(spec.HERE / "tests"))
    try:
        import small_cells
    finally:
        sys.path.pop(0)
    return small_cells


@pytest.mark.parametrize("cell", ["auction", "sinkhorn"])
def test_benchmark_readers_on_the_cut_cells(cell, small):
    from benchmark import spec
    from benchmark import trace as tracing
    from benchmark.context import Context

    name = small.AUCTION if cell == "auction" else small.SINKHORN
    # the auction's plain bid takes about a second a tick on the CPU
    r = small.run_small(name, trace=True,
                        seconds=2.5 if cell == "auction" else 1.0)
    assert r["verdict"].correct
    capture = tracing.capture(r["events"], len(r["ticks"]))
    ctx = Context(small.small_cell(name).config, r["stamps"], r["ticks"],
                  r["verdict"].work, capture)
    metrics = NEW_METRICS + (AUCTION_METRICS if cell == "auction" else ())
    values = {m: spec.metric_reader(m).read(ctx) for m in metrics}
    assert all(v is not None for v in values.values()), values
    # every cell that lists a metric gets a value from it
    bench = spec.load_benchmark()
    listed = {m["name"] for m in bench["per_layer"]
              if spec.applies(m, name)}
    assert set(metrics) <= listed
    if cell == "sinkhorn":
        assert not listed & set(AUCTION_METRICS)

    # tick by tick, the program's spans lie inside the harness's: the
    # same clock, so no tolerance
    st = r["stamps"]
    for t0, t1, t2, t3 in st:
        enq = [e for e in _within(t1, t2) if e[0] in SPANS]
        res = [e for e in _within(t2, t3) if e[0] in SPANS]
        assert {e[0] for e in enq} == {SPAN_DIFF, SPAN_PACK, SPAN_LAUNCH}
        assert {e[0] for e in res} == {SPAN_RESOLVE_WAIT, SPAN_RESOLVE_MAP}
        assert sum(e[2] - e[1] for e in enq) <= t2 - t1
        assert all(e[2] <= t2 for e in enq)
        assert sum(e[2] - e[1] for e in res) <= t3 - t2
        assert all(e[2] <= t3 for e in res)
    # and so over the window
    n = len(r["ticks"])
    enqueue_ms = 1e3 * float(np.sum(st[:, 2] - st[:, 1])) / n
    resolve_ms = 1e3 * float(np.sum(st[:, 3] - st[:, 2])) / n
    assert (values["diff_ms"] + values["pack_ms"] + values["launch_ms"]
            <= enqueue_ms)
    assert values["resolve_wait_ms"] + values["resolve_map_ms"] <= resolve_ms
    if cell == "auction":
        # B1's own round count is the reference's, tick for tick
        want = [ctx.work[k][0] for k in r["ticks"]]
        assert values["b1_auction_rounds"] == sum(want) / len(want)
        assert 0.0 <= values["b1_auction_spilled_pct"] <= 100.0
        # the plain version has no compacted path, so no full-length count
        full = spec.metric_reader("b1_auction_full_length_pct")
        assert full.read(ctx) is None
