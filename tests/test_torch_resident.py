"""The resident delta tick in the PyTorch port against the JAX reference.

On the CPU the port's tick runs the plain version of the fused CUDA kernel
(``_resident_tick_impl``). It is held against the JAX ResidentScheduler on
a scripted multi-tick history — with JAX's XLA tick and with its fused
Pallas tick (kernel B1) under the Pallas interpreter — and against JAX's
jitted tick from identical imported state. Integer outputs and state
leaves must be exactly equal; sizes within 1e-6, as the JAX suite pins.
Then the twins of the JAX resident tests, on the port alone.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_faas.sched import resident as jres
from tpu_faas_torch.sched import fused_tick
from tpu_faas_torch.sched import resident as tres
from tpu_faas_torch.sched.state import SchedulerArrays
from tpu_faas_torch.tenancy import TenantTable

f32, i32 = np.float32, np.int32


class _Clock:
    def __init__(self, t=100.0):
        self.t = t

    def __call__(self):
        return self.t


_SMALL = dict(max_workers=32, max_pending=64, max_inflight=128, max_slots=4,
              KA=8, KP=16, KR=8)


def _jax(backend, clock=None, **kw):
    return jres.ResidentScheduler(clock=clock or _Clock(),
                                  tick_backend=backend, **{**_SMALL, **kw})


def _port(clock=None, **kw):
    return tres.ResidentScheduler(clock=clock or _Clock(), device="cpu",
                                  **{**_SMALL, **kw})


def _drive(rs, script):
    """Apply a scripted event history, returning per-tick resolved views."""
    views = []
    for ev in script:
        rs.clock.t += ev.get("dt", 0.1)
        for wid, procs, speed in ev.get("register", ()):
            rs.register(wid, procs, speed=speed)
        for wid in ev.get("hb", ()):
            rs.heartbeat(wid)
        for tid, size, *prio in ev.get("arrivals", ()):
            rs.pending_add(tid, size, *prio)
        for tid in ev.get("results", ()):
            row = rs.inflight_done(tid)
            if row is not None:
                rs.release_slot(row)
        rs.tick_resident()
        resolved = []
        while True:
            r = rs.resolve_next()
            if r is None:
                break
            resolved.append(r)
            for tid, row in r.placed:
                rs.inflight_add(tid, row)
        views.append(resolved)
    return views


# the JAX suite's scripted history (tests/test_sched_fused.py)
_SCRIPT = [
    {
        "register": [(b"w0", 4, 1.0), (b"w1", 4, 2.0), (b"w2", 2, 3.0)],
        "arrivals": [(f"t{i}", 0.5 + 0.25 * i) for i in range(6)],
    },
    {
        "hb": [b"w0", b"w1", b"w2"],
        "results": ["t0", "t3"],
        "arrivals": [("t6", 2.0), ("t7", 0.1)],
    },
    {"hb": [b"w0", b"w1"], "dt": 11.0, "arrivals": [("t8", 1.3)]},
    {
        "register": [(b"w2", 2, 3.0)],
        "hb": [b"w0", b"w1"],
        "arrivals": [("t9", 0.9), ("t10", 4.0)],
    },
]

# the same shape of history with priorities, ties, zero sizes and an
# over-KA burst (flush packets) — the dispatcher's use_priority=True path
_PRIO_SCRIPT = [
    {
        "register": [(b"w0", 2, 1.0), (b"w1", 3, 2.0), (b"w2", 2, 2.0)],
        "arrivals": [(f"p{i}", float(i % 3), i % 4) for i in range(11)],
    },
    {
        "hb": [b"w0", b"w1", b"w2"],
        "results": ["p0", "p4"],
        "arrivals": [("q0", 0.0, 9), ("q1", 2.0, 0)],
    },
    {"hb": [b"w0", b"w2"], "dt": 11.0, "arrivals": [("q2", 1.0, 3)]},
    {
        "register": [(b"w1", 3, 2.0)],
        "hb": [b"w0", b"w2"],
        "results": ["p8"],
        "arrivals": [("q3", 0.0, 1), ("q4", 4.0, 1)],
    },
]


def _flatten(views):
    return [
        (sorted(r.placed), sorted(r.redispatch_slots),
         sorted(int(x) for x in r.purged_rows), r.rejected, r.n_pending)
        for resolved in views for r in resolved
    ]


def _assert_states_match(js, ts):
    for field in ("valid", "prio", "free", "inflight", "prev_live",
                  "active", "last_hb", "speed"):
        np.testing.assert_array_equal(
            tres.to_host(getattr(ts, field)), np.asarray(getattr(js, field)),
            err_msg=field,
        )
    np.testing.assert_allclose(
        tres.to_host(ts.sizes), np.asarray(js.sizes), atol=1e-6
    )


@pytest.mark.parametrize("backend", ["xla", "fused_interpret"])
@pytest.mark.parametrize("script,use_priority", [
    (_SCRIPT, False), (_PRIO_SCRIPT, True),
], ids=["fcfs", "priority"])
def test_script_matches_jax(backend, script, use_priority):
    """The scripted history — arrivals, results, heartbeat churn, a purge
    and reconnect — resolves identically through the port and through
    JAX's XLA tick and its fused Pallas tick (B1, interpreted), and leaves
    identical state."""
    a = _jax(backend, use_priority=use_priority)
    b = _port(use_priority=use_priority)
    va, vb = _flatten(_drive(a, script)), _flatten(_drive(b, script))
    assert va == vb
    assert any(p for p, *_ in va) and any(rd for _, rd, *_ in va)
    _assert_states_match(a._r_state, b._r_state)


def _random_case(rng, use_priority, T=64, W=32, I=128, K=4, KA=8, KH=8,
                 KF=16, KI=16, KS=8, KB=8, hostile=False):
    """Random resident state leaves and one delta packet at a small shape:
    ties, zero sizes, dead workers, negative free deltas. ``hostile``
    adds negative and out-of-range indices and saturating counts."""
    now = 50.0
    leaves = dict(
        sizes=np.round(rng.uniform(0.0, 4.0, T)).astype(f32),
        valid=rng.random(T) < 0.6,
        prio=rng.integers(-2, 3, T).astype(i32),
        tenant=np.zeros(T, i32),
        last_hb=(now - rng.uniform(0.0, 12.0, W)).astype(f32),
        free=rng.integers(-1, K + 2, W).astype(i32),
        inflight=np.where(rng.random(I) < 0.5, -1,
                          rng.integers(0, W, I)).astype(i32),
        prev_live=rng.random(W) < 0.9,
        speed=np.round(rng.uniform(0.0, 4.0, W)).astype(f32),
        active=rng.random(W) < 0.9,
        price=np.zeros(W * K, f32),
        t_deficit=np.zeros(1, f32),
        infl_start=np.zeros(1, f32),
        infl_pred=np.zeros(1, f32),
        avoid=np.full(1, -1, i32),
        refresh=np.asarray(True),
    )
    lanes = 2 if use_priority else 1
    p = np.zeros(9 + KA * lanes + 2 * (KH + KF + KI + KS + KB), f32)
    counts = [int(rng.integers(1, k + 1)) for k in (KA, KH, KF, KI, KS, KB)]
    if hostile:
        counts[1] = KH  # the count saturates below: keep every lane real
    p[0], p[1:7], p[8] = now, counts, 10.0
    off = 9
    p[off : off + counts[0]] = np.round(rng.uniform(0.0, 4.0, counts[0]))
    off += KA
    if use_priority:
        p[off : off + counts[0]] = rng.integers(-2, 3, counts[0])
        off += KA
    for n, k, N, vals in (
        (counts[1], KH, W, lambda n: now - rng.uniform(0.0, 12.0, n)),
        (counts[2], KF, W, lambda n: rng.integers(-2, 3, n)),
        (counts[3], KI, I, lambda n: rng.integers(-1, W, n)),
        (counts[4], KS, W, lambda n: np.round(rng.uniform(0, 4, n))),
        (counts[5], KB, W, lambda n: (rng.random(n) < 0.8).astype(f32)),
    ):
        idx = rng.choice(N, n, replace=False)
        if hostile:
            # wrap-once negatives, and indices past either end (dropped)
            idx = np.where(rng.random(n) < 0.3, idx - N, idx)
            idx[0] = N + 3 if n > 1 else idx[0]
            idx[-1] = -N - 2 if n > 2 else idx[-1]
        p[off : off + n] = idx
        off += k
        p[off : off + n] = vals(n)
        off += k
    if hostile:
        p[2] = 1e10  # saturates to INT32_MAX: every lane of KH applies
        p[2 + 1] = -5.7  # truncates to -5: no free deltas
        p[1] = np.nan  # NaN converts to 0: no arrivals
    statics = dict(T=T, W=W, I=I, KA=KA, KH=KH, KF=KF, KI=KI, KS=KS, KB=KB,
                   use_priority=use_priority)
    return leaves, p, statics


def _compare_tick(leaves, packet, statics, KP=16, KR=8, K=4):
    jst = jres._ResidentState(**{k: jnp.asarray(v) for k, v in leaves.items()})
    want, wst = jres._resident_tick(
        jnp.asarray(packet), jst, **statics, KP=KP, KR=KR, max_slots=K,
        placement="rank",
    )
    tst = tres.state_from_numpy(leaves, "cpu")
    got, gst = fused_tick.fused_resident_tick(
        torch.from_numpy(packet), tst, **statics, KP=KP, KR=KR, max_slots=K,
    )
    for field in want._fields:
        np.testing.assert_array_equal(
            tres.to_host(getattr(got, field)),
            np.asarray(getattr(want, field)), err_msg=field,
        )
    w, g = {f: np.asarray(getattr(wst, f)) for f in wst._fields}, \
        tres.state_to_numpy(gst)
    for field in w:
        np.testing.assert_array_equal(g[field], w[field], err_msg=field)


@pytest.mark.parametrize("use_priority", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_one_tick_matches_jax_from_random_state(seed, use_priority):
    rng = np.random.default_rng(seed)
    _compare_tick(*_random_case(rng, use_priority, hostile=seed == 3))


@pytest.mark.parametrize("use_priority", [False, True])
def test_one_tick_from_imported_jax_state(use_priority):
    """A JAX scheduler's carried state, handed over leaf by leaf through
    ``state_from_numpy``, ticks identically in the port."""
    script = _PRIO_SCRIPT if use_priority else _SCRIPT
    a = _jax("xla", use_priority=use_priority)
    _drive(a, script)
    leaves = {f: np.asarray(getattr(a._r_state, f))
              for f in jres._ResidentState._fields}
    rng = np.random.default_rng(5)
    for i in range(5):
        a.pending_add(f"x{i}", float(rng.integers(0, 4)), int(i % 2))
    a.clock.t += 0.5
    a.heartbeat(b"w0")
    a.inflight_add("extra", 1)
    a.worker_free[1] -= 1
    take = list(a._arrivals)
    deltas = a._diff_deltas()
    packet = a._pack(a.clock.t - a._epoch, take,
                     *zip(deltas[::2], deltas[1::2]))
    statics = {k: v for k, v in a._statics().items()
               if k not in ("use_tenancy", "NT", "use_spec", "KG")}
    _compare_tick(leaves, packet, statics)


@pytest.mark.parametrize("use_priority", [False, True])
def test_flush_matches_jax(use_priority):
    leaves, packet, statics = _random_case(np.random.default_rng(9),
                                           use_priority)
    jst = jres._ResidentState(**{k: jnp.asarray(v) for k, v in leaves.items()})
    wst, warr = jres._flush_kernel(jnp.asarray(packet), jst, **statics)
    gst, garr = fused_tick.fused_resident_tick(
        torch.from_numpy(packet), tres.state_from_numpy(leaves, "cpu"),
        flush=True, **statics, KP=16, KR=8, max_slots=4,
    )
    np.testing.assert_array_equal(garr.numpy(), np.asarray(warr))
    g = tres.state_to_numpy(gst)
    for field in wst._fields:
        np.testing.assert_array_equal(g[field], np.asarray(getattr(wst, field)),
                                      err_msg=field)


def test_state_numpy_round_trip():
    leaves, _, _ = _random_case(np.random.default_rng(1), True)
    back = tres.state_to_numpy(tres.state_from_numpy(leaves, "cpu"))
    assert list(back) == list(jres._ResidentState._fields)
    for k, v in leaves.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_wrapper_validates_kernel_inputs():
    """The CUDA wrapper checks dtype, shape and contiguity before it
    builds or launches anything."""
    leaves, packet, statics = _random_case(np.random.default_rng(2), False)
    st = tres.state_from_numpy(leaves, "cpu")
    kw = dict(statics, KP=16, KR=8, max_slots=4, flush=False)
    with pytest.raises(ValueError, match="sizes"):
        fused_tick.KERNEL(torch.from_numpy(packet),
                          st._replace(sizes=st.sizes.double()), **kw)
    with pytest.raises(ValueError, match="packet"):
        fused_tick.KERNEL(torch.from_numpy(packet[:-1]), st, **kw)
    with pytest.raises(ValueError, match="inflight"):
        fused_tick.KERNEL(torch.from_numpy(packet),
                          st._replace(inflight=st.inflight[::2]), **kw)
    assert fused_tick.KERNEL.launches == 0


@pytest.mark.cuda
def test_fused_kernel_matches_plain_on_card():
    """The hand-written kernel against its plain version on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU form)")
    for seed in range(4):
        for use_priority in (False, True):
            leaves, packet, statics = _random_case(
                np.random.default_rng(seed), use_priority, hostile=seed == 3)
            kw = dict(statics, KP=16, KR=8, max_slots=4)
            st = tres.state_from_numpy(leaves, "cuda")
            want, wst = tres._resident_tick_impl(
                torch.from_numpy(packet).cuda(),
                tres.state_from_numpy(leaves, "cuda"), **kw)
            got, gst = fused_tick.fused_resident_tick(
                torch.from_numpy(packet).cuda(), st, **kw)
            for a, b in zip(got, want):
                assert torch.equal(a, b)
            for a, b in zip(gst, wst):
                assert torch.equal(a, b)


# -- twins of tests/test_sched_resident.py, on the port alone --------------
def _mk(max_workers=16, max_pending=64, max_inflight=32, **kw):
    clock_box = [100.0]
    r = tres.ResidentScheduler(
        max_workers=max_workers, max_pending=max_pending,
        max_inflight=max_inflight, max_slots=4, time_to_expire=10.0,
        clock=lambda: clock_box[0], device="cpu", **kw,
    )
    r._clock_box = clock_box
    return r


def _drain(r):
    out = []
    while (res := r.resolve_next()) is not None:
        out.append(res)
    return out


def test_resident_places_like_batch_tick():
    r = _mk()
    plain = SchedulerArrays(max_workers=16, max_pending=64, max_slots=4,
                            time_to_expire=10.0, clock=lambda: 100.0,
                            device="cpu")
    rng = np.random.default_rng(0)
    speeds = rng.uniform(0.5, 4.0, 6)
    for i in range(6):
        r.register(b"w%d" % i, 1 + i % 3, speed=float(speeds[i]))
        plain.register(b"w%d" % i, 1 + i % 3, speed=float(speeds[i]))
    sizes = rng.uniform(0.5, 5.0, 20).astype(f32)
    for i, s in enumerate(sizes):
        r.pending_add(f"t{i}", float(s))
    r.tick_resident()
    res = _drain(r)[-1]
    ref_a = plain.tick(sizes).assignment.numpy()[:20]
    assert dict(res.placed) == {f"t{i}": int(w) for i, w in enumerate(ref_a)
                                if w >= 0}
    assert res.n_pending == 20 - len(res.placed)


def test_resident_purge_and_redispatch():
    r = _mk()
    for i in range(2):
        r.register(b"w%d" % i, 2, speed=1.0)
    for i in range(4):
        r.pending_add(f"t{i}", 1.0)
    r.tick_resident()
    placed = _drain(r)[-1].placed
    slots = {tid: r.inflight_add(tid, row) for tid, row in placed}
    r._clock_box[0] += 11.0
    r.heartbeat(b"w1")
    r.tick_resident()
    res = _drain(r)[-1]
    assert list(res.purged_rows) == [0]
    assert set(res.redispatch_slots) == {slots[t] for t, row in placed
                                         if row == 0}


def test_resident_pipelined_ticks_never_double_book():
    r = _mk()
    for i in range(2):
        r.register(b"w%d" % i, 2, speed=1.0)
    for i in range(4):
        r.pending_add(f"a{i}", 1.0)
    r.tick_resident()
    for i in range(4):
        r.pending_add(f"b{i}", 1.0)
    r.tick_resident()  # issued before any resolve
    first, second = r.resolve_next(), r.resolve_next()
    assert len(first.placed) == 4 and len(second.placed) == 0
    assert r.worker_free[:2].sum() == 0


def test_result_arrival_between_tick_and_resolve_cannot_overbook():
    r = _mk()
    r.register(b"w0", 2)
    r.inflight_add("busy", 0)
    r.worker_free[0] = 1
    r.pending_add("a", 1.0)
    r.tick_resident()
    row = r.inflight_done("busy")
    r.release_slot(row)
    r.pending_add("b", 1.0)
    r.pending_add("c", 1.0)
    r.tick_resident()
    placed = [p for res in _drain(r) for p in res.placed]
    assert len(placed) == 2 and "a" in {t for t, _ in placed}


def test_overflow_flush_counts_dispatches():
    r = _mk(KA=8)
    r.register(b"w0", 4, speed=1.0)
    for i in range(20):  # KA = 8 -> 2 flushes + the tick
        r.pending_add(f"t{i}", 1.0)
    r.tick_resident()
    assert r.device_dispatches_last_tick == 3
    assert r.device_dispatches_total == 3
    results = _drain(r)
    assert sum(len(x.placed) for x in results) == 4


def test_buffer_full_rejects_and_requeues_fcfs():
    r = _mk(max_pending=8, max_workers=4, KA=4)
    r.register(b"w0", 0, speed=1.0)  # no capacity: occupants never leave
    for i in range(8):
        r.pending_add(f"occ{i}", 1.0)
    r.tick_resident()
    _drain(r)
    for i in range(10):
        r.pending_add(f"t{i}", 1.0)
    r.tick_resident()
    assert sum(res.rejected for res in _drain(r)) == 10
    assert [a.task_id for a in r._rejected] == [f"t{i}" for i in range(10)]
    r.tick_resident()
    _drain(r)
    assert [a.task_id for a in r._rejected] == [f"t{i}" for i in range(10)]


def test_kp_compaction_replaces_surplus_next_tick():
    r = _mk(KP=2)
    for i in range(3):
        r.register(b"w%d" % i, 2, speed=1.0)
    for i in range(6):
        r.pending_add(f"t{i}", 1.0)
    seen = []
    for _ in range(3):
        r.tick_resident()
        seen += _drain(r)[-1].placed
    assert sorted(t for t, _ in seen) == sorted(f"t{i}" for i in range(6))


def test_priority_admission():
    r = _mk(use_priority=True, max_workers=4)
    r.register(b"w0", 2, speed=1.0)
    for tid, p in (("lo1", 0), ("lo2", 0), ("hi1", 5), ("hi2", 5)):
        r.pending_add(tid, 1.0, priority=p)
    r.tick_resident()
    assert {t for t, _ in _drain(r)[-1].placed} == {"hi1", "hi2"}


def test_heartbeat_epoch_rebase_keeps_deltas_flowing():
    r = _mk()
    r.register(b"w0", 2)
    r.pending_add("a", 1.0)
    r.tick_resident()
    _drain(r)
    epoch0 = r._epoch
    r._clock_box[0] += tres.ResidentScheduler.EPOCH_REBASE_S + 12_345.0
    r.heartbeat(b"w0")
    r.pending_add("b", 1.0)
    out = r.tick_resident()
    res = _drain(r)[-1]
    assert r._epoch > epoch0
    assert not out.purged.any()
    assert len(res.placed) == 1
    r._clock_box[0] += 0.25
    r.heartbeat(b"w0")
    assert not r.tick_resident().purged.any()


def test_delta_replay_equivalence():
    """A tick driven by an accumulated delta history equals a tick driven
    by full state rebuilt from the host mirrors (bulk load)."""
    a = _port()
    _drive(a, _SCRIPT)
    b = _port(clock=a.clock)
    b.worker_speed[:] = a.worker_speed
    b.worker_free[:] = a.worker_free
    b.worker_active[:] = a.worker_active
    b.worker_procs[:] = a.worker_procs
    b.last_heartbeat[:] = a.last_heartbeat
    b.prev_live = a.prev_live.clone()
    b.inflight_worker[:] = a.inflight_worker
    b.worker_ids, b.row_ids = dict(a.worker_ids), dict(a.row_ids)
    slots = sorted(a.slot_task)
    b.pending_bulk_load([a.slot_task[s] for s in slots],
                        np.asarray([a._slot_meta[s].size for s in slots], f32))
    for rs in (a, b):
        rs.pending_add("fresh1", 0.77)
        rs.pending_add("fresh2", 1.9)
    a.clock.t += 0.05
    out_a, out_b = a.tick_resident(), b.tick_resident()
    placed = [sorted(p for r in _drain(x) for p in r.placed) for x in (a, b)]
    assert placed[0] == placed[1]
    assert int(out_a.n_pending) == int(out_b.n_pending)
    assert torch.equal(out_a.live, out_b.live)


@pytest.mark.parametrize("kw", [
    dict(spec_mult=2.0, tenancy=TenantTable(max_tenants=4)),
    dict(spec_mult=2.0),
])
def test_unported_planes_raise(kw):
    """Speculation is ported, with the tenancy plane on or off: the
    scheduler builds its spec leaves and a hedge lands off its avoid row
    (the parity with JAX is in tests/test_torch_fused_spec.py)."""
    r = _mk(**kw)
    assert r.use_spec and r.KG == 32  # min(64, max_inflight)
    r.register(b"w0", 4, speed=4.0)
    r.register(b"w1", 4, speed=1.0)
    r.pending_add("hedge", 1.0, avoid=0)
    r.tick_resident()
    (res,) = _drain(r)
    assert res.placed == [("hedge", 1)] and res.straggler_slots == []
    assert r._r_state.infl_pred.shape == (32,)
    assert r._r_state.avoid.shape == (64,)
