"""The resident tick's speculation lane in the PyTorch port against the TPU
kernel.

The JAX side is the fused Pallas resident tick (kernel B1) with
``use_spec=True``, run the way the JAX suite runs it on the CPU: under the
Pallas interpreter (``tick_backend="fused_interpret"``). The port side is
``ResidentScheduler(spec_mult=...)`` and ``fused_tick.fused_resident_tick``
on the CPU, which run the plain version of the port's CUDA kernel. In every
placement, with the tenancy lane on and off, every integer output and state
leaf must be exactly equal, the straggler slots, ``avoid`` and
``infl_start``/``infl_pred`` included; ``price`` keeps the bid kernel's
1e-5 and ``t_deficit`` its rtol of 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_fused_auction import _case
from tpu_faas.sched import pallas_fused as jfused
from tpu_faas.sched import resident as jres
from tpu_faas.tenancy import TenantTable as JTable
from tpu_faas_torch.sched import fused_tick
from tpu_faas_torch.sched import resident as tres
from tpu_faas_torch.tenancy import TenantTable

f32, i32 = np.float32, np.int32
PLACEMENTS = ["rank", "auction", "sinkhorn"]
MULT, MIN_S = 3.0, 0.02


def _spec_case(seed, use_priority, tenancy, KG=8, NT=5, **shape):
    """``_case``'s hostile state and packet with the speculation lane (and,
    with ``tenancy``, the tenancy lane): in-flight slots past, at and under
    their threshold, on dead rows, with pred <= 0 and NaN; the avoid leaf
    and the arrivals' avoid lane on the fastest workers (so the veto
    fires), on -1 and past both ends; the pred lane on the in-flight
    scatter, clears and wrapped negative indices included."""
    leaves, packet, statics = _case(seed, use_priority, seed % 2 == 0,
                                    hostile=True, **shape)
    rng = np.random.default_rng(200 + seed)
    T, W, I, KA, KI = (statics[k] for k in ("T", "W", "I", "KA", "KI"))
    now = float(packet[0])
    pred = rng.choice(np.array([0.0, -1.0, 0.01, 0.5, 1.0, 2.0], f32), I)
    pred[:2] = np.nan
    elapsed = rng.choice(np.array([0.0, 1.0, 3.0, 3.5, 9.0], f32), I) * pred
    elapsed = np.where(np.isnan(elapsed), 1.0, elapsed)
    elapsed[rng.random(I) < 0.15] = MIN_S  # at the floor: never past it
    leaves["infl_start"] = (now - elapsed).astype(f32)
    leaves["infl_pred"] = pred
    fastest = np.flatnonzero(leaves["speed"] == leaves["speed"].max())
    leaves["avoid"] = np.where(rng.random(T) < 0.6, rng.choice(fastest, T),
                               rng.integers(-2, W + 2, T)).astype(i32)
    lanes = 2 if use_priority else 1
    cut = 9 + KA * lanes
    infl_end = cut + 2 * (statics["KH"] + statics["KF"] + KI)
    arr_avoid = np.where(rng.random(KA) < 0.5, rng.choice(fastest, KA),
                         rng.integers(-2, W + 2, KA)).astype(f32)
    pred_lane = rng.choice(np.array([0.0, 0.5, 1.0, -3.0, np.nan], f32), KI)
    head, middle, rest = packet[:cut], packet[cut:infl_end], packet[infl_end:]
    ten_lane, ten_tail = [], []
    statics = dict(statics, use_spec=True, KG=KG)
    if tenancy:
        leaves["tenant"] = rng.integers(-1, NT + 1, T).astype(i32)
        leaves["t_deficit"] = rng.choice(
            np.array([0.0, 1.5, 1023.0, 1024.0, 4096.0], f32), NT)
        ten_lane = [rng.integers(-2, NT + 2, KA).astype(f32)]
        share = rng.choice(np.array([8.0, 1.0, 2.0, 0.5], f32), NT)
        ahead = rng.integers(0, 6, NT).astype(f32)
        cap = np.where(rng.random(NT) < 0.5, 0, ahead + 2).astype(f32)
        ten_tail = [share, ahead, cap]
        statics.update(use_tenancy=True, NT=NT)
    packet = np.concatenate([head, *ten_lane, arr_avoid, middle, pred_lane,
                             rest, np.array([MULT, MIN_S], f32),
                             *ten_tail]).astype(f32)
    return leaves, packet, statics


def _tick_both(leaves, packet, statics, placement):
    jst = jres._ResidentState(**{k: jnp.asarray(v) for k, v in leaves.items()})
    want, wst = jfused.fused_resident_tick(
        jnp.asarray(packet), jst, interpret=True, placement=placement,
        **statics)
    got, gst = fused_tick.fused_resident_tick(
        torch.from_numpy(packet), tres.state_from_numpy(leaves, "cpu"),
        placement=placement, **statics)
    return want, wst, got, gst


def _assert_state_matches(wst, gst):
    g = tres.state_to_numpy(gst)
    for field in wst._fields:
        w = np.asarray(getattr(wst, field))
        if field == "t_deficit":
            np.testing.assert_allclose(g[field], w, rtol=1e-6, atol=0)
        elif field == "price":
            np.testing.assert_allclose(g[field], w, rtol=0, atol=1e-5)
        else:  # bit for bit: NaN where JAX has NaN
            np.testing.assert_array_equal(g[field], w, err_msg=field)


@pytest.mark.parametrize("tenancy", [False, True], ids=["flat", "tenancy"])
@pytest.mark.parametrize("placement", PLACEMENTS)
@pytest.mark.parametrize("seed", [0, 1])
def test_spec_tick_matches_fused_kernel(seed, placement, tenancy):
    """One resident tick with the speculation lane from a hostile random
    state: every output and state leaf against the TPU kernel under the
    Pallas interpreter."""
    leaves, packet, statics = _spec_case(seed, seed == 1, tenancy)
    want, wst, got, gst = _tick_both(leaves, packet, statics, placement)
    for field in want._fields:
        np.testing.assert_array_equal(tres.to_host(getattr(got, field)),
                                      np.asarray(getattr(want, field)),
                                      err_msg=field)
    _assert_state_matches(wst, gst)
    strag = got.straggler_slots.numpy()
    assert (strag >= 0).any() and len(strag) == statics["KG"]
    # no placed task sits on its avoid row
    st = tres.state_to_numpy(gst)
    ps, pr = got.placed_slots.numpy(), got.placed_rows.numpy()
    assert (ps >= 0).any()
    assert not (st["avoid"][ps[ps >= 0]] == pr[ps >= 0]).any()


def test_spec_tick_k_bound_binds():
    """More vetoed rows than the fixup's 64 (each pending task avoids the
    row rank gives it) and more stragglers than KG: both bounds bind,
    against JAX. The free counts are over the cap and the fixup reads them
    raw, so one row takes more than max_slots hedges."""
    leaves, packet, statics = _spec_case(3, True, False, KG=4, T=256, W=32)
    statics["KP"] = 256
    leaves["valid"][:] = True
    leaves["free"][:] = 200
    leaves["active"][:] = True
    leaves["last_hb"][:] = float(packet[0])
    leaves["avoid"][:] = -1
    first, _ = fused_tick.fused_resident_tick(
        torch.from_numpy(packet), tres.state_from_numpy(leaves, "cpu"),
        **statics)
    ps, pr = first.placed_slots.numpy(), first.placed_rows.numpy()
    leaves["avoid"][ps[ps >= 0]] = pr[ps >= 0]
    assert (ps >= 0).sum() > 64 + 8
    want, wst, got, gst = _tick_both(leaves, packet, statics, "rank")
    rows = got.placed_rows.numpy()
    assert np.bincount(rows[rows >= 0]).max() > statics["max_slots"]
    for field in want._fields:
        np.testing.assert_array_equal(tres.to_host(getattr(got, field)),
                                      np.asarray(getattr(want, field)),
                                      err_msg=field)
    _assert_state_matches(wst, gst)
    assert (got.straggler_slots.numpy() >= 0).all()


@pytest.mark.parametrize("use_priority", [False, True])
def test_spec_flush_matches_jax(use_priority):
    """The flush path's avoid and pred lanes, against JAX's flush."""
    leaves, packet, statics = _spec_case(4, use_priority, True)
    flush = {k: v for k, v in statics.items() if k not in ("KP", "KR",
                                                            "max_slots")}
    jst = jres._ResidentState(**{k: jnp.asarray(v) for k, v in leaves.items()})
    wst, warr = jres._flush_kernel(jnp.asarray(packet), jst, **flush)
    gst, garr = fused_tick.fused_resident_tick(
        torch.from_numpy(packet), tres.state_from_numpy(leaves, "cpu"),
        flush=True, **statics)
    np.testing.assert_array_equal(garr.numpy(), np.asarray(warr))
    _assert_state_matches(wst, gst)
    g = tres.state_to_numpy(gst)
    assert not np.array_equal(g["infl_start"], leaves["infl_start"])


def _script(make, placement, use_priority, tenancy):
    """The JAX suite's speculation script (tests/test_spec.py): dispatch,
    stamp a prediction, advance past the threshold, hedge with the
    original's row to avoid. Returns the observables."""
    t = [0.0]
    kw = dict(max_workers=4, max_pending=16, max_inflight=32, max_slots=2,
              time_to_expire=100.0, clock=lambda: t[0],
              use_priority=use_priority, spec_mult=2.0, spec_min_s=0.01,
              placement=placement)
    if tenancy is not None:
        kw["tenancy"] = tenancy(shares={"a": 2.0, "b": 1.0}, max_tenants=4)
    a = make(**kw)
    a.register(b"w0", 2)
    a.register(b"w1", 2, speed=2.0)
    a.pending_add("t0", 1.0)
    a.pending_add("t1", 3.0, 1, 1)
    a.tick_resident()
    r = a.resolve_next()
    placed1 = sorted(r.placed)
    for tid, row in r.placed:
        a.inflight_add(tid, row, pred=0.1 if tid == "t0" else 0.0)
    t[0] += 1.0
    a.tick_resident()
    r = a.resolve_next()
    assert not r.straggler_slots  # the stamp applies this tick
    t[0] += 5.0
    a.tick_resident()
    r = a.resolve_next()
    flagged = list(r.straggler_slots)
    orig_row = int(a.inflight_worker[flagged[0]]) if flagged else -1
    a.pending_add("t0", 1.0, avoid=orig_row)
    a.pending_add("t2", 2.0, avoid=orig_row)
    a.tick_resident()
    r2 = a.resolve_next()
    return (placed1, flagged, orig_row, sorted(r2.placed),
            a.resolve_next())


@pytest.mark.parametrize("tenancy", [False, True], ids=["flat", "tenancy"])
@pytest.mark.parametrize("use_priority", [False, True])
@pytest.mark.parametrize("placement", PLACEMENTS)
def test_resident_spec_script_matches_fused_kernel(placement, use_priority,
                                                   tenancy):
    def jax_rs(**kw):
        return jres.ResidentScheduler(tick_backend="fused_interpret", **kw)

    def port_rs(**kw):
        return tres.ResidentScheduler(device="cpu", **kw)

    want = _script(jax_rs, placement, use_priority,
                   JTable if tenancy else None)
    got = _script(port_rs, placement, use_priority,
                  TenantTable if tenancy else None)
    assert got == want
    assert got[1], "no straggler flagged"
    # the hedge placed, and not on the original's row
    assert got[3] and all(row != got[2] for _, row in got[3])


def _packet_len_case(make, spec, **kw):
    return make(max_workers=4, max_pending=16, max_inflight=32, max_slots=2,
                use_priority=True, **(dict(spec_mult=2.0) if spec else {}),
                **kw)


def test_resident_spec_off_packet_unchanged():
    """Speculation off leaves the packet as it was (no avoid lane, no pred
    lane, no tail) and the straggler output a length-1 pad; on adds
    KA + KI + 2, in both packages."""
    for make in (jres.ResidentScheduler,
                 lambda **kw: tres.ResidentScheduler(device="cpu", **kw)):
        off = _packet_len_case(make, False)
        expected = 9 + off.KA * 2 + 2 * (off.KH + off.KF + off.KI + off.KS
                                         + off.KB)
        assert off.packet_len() == expected
        assert off.KG == 1
        on = _packet_len_case(make, True)
        assert on.packet_len() == expected + on.KA + on.KI + 2
        assert on.KG == 32  # min(64, max_inflight)
        ten = _packet_len_case(make, True, tenancy=(
            JTable if make is jres.ResidentScheduler else TenantTable)(
                max_tenants=3))
        assert ten.packet_len() == expected + ten.KA * 2 + ten.KI + 2 + 9


def _roundtrip(make, KA, KI):
    """Arrivals with avoid rows and predicted dispatches ride the packet
    (KA and KI small: flush packets carry the surplus of both lanes)."""
    clock = [50.0]
    r = make(max_workers=4, max_pending=16, max_inflight=16, max_slots=4,
             time_to_expire=10.0, clock=lambda: clock[0], use_priority=True,
             spec_mult=2.0, spec_min_s=0.01, KA=KA, KI=KI)
    r.register(b"w0", 4, speed=4.0)
    r.register(b"w1", 4, speed=1.0)
    r.tick_resident()  # the state exists: later dispatches ride the packet
    for i in range(5):
        r.inflight_add(f"x{i}", i % 2, pred=0.1 * (i + 1))
    for i in range(5):
        r.pending_add(f"a{i}", 1.0 + i, 0, avoid=0 if i % 2 else -1)
    r.tick_resident()
    clock[0] += 1.0
    r.inflight_done("x1")
    r.tick_resident()
    log = []
    while (res := r.resolve_next()) is not None:
        log.append((sorted(res.placed), res.straggler_slots, res.rejected))
    st = {k: tres.to_host(v) if isinstance(v, torch.Tensor) else np.asarray(v)
          for k, v in r._r_state._asdict().items()}
    return log, st, r.device_dispatches_total


@pytest.mark.parametrize("KA,KI", [(8, 8), (2, 2)],
                         ids=["one-packet", "flushes"])
def test_resident_spec_packet_roundtrip(KA, KI):
    got = _roundtrip(lambda **kw: tres.ResidentScheduler(device="cpu", **kw),
                     KA, KI)
    want = _roundtrip(lambda **kw: jres.ResidentScheduler(
        tick_backend="fused_interpret", **kw), KA, KI)
    assert got[0] == want[0]
    assert got[2] == want[2]
    if KA == 2:
        assert got[2] > 2  # flush packets carried the surplus
    for leaf in ("avoid", "infl_start", "infl_pred", "inflight", "free"):
        np.testing.assert_array_equal(got[1][leaf], want[1][leaf],
                                      err_msg=leaf)
    assert any(s for _, s, _ in got[0]), "no straggler flagged"
    # the odd arrivals avoided row 0, the fast one: none landed there
    placed = dict(p for ps, _, _ in got[0] for p in ps)
    assert all(placed[f"a{i}"] != 0 for i in (1, 3) if f"a{i}" in placed)


def _rebase(make):
    """Slots dispatched before an epoch rebase keep their old-epoch stamp,
    so their elapsed time is understated and they cannot flag until they
    are rewritten; a slot dispatched after the rebase flags."""
    t = [1000.0]
    r = make(max_workers=4, max_pending=8, max_inflight=8, max_slots=2,
             time_to_expire=1e9, clock=lambda: t[0], spec_mult=2.0,
             spec_min_s=0.01)
    r.EPOCH_REBASE_S = 100.0
    r.register(b"w0", 2)
    r.register(b"w1", 2)
    r.tick_resident()
    r.inflight_add("old", 0, pred=10.0)
    r.tick_resident()
    t[0] += 90.0
    r.tick_resident()
    t[0] += 20.0  # past the rebase: the epoch moves to now
    r.inflight_add("new", 1, pred=1.0)
    r.tick_resident()
    t[0] += 5.0
    r.tick_resident()
    log = []
    while (res := r.resolve_next()) is not None:
        log.append(res.straggler_slots)
    st = r._r_state
    return (log, [tres.to_host(x) if isinstance(x, torch.Tensor)
                  else np.asarray(x) for x in (st.infl_start, st.infl_pred)])


def test_epoch_rebase_understates_old_slots_like_jax():
    got = _rebase(lambda **kw: tres.ResidentScheduler(device="cpu", **kw))
    want = _rebase(lambda **kw: jres.ResidentScheduler(
        tick_backend="fused_interpret", **kw))
    assert got[0] == want[0]
    for g, w in zip(got[1], want[1]):
        np.testing.assert_array_equal(g, w)
    # before the rebase "old" is 90 s past its 20 s threshold and flags;
    # after it its old-epoch stamp leaves 5 s elapsed and it does not,
    # while "new" (stamped in the new epoch, threshold 2 s) does
    assert got[0] == [[], [], [0], [], [1]]
    assert got[1][0][:2].tolist() == [0.0, 0.0]


def test_spec_wrapper_checks_before_building():
    """The CUDA wrapper checks the packet's speculation length and the
    spec leaves before it builds or launches anything."""
    leaves, packet, statics = _spec_case(3, False, False)
    st = tres.state_from_numpy(leaves, "cpu")
    kernel = fused_tick.FusedTickKernel()
    with pytest.raises(ValueError, match="packet"):
        kernel(torch.from_numpy(packet[:-2]), st, flush=False, **statics)
    for leaf in ("infl_start", "infl_pred", "avoid"):
        with pytest.raises(ValueError, match=leaf):
            kernel(torch.from_numpy(packet), st._replace(
                **{leaf: getattr(st, leaf)[:1]}), flush=False, **statics)
    with pytest.raises(ValueError, match="KG"):
        kernel(torch.from_numpy(packet), st, flush=False,
               **dict(statics, KG=0))
    assert kernel.launches == 0 and kernel.spec_launches == 0
    assert kernel._fn is None
