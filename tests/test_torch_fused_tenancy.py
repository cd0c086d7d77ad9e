"""The resident tick's tenancy lane in the PyTorch port against the TPU kernel.

The JAX side is the fused Pallas resident tick (kernel B1) with
``use_tenancy=True``, run the way the JAX suite runs it on the CPU: under
the Pallas interpreter (``tick_backend="fused_interpret"``). The port side
is ``ResidentScheduler(tenancy=TenantTable(...))`` and
``fused_tick.fused_resident_tick`` on the CPU, which run the plain version
of the port's CUDA kernel. In every placement (rank, auction, Sinkhorn) the
placements and every integer output and state leaf must be exactly equal;
the deficit carry within rtol 1e-6 (the share sum's order differs), which
is exact wherever the shares sum exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_fused_auction import _case
from tpu_faas.sched import pallas_fused as jfused
from tpu_faas.sched import resident as jres
from tpu_faas.tenancy import TenantTable as JTable
from tpu_faas_torch.sched import fused_tick
from tpu_faas_torch.sched import resident as tres
from tpu_faas_torch.tenancy import TenantTable

f32, i32 = np.float32, np.int32
RTOL = 1e-6
PLACEMENTS = ["rank", "auction", "sinkhorn"]


def _tenancy_case(seed, use_priority, placement, NT=6):
    """``_case``'s state and packet with the tenancy lane: tenant rows over
    every row and outside [0, NT) in the state and in the arrival lane,
    deficits on both sides of the starvation threshold and at the cap, and
    a tail whose caps are uncapped, at ahead and below it."""
    leaves, packet, statics = _case(seed, use_priority, True)
    rng = np.random.default_rng(100 + seed)
    T, KA = statics["T"], statics["KA"]
    leaves["tenant"] = rng.integers(-1, NT + 1, T).astype(i32)
    leaves["t_deficit"] = rng.choice(
        np.array([0.0, 1.5, 1023.0, 1024.0, 4096.0], f32), NT)
    lanes = 2 if use_priority else 1
    cut = 9 + KA * lanes
    arr_tenant = rng.integers(-2, NT + 2, KA).astype(f32)
    share = rng.choice(np.array([8.0, 1.0, 2.0, 0.5], f32), NT)
    ahead = rng.integers(0, 6, NT).astype(f32)
    cap = np.where(rng.random(NT) < 0.5, 0, ahead + rng.integers(-2, 4, NT))
    cap[0], ahead[0] = 4, 4  # at its cap
    packet = np.concatenate([packet[:cut], arr_tenant, packet[cut:], share,
                             ahead, cap.astype(f32)]).astype(f32)
    return leaves, packet, dict(statics, use_tenancy=True, NT=NT)


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
            np.testing.assert_allclose(g[field], w, rtol=RTOL, atol=0)
        elif field == "price":
            np.testing.assert_allclose(g[field], w, rtol=0, atol=1e-5)
        else:
            np.testing.assert_array_equal(g[field], w, err_msg=field)


@pytest.mark.parametrize("use_priority", [False, True])
@pytest.mark.parametrize("placement", PLACEMENTS)
@pytest.mark.parametrize("seed", [0, 1])
def test_tenancy_tick_matches_fused_kernel(seed, placement, use_priority):
    """One resident tick with the tenancy lane from a random state: the
    port's tick against the TPU kernel under the Pallas interpreter."""
    leaves, packet, statics = _tenancy_case(seed, use_priority, placement)
    want, wst, got, gst = _tick_both(leaves, packet, statics, placement)
    for field in want._fields:
        np.testing.assert_array_equal(tres.to_host(getattr(got, field)),
                                      np.asarray(getattr(want, field)),
                                      err_msg=field)
    _assert_state_matches(wst, gst)
    assert (np.asarray(want.placed_slots) >= 0).any()
    # the eligibility the port reports is a subset of the valid tasks
    elig = got.tenant_eligible.numpy()
    assert not (elig & ~tres.state_to_numpy(gst)["valid"]
                & ~np.isin(np.arange(len(elig)),
                           got.placed_slots.numpy())).any()
    assert elig.any() and not elig.all()


@pytest.mark.parametrize("placement", PLACEMENTS)
def test_wide_tenancy_tick_matches_fused_kernel(placement):
    """More tenant rows than the kernel's block 0 counts in shared memory
    (1,024; past it the counts live in global scratch): the port's tick
    with NT = 1,100 against the TPU kernel under the Pallas interpreter."""
    leaves, packet, statics = _tenancy_case(5, False, placement, NT=1100)
    want, wst, got, gst = _tick_both(leaves, packet, statics, placement)
    for field in want._fields:
        np.testing.assert_array_equal(tres.to_host(getattr(got, field)),
                                      np.asarray(getattr(want, field)),
                                      err_msg=field)
    _assert_state_matches(wst, gst)
    assert (np.asarray(want.placed_slots) >= 0).any()


@pytest.mark.parametrize("use_priority", [False, True])
def test_tenancy_flush_matches_jax(use_priority):
    """The flush path's tenant arrival lane, against JAX's flush."""
    leaves, packet, statics = _tenancy_case(4, use_priority, "rank")
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
    arr = garr.numpy()[garr.numpy() >= 0]
    assert len(arr) and not np.array_equal(g["tenant"][arr],
                                           leaves["tenant"][arr])


def _resident_script(make, table_cls, placement, use_priority):
    """The JAX suite's tenancy script (tests/test_tenancy.py): caps, a share
    hot reload mid-run, capacity churn. Returns the placement log and the
    final deficits."""
    ten = table_cls(shares={"a": 2.0, "b": 1.0}, caps={"b": 3},
                    max_tenants=4)
    clock = [100.0]
    r = make(max_workers=8, max_pending=32, max_inflight=64, max_slots=2,
             time_to_expire=10.0, clock=lambda: clock[0],
             use_priority=use_priority, tenancy=ten, placement=placement)
    for w in range(2):
        r.register(f"w{w}".encode(), 2)
    ra, rb = ten.row_for("a"), ten.row_for("b")
    log = []
    for i in range(4):
        r.pending_add(f"a{i}", 1.0, i % 2, ra)
        r.pending_add(f"b{i}", 1.0, 1 - i % 2, rb)
    for step in range(4):
        clock[0] += 0.1
        r.tick_resident()
        while True:
            res = r.resolve_next()
            if res is None:
                break
            for tid, row in sorted(res.placed):
                ten.note_dispatched(ra if tid.startswith("a") else rb)
                log.append((step, tid, row))
        if step == 1:
            for w in range(2):
                r.release_slot(w)
                r.release_slot(w)
            ten.inflight[:] = 0
        if step == 2:
            ten.apply_specs("a=1,b=5", None)
    return log, r.tenant_deficits()


@pytest.mark.parametrize("use_priority", [False, True])
@pytest.mark.parametrize("placement", PLACEMENTS)
def test_resident_script_matches_fused_kernel(placement, use_priority):
    def jax_rs(**kw):
        return jres.ResidentScheduler(tick_backend="fused_interpret", **kw)

    def port_rs(**kw):
        return tres.ResidentScheduler(device="cpu", **kw)

    log_j, def_j = _resident_script(jax_rs, JTable, placement, use_priority)
    log_t, def_t = _resident_script(port_rs, TenantTable, placement,
                                    use_priority)
    assert log_t == log_j
    np.testing.assert_allclose(def_t, np.asarray(def_j), rtol=RTOL, atol=0)
    assert len(log_j) > 0


def _roundtrip(table_cls, make, KA):
    ten = table_cls(shares={"a": 1.0, "b": 1.0}, caps={"b": 1},
                    max_tenants=4)
    r = make(max_workers=4, max_pending=16, max_inflight=16, max_slots=4,
             time_to_expire=10.0, clock=lambda: 50.0, use_priority=True,
             tenancy=ten, KA=KA)
    r.register(b"w0", 4)
    ra, rb = ten.row_for("a"), ten.row_for("b")
    ten.inflight[rb] = 1  # b already at its cap
    for i in range(3):
        r.pending_add(f"a{i}", 1.0, 0, ra)
        r.pending_add(f"b{i}", 1.0, 0, rb)
    r.tick_resident()
    placed, n_pending = [], None
    while (res := r.resolve_next()) is not None:
        placed += [tid for tid, _ in res.placed]
        n_pending = res.n_pending
    return sorted(placed), n_pending, r


@pytest.mark.parametrize("KA", [8, 2], ids=["one-packet", "flushes"])
def test_resident_tenant_packet_roundtrip(KA):
    """Arrival tenant rows survive the packet, the device and the readback:
    the tenant at its cap stays device-pending while the other drains; with
    KA = 2 the first four arrivals ride flush packets."""
    placed, n_pending, r = _roundtrip(
        TenantTable, lambda **kw: tres.ResidentScheduler(device="cpu", **kw),
        KA)
    assert placed == ["a0", "a1", "a2"]
    assert n_pending == 3
    if KA == 2:
        assert r.device_dispatches_total == 3  # two flushes and the tick
    want, _, j = _roundtrip(
        JTable, lambda **kw: jres.ResidentScheduler(
            tick_backend="fused_interpret", **kw), KA)
    assert placed == want
    np.testing.assert_array_equal(tres.to_host(r._r_state.tenant),
                                  np.asarray(j._r_state.tenant))


class _Built(Exception):
    """Raised in place of the build: every check before it passed."""


def test_tenancy_wrapper_checks_before_building(monkeypatch):
    """The CUDA wrapper checks the packet's tenancy length and the tenant
    leaves before it builds or launches anything, and takes tenant rows
    past 1,024 (NT = 4,096): their counts live in global scratch on the
    card."""
    leaves, packet, statics = _tenancy_case(3, False, "rank")
    st = tres.state_from_numpy(leaves, "cpu")
    kernel = fused_tick.FusedTickKernel()
    with pytest.raises(ValueError, match="packet"):
        kernel(torch.from_numpy(packet[:-1]), st, flush=False, **statics)
    with pytest.raises(ValueError, match="t_deficit"):
        kernel(torch.from_numpy(packet), st._replace(
            t_deficit=st.t_deficit[:-1]), flush=False, **statics)
    assert kernel.launches == 0 and kernel._fn is None

    def built():
        raise _Built

    monkeypatch.setattr(kernel, "load", built)
    big = dict(statics, NT=4096)
    pad = np.zeros(3 * (big["NT"] - statics["NT"]), f32)
    wide = st._replace(t_deficit=torch.zeros(big["NT"]))
    for call in (lambda p: kernel(p, wide, flush=False, **big),
                 lambda p: kernel.auction(p, wide, **big)):
        with pytest.raises(_Built):
            call(torch.from_numpy(np.concatenate([packet, pad])))
    assert kernel.launches == 0 and kernel.auction_launches == 0


@pytest.mark.parametrize("NT,match", [
    (0, "at least 1 tenant row"),
    (-3, "at least 1 tenant row"),
    # (NT + 1) * T past 2^31 - 1 with _case's T = 128
    (2**31 // 128, "overflows the int32 segment key"),
])
def test_tenancy_wrapper_refuses_tenant_rows(NT, match):
    """NT below 1, and NT whose segment key ``(NT + 1) * T`` overflows
    int32, are refused before the packet is read or anything is built."""
    leaves, packet, statics = _tenancy_case(3, False, "rank")
    st = tres.state_from_numpy(leaves, "cpu")
    kernel = fused_tick.FusedTickKernel()
    for call in (lambda: kernel(torch.from_numpy(packet), st, flush=False,
                                **dict(statics, NT=NT)),
                 lambda: kernel.auction(torch.from_numpy(packet), st,
                                        **dict(statics, NT=NT)),
                 lambda: kernel.sinkhorn(torch.from_numpy(packet), st,
                                         **dict(statics, NT=NT))):
        with pytest.raises(ValueError, match=match):
            call()
    assert kernel._fn is None


@pytest.mark.cuda
@pytest.mark.parametrize("placement", ["rank", "auction"])
def test_tenancy_kernel_matches_plain_on_card(placement):
    """The CUDA tenancy lane against its plain version on the card: every
    output and state leaf exactly equal, ``t_deficit`` and the eligibility
    included."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU form)")
    for seed, prio in ((0, False), (1, True)):
        leaves, packet, statics = _tenancy_case(seed, prio, placement)
        pkt = torch.from_numpy(packet).cuda()
        got, gst = fused_tick.fused_resident_tick(
            pkt, tres.state_from_numpy(leaves, "cuda"), placement=placement,
            **statics)
        want, wst = tres._resident_tick_impl(
            pkt, tres.state_from_numpy(leaves, "cuda"), placement=placement,
            **statics)
        if placement == "auction":  # the kernel's own word: compacted
            assert int(got.auction_full_length) == 0
            got = got._replace(auction_full_length=None)
        for a, b in zip((*got, *gst), (*want, *wst)):
            assert (a is None and b is None) or torch.equal(a, b)
