"""The tenancy plane of the PyTorch port against the JAX package.

The same seeded numpy inputs go through ``tpu_faas.tenancy`` and
``tpu_faas_torch.tenancy`` on the CPU: the admission's eligibility, ranks
and demand must be exactly equal; the deficit carry within rtol 1e-6 (XLA
sums the shares in its own order, the port in one float64 running sum) and
exactly equal where the shares sum exactly; every placement of the batch
tick with tenancy exactly equal. Then twins of the JAX suite's config,
table and unit cases (tests/test_tenancy.py), on the port.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_faas.sched.state import SchedulerArrays as JArrays
from tpu_faas.sched.state import scheduler_tick_impl as j_tick
from tpu_faas.store.memory import MemoryStore
from tpu_faas.tenancy import fairshare as jfair
from tpu_faas_torch.sched.state import SchedulerArrays as TArrays
from tpu_faas_torch.sched.state import scheduler_tick_impl as t_tick
from tpu_faas_torch.tenancy import (
    DEFAULT_TENANT,
    TenantTable,
    parse_caps,
    parse_shares,
    valid_tenant,
)
from tpu_faas_torch.tenancy import fairshare as tfair
from tpu_faas_torch.tenancy.config import (
    TENANT_CONF_KEY,
    decode_conf,
    encode_conf,
)

f32, i32 = np.float32, np.int32
#: the deficit's tolerance against JAX: a few ulps of the share sum's order
RTOL = 1e-6
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _admission_case(seed, N=6, T=64, kind="random"):
    """Admission inputs: ties (equal shares, deficits and ranks), virtual
    positions of exactly 0 and below it, capped, uncapped and exhausted
    tenants, out-of-range tenant rows, deficits past the starvation
    threshold."""
    rng = np.random.default_rng(seed)
    tenant = rng.integers(-2, N + 2, T).astype(i32)
    share = rng.choice(np.array([0.5, 1.0, 2.0, 3.0, 1e-9], f32), N)
    if kind == "ties":
        share[:] = 1.0
    deficit = rng.choice(np.array([0.0, 1.0, 2.0, 1023.5, 1024.0, 4096.0],
                                  f32), N)
    ahead = rng.integers(0, 6, N).astype(i32)
    cap = rng.choice(np.array([0, 0, 2, 5, 9], i32), N)
    cap[0], ahead[0] = 3, 3  # exhausted: allowance 0
    if N > 1:
        cap[1], ahead[1] = 2, 7  # past its cap: allowance clamps at 0
    return dict(
        task_valid=rng.random(T) < 0.8,
        task_tenant=tenant,
        task_priority=rng.integers(-1, 2, T).astype(i32),
        tenant_share=share,
        tenant_deficit=deficit,
        tenant_ahead=ahead,
        tenant_cap=cap,
    )


def _admit_both(case, prio=True, **kw):
    case = dict(case)
    if not prio:
        case["task_priority"] = None
    want = jfair.tenant_fair_admission_impl(
        **{k: None if v is None else jnp.asarray(v) for k, v in case.items()},
        **kw)
    got = tfair.tenant_fair_admission_impl(
        **{k: None if v is None else torch.from_numpy(v)
           for k, v in case.items()}, **kw)
    return want, got


@pytest.mark.parametrize("prio", [False, True], ids=["fcfs", "prio"])
@pytest.mark.parametrize("kind,seed", [("random", 0), ("random", 1),
                                       ("random", 2), ("ties", 3),
                                       ("ties", 4)])
def test_fair_admission_matches_jax(kind, seed, prio):
    case = _admission_case(seed, kind=kind)
    want, got = _admit_both(case, prio)
    for name, w, g in zip(("eligible", "adm_rank", "demand"), want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=name)
    eligible = got[0].numpy()
    assert eligible.any() and not eligible.all()


def test_fair_admission_zero_and_negative_virtual_positions():
    """Deficits equal to j + 1 give v = 0 exactly; larger ones negative v;
    the starvation knobs apply as JAX's static arguments."""
    T, N = 24, 3
    case = dict(
        task_valid=np.ones(T, bool),
        task_tenant=np.arange(T, dtype=i32) % N,
        task_priority=np.zeros(T, i32),
        tenant_share=np.array([1.0, 2.0, 1.0], f32),
        tenant_deficit=np.array([1.0, 2.0, 5.0], f32),
        tenant_ahead=np.zeros(N, i32),
        tenant_cap=np.zeros(N, i32),
    )
    for kw in ({}, dict(starve_deficit=2.0, starve_boost=3)):
        want, got = _admit_both(case, **kw)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _deficit_case(seed, N=8, T=64, shares=None):
    rng = np.random.default_rng(seed)
    share = (rng.uniform(0.1, 5.0, N).astype(f32) if shares is None
             else np.resize(np.asarray(shares, f32), N))
    return dict(
        assignment=np.where(rng.random(T) < 0.5, -1,
                            rng.integers(0, 4, T)).astype(i32),
        task_tenant=rng.integers(-1, N + 1, T).astype(i32),
        demand=rng.random(N) < 0.7,
        tenant_share=share,
        tenant_deficit=rng.choice(np.array([0.0, 0.5, 7.25, 4095.0], f32),
                                  N),
    )


def _deficit_both(case):
    want = jfair.tenant_deficit_update_impl(
        **{k: jnp.asarray(v) for k, v in case.items()})
    got = tfair.tenant_deficit_update_impl(
        **{k: torch.from_numpy(v) for k, v in case.items()})
    return np.asarray(want), got.numpy()


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_deficit_update_within_rtol(seed):
    want, got = _deficit_both(_deficit_case(seed))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)
    assert (want > 0).any()


@pytest.mark.parametrize("shares", [(8.0, 1.0), (3.0, 1.0)])
@pytest.mark.parametrize("seed", [0, 1])
def test_deficit_update_exact_on_exactly_summing_shares(shares, seed):
    want, got = _deficit_both(_deficit_case(seed, shares=shares))
    np.testing.assert_array_equal(got, want)


def test_share_sum_is_one_float64_running_sum():
    w = torch.tensor([1e8, 1.0, -1e8, 3.0], dtype=torch.float32)
    assert float(tfair.share_sum(w)) == 4.0  # float32 in order: 3.0


def _tick_inputs(seed, T=64, W=8, I=32, K=4, N=5):
    """Batch tick inputs with exact products (sizes k/8, speeds in
    {0.5, 1, 2, 4}), so the auction's bids are order-free, plus the
    tenancy lane's."""
    rng = np.random.default_rng(seed)
    return dict(
        task_size=(rng.integers(1, 33, T) / 8).astype(f32),
        task_valid=rng.random(T) < 0.9,
        worker_speed=rng.choice(np.array([0.5, 1.0, 2.0, 4.0], f32), W),
        worker_free=rng.integers(1, K + 1, W).astype(i32),
        worker_active=rng.random(W) < 0.95,
        heartbeat_age=rng.uniform(0.0, 9.0, W).astype(f32),
        prev_live=np.ones(W, bool),
        inflight_worker=np.where(rng.random(I) < 0.5, -1,
                                 rng.integers(0, W, I)).astype(i32),
        task_priority=rng.integers(0, 3, T).astype(i32),
        task_tenant=rng.integers(0, N, T).astype(i32),
        tenant_share=np.array([8.0, 1.0, 1.0, 2.0, 4.0], f32)[:N],
        tenant_deficit=np.array([0.0, 3.0, 1100.0, 0.5, 0.0], f32)[:N],
        tenant_ahead=np.array([0, 4, 1, 0, 2], i32)[:N],
        tenant_cap=np.array([0, 6, 0, 0, 3], i32)[:N],
    ), rng


@pytest.mark.parametrize("placement", ["rank", "auction", "sinkhorn"])
@pytest.mark.parametrize("seed", [0, 1])
def test_scheduler_tick_with_tenancy_matches_jax(seed, placement):
    """The batch tick with the tenancy plane: every placement exactly
    JAX's, the deficit within rtol 1e-6 (exact here: the shares sum
    exactly); the auction warm from the same prices."""
    K = 4
    inputs, rng = _tick_inputs(seed)
    if placement == "auction":
        inputs["auction_price"] = (rng.integers(0, 32, 8 * K) / 16).astype(
            f32)
    want = j_tick(**{k: jnp.asarray(v) for k, v in inputs.items()},
                  time_to_expire=jnp.float32(10.0), max_slots=K,
                  placement=placement)
    got = t_tick(**{k: torch.from_numpy(v) for k, v in inputs.items()},
                 time_to_expire=10.0, max_slots=K, placement=placement)
    for field in ("assignment", "live", "purged", "redispatch"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)),
                                      err_msg=field)
    np.testing.assert_allclose(got.tenant_deficit.numpy(),
                               np.asarray(want.tenant_deficit), rtol=RTOL,
                               atol=0)
    a = got.assignment.numpy()
    assert (a >= 0).any()
    # the capped tenants placed no more than their allowance
    t = inputs["task_tenant"]
    for row in (1, 4):
        allow = inputs["tenant_cap"][row] - inputs["tenant_ahead"][row]
        assert ((a >= 0) & (t == row)).sum() <= allow
    np.testing.assert_array_equal(
        got.tenant_eligible.numpy() & ~inputs["task_valid"],
        np.zeros_like(inputs["task_valid"]))


def _drive_arrays(a, seed, table, placement):
    """Several batch ticks with tenant-tagged batches, inflight counts
    noted as the dispatcher notes them, and a share hot reload."""
    rng = np.random.default_rng(seed)
    clock = [100.0]
    a.clock = lambda: clock[0]
    a.tenancy = table
    for i in range(8):
        a.register(b"w%d" % i, int(rng.integers(1, 4)),
                   speed=float(rng.choice([0.5, 1.0, 2.0, 4.0])))
    outs = []
    for k in range(5):
        clock[0] += 1.0
        for i in range(8):
            a.heartbeat(b"w%d" % i)
        n = int(rng.integers(10, 40))
        sizes = (rng.integers(1, 33, n) / 8).astype(f32)
        tenants = rng.integers(0, table.n_tenants, n).astype(i32)
        out = a.tick(sizes, task_priorities=rng.integers(0, 2, n),
                     task_tenants=tenants)
        assign = np.asarray(out.assignment)
        outs.append((assign, a.tenant_deficits()))
        for t in np.flatnonzero(assign[:n] >= 0):
            table.note_dispatched(int(tenants[t]))
        if k == 2:
            table.apply_specs("light=1,heavy=5", None)
            table.inflight[:] = 0
    return outs


@pytest.mark.parametrize("placement", ["rank", "sinkhorn"])
def test_scheduler_arrays_tick_with_tenants_matches_jax(placement):
    from tpu_faas.tenancy import TenantTable as JTable

    def table(cls):
        t = cls(shares={"light": 8.0, "heavy": 1.0}, caps={"heavy": 5},
                max_tenants=4)
        t.row_for("third")
        return t

    kw = dict(max_workers=16, max_pending=64, max_inflight=128, max_slots=4,
              placement=placement)
    want = _drive_arrays(JArrays(**kw), 3, table(JTable), placement)
    got = _drive_arrays(TArrays(**kw, device="cpu"), 3, table(TenantTable),
                        placement)
    for k, ((wa, wd), (ga, gd)) in enumerate(zip(want, got)):
        np.testing.assert_array_equal(ga, wa, err_msg=f"tick {k}")
        np.testing.assert_allclose(gd, wd, rtol=RTOL, atol=0)
    assert any((ga >= 0).any() for ga, _ in got)


def test_tenant_deficits_none_before_the_first_tenancy_tick():
    a = TArrays(max_workers=4, max_pending=8, max_inflight=8, device="cpu")
    assert a.tenant_deficits() is None
    a.tenancy = TenantTable(max_tenants=2)
    a.register(b"w0", 2)
    a.tick(np.ones(4, f32), task_tenants=np.array([0, 1, 1, 0], i32))
    assert a.tenant_deficits().shape == (2,)
    # task_tenants without a table is ignored, as in the JAX tick
    b = TArrays(max_workers=4, max_pending=8, max_inflight=8, device="cpu")
    b.register(b"w0", 2)
    assert b.tick(np.ones(4, f32), task_tenants=np.zeros(4, i32)
                  ).tenant_deficit is None


def test_segment_key_must_fit_int32():
    with pytest.raises(ValueError, match="int32"):
        tfair.check_segment_key(1024, 2**21)
    tfair.check_segment_key(32, 51_200)


def test_tenancy_modules_import_no_jax():
    code = ("import sys, tpu_faas_torch.tenancy.config, "
            "tpu_faas_torch.tenancy.fairshare\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'tpu_faas')]\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=_REPO,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": _REPO})
    assert out.returncode == 0, out.stdout + out.stderr


# -- twins of the JAX suite's config and table cases ----------------------


def test_parse_shares_and_caps():
    assert parse_shares("a=3,b=1.5") == {"a": 3.0, "b": 1.5}
    assert parse_shares("") == {}
    assert parse_caps("a=100, b=2") == {"a": 100, "b": 2}
    for bad in ("a", "a=x", "a=-1", "a=0", "a=inf", "a=1,a=2", "bad name=1"):
        with pytest.raises(ValueError):
            parse_shares(bad)


def test_valid_tenant():
    assert valid_tenant("team-a") and valid_tenant("A.b_c-9")
    for bad in ("", "-lead", "has space", "x" * 65, "colon:bad", None, 7):
        assert not valid_tenant(bad)


def test_conf_roundtrip():
    assert TENANT_CONF_KEY == "fleet:tenant_conf"
    v = encode_conf("a=3,b=1", now=123.5)
    assert decode_conf(v) == ("a=3,b=1", 123.5)
    assert decode_conf(None) is None
    assert decode_conf("garbled") is None


def test_tenant_table_rows_overflow_and_labels():
    t = TenantTable(shares={"a": 2.0}, caps={"b": 5}, max_tenants=3)
    assert t.row_for(None) == 0 and t.row_for(DEFAULT_TENANT) == 0
    ra, rb = t.row_for("a"), t.row_for("b")
    assert ra != 0 and rb != 0 and ra != rb
    assert t.row_for("a") == ra
    assert t.row_for("c") == 0
    assert t.overflowed == 1
    assert t.label_for("a") == "a" and t.label_for("b") == "b"
    assert t.label_for("c") == "other"
    assert t.label_for(None) == DEFAULT_TENANT
    assert float(t.share[ra]) == 2.0 and int(t.cap[rb]) == 5
    st = t.stats()
    assert st["tenants"]["a"]["share"] == 2.0
    assert st["overflowed"] == 1


def test_parse_caps_rejects_fractional_values():
    for bad in ("a=0.5", "a=2.7"):
        with pytest.raises(ValueError):
            parse_caps(bad)
    assert parse_caps("a=2") == {"a": 2}


def test_table_overflow_never_retunes_default_row():
    t = TenantTable(max_tenants=2)
    t.row_for("filler")
    t.apply_specs("overflow-tenant=5", "overflow-tenant=3")
    assert float(t.share[0]) == 1.0
    assert int(t.cap[0]) == 0
    assert t.label_for("overflow-tenant") == "other"
    t2 = TenantTable(max_tenants=2)
    t2.apply_specs("default=4", "default=7")
    assert float(t2.share[0]) == 4.0 and int(t2.cap[0]) == 7


def test_apply_specs_is_all_or_nothing():
    t = TenantTable(max_tenants=8)
    t.apply_specs("a=2", "a=5")
    with pytest.raises(ValueError):
        t.apply_specs("a=9", "a=bad")
    assert float(t.share[t.row_for("a")]) == 2.0
    store = MemoryStore()
    store.hset(TENANT_CONF_KEY, {"shares": encode_conf("a=9"),
                                 "caps": encode_conf("a=broken")})
    assert t.maybe_reload(store) is False
    assert float(t.share[t.row_for("a")]) == 2.0


def test_tenant_table_apply_specs_change_detection():
    t = TenantTable(max_tenants=8)
    assert t.apply_specs("a=2", None) is True
    assert t.apply_specs("a=2", None) is False
    assert t.apply_specs("a=4", "a=9") is True
    assert float(t.share[t.row_for("a")]) == 4.0
    assert int(t.cap[t.row_for("a")]) == 9
    with pytest.raises(ValueError):
        t.apply_specs("broken==", None)


def test_tenant_table_hot_reload_via_store():
    store = MemoryStore()
    t = TenantTable(max_tenants=8)
    t.apply_specs("a=2", "")
    t.publish(store)
    t2 = TenantTable(max_tenants=8)
    assert t2.maybe_reload(store) is True
    assert float(t2.share[t2.row_for("a")]) == 2.0
    assert t2.maybe_reload(store) is False
    store.hset(TENANT_CONF_KEY, {"shares": encode_conf("a=7")})
    assert t.maybe_reload(store) is True and t2.maybe_reload(store) is True
    assert float(t.share[t.row_for("a")]) == 7.0
    store.hset(TENANT_CONF_KEY, {"shares": encode_conf("a==broken")})
    assert t.maybe_reload(store) is False
    assert float(t.share[t.row_for("a")]) == 7.0


# -- twins of the JAX suite's unit cases ------------------------------------


def _admit(valid, tenant, share, deficit=None, ahead=None, cap=None,
           prio=None, **kw):
    N = share.shape[0]

    def z(dt):
        return torch.zeros(N, dtype=dt)

    return tfair.tenant_fair_admission_impl(
        torch.from_numpy(np.asarray(valid)),
        torch.from_numpy(np.asarray(tenant, i32)),
        None if prio is None else torch.from_numpy(np.asarray(prio, i32)),
        torch.from_numpy(np.asarray(share, f32)),
        z(torch.float32) if deficit is None
        else torch.from_numpy(np.asarray(deficit, f32)),
        z(torch.int32) if ahead is None
        else torch.from_numpy(np.asarray(ahead, i32)),
        z(torch.int32) if cap is None
        else torch.from_numpy(np.asarray(cap, i32)),
        **kw,
    )


def test_weighted_interleave_tracks_shares():
    tenant = np.array([0, 1] * 16, i32)
    share = np.array([3.0, 1.0], f32)
    _e, rank, _d = _admit(np.ones(32, bool), tenant, share)
    order = tenant[np.argsort(rank.numpy())]
    for k in (8, 16, 24):
        frac0 = (order[:k] == 0).mean()
        assert 0.6 <= frac0 <= 0.85, (k, order[:k])


def test_work_conservation_idle_tenant_spills():
    tenant = np.zeros(8, i32)
    share = np.array([1.0, 100.0], f32)
    elig, rank, demand = _admit(np.ones(8, bool), tenant, share)
    assert elig.numpy().all()
    assert sorted(rank.numpy()[:8]) == list(range(8))
    assert list(demand.numpy()) == [True, False]


def test_fcfs_within_tenant_preserved():
    _e, rank, _d = _admit(np.ones(4, bool), np.zeros(4, i32),
                          np.array([1.0], f32))
    assert list(rank.numpy()) == [0, 1, 2, 3]


def test_inflight_cap_masks_surplus():
    elig, _r, demand = _admit(
        np.ones(6, bool), np.array([0, 0, 0, 1, 1, 1], i32),
        np.array([1.0, 1.0], f32), ahead=np.array([0, 2], i32),
        cap=np.array([0, 3], i32),
    )
    assert list(elig.numpy()) == [True, True, True, True, False, False]
    assert list(demand.numpy()) == [True, True]


def test_priority_classes_dominate_fairness():
    _e, rank, _d = _admit(np.ones(4, bool), np.array([0, 0, 1, 1], i32),
                          np.array([100.0, 1.0], f32),
                          prio=np.array([0, 0, 1, 1], i32))
    assert list(np.argsort(rank.numpy())) == [2, 3, 0, 1]


def test_starvation_boost_rides_priority_lane():
    tenant = np.array([0, 0, 1, 1], i32)
    share = np.array([1.0, 1.0], f32)
    prio = np.array([1, 1, 0, 0], i32)
    _e, rank, _d = _admit(np.ones(4, bool), tenant, share, prio=prio,
                          deficit=np.array([0.0, 4.0], f32),
                          starve_deficit=8.0, starve_boost=1)
    assert list(np.argsort(rank.numpy()))[:2] == [0, 1]
    _e, rank, _d = _admit(np.ones(4, bool), tenant, share, prio=prio,
                          deficit=np.array([0.0, 9.0], f32),
                          starve_deficit=8.0, starve_boost=1)
    assert list(np.argsort(rank.numpy()))[:2] == [2, 3]


def test_deficit_update_drr_semantics():
    tenant = torch.tensor([0, 0, 1, 1], dtype=torch.int32)
    share = torch.ones(2)
    assignment = torch.tensor([0, 1, -1, -1], dtype=torch.int32)
    new = tfair.tenant_deficit_update_impl(
        assignment, tenant, torch.tensor([True, True]), share,
        torch.zeros(2)).numpy()
    assert new[0] == 0.0 and new[1] == pytest.approx(1.0)
    new2 = tfair.tenant_deficit_update_impl(
        assignment, tenant, torch.tensor([True, False]), share,
        torch.tensor([0.0, 3.0])).numpy()
    assert new2[1] == 0.0


def _small_tick(T, placement="rank", **kw):
    W = 2
    return t_tick(
        torch.ones(T), torch.ones(T, dtype=torch.bool), torch.ones(W),
        torch.tensor([1, 1], dtype=torch.int32), torch.ones(W,
                                                            dtype=torch.bool),
        torch.zeros(W), torch.ones(W, dtype=torch.bool),
        torch.full((4,), -1, dtype=torch.int32), 10.0,
        placement=placement, **kw)


def test_starved_tenant_recovers_through_tick_iterations():
    T = 8
    tenant = torch.tensor([0, 1] * 4, dtype=torch.int32)
    prio = torch.tensor([1, 0] * 4, dtype=torch.int32)
    deficit = torch.zeros(2)
    placed_t1 = []
    for _ in range(6):
        out = _small_tick(
            T, max_slots=1, task_priority=prio, task_tenant=tenant,
            tenant_share=torch.ones(2), tenant_deficit=deficit,
            tenant_ahead=torch.zeros(2, dtype=torch.int32),
            tenant_cap=torch.zeros(2, dtype=torch.int32),
            starve_deficit=2.5, starve_boost=1,
        )
        a = out.assignment.numpy()
        placed_t1.append(int(((a >= 0) & (tenant.numpy() == 1)).sum()))
        deficit = out.tenant_deficit
    assert placed_t1[0] == 0
    assert any(n > 0 for n in placed_t1[2:]), placed_t1
    assert float(deficit[0]) >= 0.0


def test_tick_without_tenancy_unchanged():
    T = 6
    args = (torch.arange(T, 0, -1, dtype=torch.float32),
            torch.ones(T, dtype=torch.bool), torch.ones(3),
            torch.tensor([2, 2, 2], dtype=torch.int32),
            torch.ones(3, dtype=torch.bool), torch.zeros(3),
            torch.ones(3, dtype=torch.bool),
            torch.full((8,), -1, dtype=torch.int32), 10.0)
    out = t_tick(*args, max_slots=2)
    assert out.tenant_deficit is None and out.tenant_eligible is None
    out2 = t_tick(*args, max_slots=2,
                  task_tenant=torch.zeros(T, dtype=torch.int32),
                  tenant_share=torch.ones(1), tenant_deficit=torch.zeros(1),
                  tenant_ahead=torch.zeros(1, dtype=torch.int32),
                  tenant_cap=torch.zeros(1, dtype=torch.int32))
    assert torch.equal(out.assignment, out2.assignment)
    assert out2.tenant_deficit is not None


@pytest.mark.parametrize("placement", ["auction", "sinkhorn"])
def test_cap_mask_applies_to_auction_and_sinkhorn(placement):
    T = 6
    tenant = torch.tensor([0, 0, 0, 0, 1, 1], dtype=torch.int32)
    out = t_tick(
        torch.ones(T), torch.ones(T, dtype=torch.bool), torch.ones(2),
        torch.tensor([4, 4], dtype=torch.int32),
        torch.ones(2, dtype=torch.bool), torch.zeros(2),
        torch.ones(2, dtype=torch.bool), torch.full((4,), -1,
                                                    dtype=torch.int32),
        10.0, max_slots=4, placement=placement, task_tenant=tenant,
        tenant_share=torch.ones(2), tenant_deficit=torch.zeros(2),
        tenant_ahead=torch.zeros(2, dtype=torch.int32),
        tenant_cap=torch.tensor([2, 0], dtype=torch.int32),
    )
    a, t = out.assignment.numpy(), tenant.numpy()
    assert ((a >= 0) & (t == 0)).sum() == 2
    assert ((a >= 0) & (t == 1)).sum() == 2
