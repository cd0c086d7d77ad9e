"""The speculation plane in the PyTorch port against the JAX reference.

``tpu_faas_torch/spec`` (the straggler flags, the anti-affinity veto, the
hedge fixup and the copied host policy) and the batch tick's speculation
lanes get the same seeded numpy inputs as ``tpu_faas/spec`` and JAX's
``scheduler_tick_impl`` (on the CPU). Every output is an integer or bool
vector and must be exactly equal; the tenancy deficit keeps its pinned
rtol of 1e-6 (the share sum's order differs).
"""

import math
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_faas.sched.state import SchedulerArrays as JArrays
from tpu_faas.sched.state import scheduler_tick_impl as j_tick
from tpu_faas.spec import straggler as jspec
from tpu_faas.spec.policy import SpeculationPolicy as JPolicy
from tpu_faas_torch.sched.state import SchedulerArrays as TArrays
from tpu_faas_torch.sched.state import scheduler_tick_impl as t_tick
from tpu_faas_torch.spec import SpeculationPolicy
from tpu_faas_torch.spec import straggler as tspec
from tpu_faas_torch.spec.straggler import (
    HEDGE_FIXUP_K,
    anti_affinity_veto_impl,
    hedge_fixup_impl,
    straggler_flags_impl,
)

f32, i32 = np.float32, np.int32
RTOL = 1e-6
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SPEEDS = np.array([0.5, 1.0, 2.0, 4.0], f32)


def _t(*xs):
    return [torch.from_numpy(np.asarray(x)) for x in xs]


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


# ---------------------------------------------------------------------------
# the device ops (twins of tests/test_spec.py's unit cases)
# ---------------------------------------------------------------------------
def _flags_both(elapsed, pred, occupied, mult, floor):
    got = straggler_flags_impl(*_t(elapsed, pred, occupied), mult, floor)
    want = jspec.straggler_flags(*_j(elapsed, pred, occupied),
                                 jnp.float32(mult), jnp.float32(floor))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    return got.numpy().tolist()


def test_straggler_flags_basic():
    flags = _flags_both(np.array([5.0, 5.0, 0.1, 5.0], f32),
                        np.array([1.0, 0.0, 1.0, 1.0], f32),
                        np.array([True, True, True, False]), 3.0, 0.05)
    # slot 0 past 3x1; slot 1 opts out; slot 2 not past; slot 3 empty
    assert flags == [True, False, False, False]


def test_straggler_min_runtime_floor():
    flags = _flags_both(np.array([0.04, 0.2], f32),
                        np.array([0.01, 0.01], f32),
                        np.array([True, True]), 2.0, 0.05)
    assert flags == [False, True]  # 0.04 < the 0.05 floor


def test_straggler_threshold_propagates_nan():
    """``max(mult*pred, floor)`` propagates a NaN, as ``jnp.maximum``:
    the slot never flags (``fmax`` would drop the NaN and flag it)."""
    inf = np.float32(np.inf)
    flags = _flags_both(np.array([9.0, 9.0, np.nan, 9.0], f32),
                        np.array([inf, np.nan, 1.0, 1.0], f32),
                        np.ones(4, bool), 0.0, 0.05)
    # 0 x inf is NaN; NaN x 0 is NaN; a NaN elapsed never compares past
    assert flags == [False, False, False, True]
    assert _flags_both(np.array([9.0], f32), np.array([1.0], f32),
                       np.ones(1, bool), 2.0, float("nan")) == [False]


def test_anti_affinity_veto_masks_only_forbidden_pairing():
    a, av = np.array([0, 1, 2, -1], i32), np.array([0, -1, 1, 2], i32)
    got = anti_affinity_veto_impl(*_t(a, av)).numpy()
    np.testing.assert_array_equal(got, np.asarray(
        jspec.anti_affinity_veto(*_j(a, av))))
    assert got.tolist() == [-1, 1, 2, -1]


def _fixup_both(assignment, avoid, speed, free, live):
    args = (np.asarray(assignment, i32), np.asarray(avoid, i32),
            np.asarray(speed, f32), np.asarray(free, i32),
            np.asarray(live, bool))
    got = hedge_fixup_impl(*_t(*args)).numpy()
    want = np.asarray(jspec.hedge_fixup(*_j(*args)))
    np.testing.assert_array_equal(got, want)
    return got


def test_hedge_fixup_replaces_on_fastest_other_worker():
    out = _fixup_both([0, -1], [0, -1], [1.0, 0.5, 2.0], [1, 1, 1],
                      [True] * 3)
    assert out[0] == 2


def test_hedge_fixup_no_capacity_elsewhere_stays_queued():
    out = _fixup_both([0], [0], [1.0, 1.0], [2, 0], [True, True])
    assert out[0] == -1


def test_hedge_fixup_respects_remaining_capacity():
    out = _fixup_both([0, 0], [0, 0], [1.0, 1.0], [2, 1], [True, True])
    assert sorted(out.tolist()) == [-1, 1]
    assert HEDGE_FIXUP_K == 64


def test_hedge_fixup_first_argmax_and_nan():
    """``jnp.argmax`` semantics: ties go to the lowest row; a NaN speed on
    an eligible row wins the argmax and then fails ``score > -inf``, so
    the task stays queued; a -inf speed never places."""
    # ties: rows 1 and 2 at 4.0, row 1 first
    assert _fixup_both([0], [0], [9.0, 4.0, 4.0], [1, 1, 1],
                       [True] * 3)[0] == 1
    # a NaN on row 2 beats every real speed: queued
    assert _fixup_both([0], [0], [9.0, 4.0, np.nan], [1, 1, 1],
                       [True] * 3)[0] == -1
    # every other row -inf: queued
    assert _fixup_both([0], [0], [1.0, -np.inf, -np.inf], [1, 1, 1],
                       [True] * 3)[0] == -1


def test_hedge_fixup_reads_the_raw_free_count():
    """The reference's capacity is the raw free count, not min(free,
    max_slots): a worker reporting 5 free takes 5 hedges."""
    n = 6
    out = _fixup_both(np.zeros(n), np.zeros(n), [1.0, 2.0], [0, 5],
                      [True, True])
    assert (out == 1).sum() == 5 and (out == -1).sum() == 1


@pytest.mark.parametrize("seed", range(6))
def test_hedge_fixup_matches_jax_random(seed):
    """Hostile random cases: NaN, -inf and tied speeds, dead rows,
    over-cap and negative free counts, and more than 64 vetoed rows (the K
    bound binds: the surplus stays queued)."""
    rng = np.random.default_rng(seed)
    T, W = 160, 12
    speed = rng.choice(np.array([0.5, 1.0, 2.0, 4.0, np.nan, -np.inf], f32),
                       W, p=[0.3, 0.25, 0.2, 0.15, 0.05, 0.05])
    free = rng.integers(-2, 30, W).astype(i32)
    live = rng.random(W) < 0.85
    assign = np.where(rng.random(T) < 0.75, rng.integers(0, W, T), -1)
    avoid = np.where(rng.random(T) < 0.7, assign, rng.integers(-1, W, T))
    got = _fixup_both(assign, avoid, speed, free, live)
    vetoed = (avoid >= 0) & (assign == avoid)
    assert vetoed.sum() > HEDGE_FIXUP_K
    # no task on its avoid row; past the first K vetoed rows none placed
    assert not ((avoid >= 0) & (got == avoid)).any()
    late = np.flatnonzero(vetoed)[HEDGE_FIXUP_K:]
    assert (got[late] == -1).all()


def test_spec_modules_import_no_jax():
    code = ("import sys, tpu_faas_torch.spec\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'tpu_faas')]\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=_REPO,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": _REPO})
    assert out.returncode == 0, out.stdout + out.stderr


def test_default_floor_matches_jax():
    assert tspec.DEFAULT_MIN_RUNTIME_S == jspec.DEFAULT_MIN_RUNTIME_S
    assert HEDGE_FIXUP_K == jspec.HEDGE_FIXUP_K
    assert SpeculationPolicy(3.0).min_runtime_s == JPolicy(3.0).min_runtime_s


# ---------------------------------------------------------------------------
# the host policy (twins of tests/test_spec.py's policy cases), on the
# port's copy and on JAX's side by side
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("cls", [SpeculationPolicy, JPolicy],
                         ids=["port", "jax"])
def test_policy_knob_validation(cls):
    with pytest.raises(ValueError):
        cls(1.0)
    with pytest.raises(ValueError):
        cls(3.0, max_frac=0.0)


@pytest.mark.parametrize("cls", [SpeculationPolicy, JPolicy],
                         ids=["port", "jax"])
def test_policy_budget_and_dup_gates(cls):
    p = cls(3.0, max_frac=0.5)
    assert p.consider("a", 0, n_dispatched=10) is not None
    assert p.consider("a", 0, n_dispatched=10) is None
    assert p.n_launched == 1
    assert p.consider("b", 1, n_dispatched=4) is not None
    assert not p.within_budget(4)
    assert p.consider("c", 1, n_dispatched=4) is None
    assert p.n_suppressed_budget == 1


@pytest.mark.parametrize("cls", [SpeculationPolicy, JPolicy],
                         ids=["port", "jax"])
def test_policy_resolution_and_loser_accounting(cls):
    p = cls(3.0)
    e = p.consider("a", 0, n_dispatched=100)
    e.hedge_row = 1
    p.resolve("a", winner="replica", loser_row=0)
    assert p.n_replica_wins == 1 and "a" not in p.entries
    assert p.note_loser_result("a", 1, 9.9) is None
    assert p.note_loser_result("a", None, 9.9) is None
    assert p.note_loser_result("a", 0, 1.5) == 1.5
    assert p.note_loser_result("a", 0, 1.5) is None
    assert p.wasted_exec_s == 1.5
    assert p.note_loser_result("zzz", 0, 1.0) is None


@pytest.mark.parametrize("cls", [SpeculationPolicy, JPolicy],
                         ids=["port", "jax"])
def test_policy_abandon_and_promote_counters(cls):
    clock = iter(range(100)).__next__
    p = cls(3.0, clock=lambda: float(clock()))
    p.consider("a", 0, n_dispatched=100)
    p.consider("b", 0, n_dispatched=100)
    assert p.stats()["oldest_outstanding_s"] == 2.0
    assert p.abandon("a") is not None
    assert p.promote("b") is not None
    assert p.abandon("a") is None
    assert p.n_abandoned == 1 and p.n_promoted == 1
    assert p.stats()["outstanding"] == 0


def test_policy_loser_book_is_bounded_like_jax():
    from tpu_faas.spec import policy as jpol
    from tpu_faas_torch.spec import policy as tpol

    assert tpol._LOSER_CAP == jpol._LOSER_CAP
    stats = []
    for cls in (SpeculationPolicy, JPolicy):
        p = cls(3.0, clock=lambda: 5.0)
        for k in range(5):
            p.consider(f"t{k}", k, n_dispatched=100)
            p.resolve(f"t{k}", winner="original" if k % 2 else "replica",
                      loser_row=k)
        p.note_loser_result("t3", 3, 0.25)
        stats.append(p.stats())
    assert stats[0] == stats[1]


# ---------------------------------------------------------------------------
# the batch tick's speculation lanes against JAX's scheduler_tick_impl
# ---------------------------------------------------------------------------
def _tick_inputs(seed, T=64, W=8, I=48, K=4, N=5):
    """Batch tick inputs with exact products (sizes k/8, speeds in
    {0.5, 1, 2, 4}), the speculation lanes (elapsed around the threshold,
    pred <= 0 on some slots, NaN on one), avoid rows equal to where rank
    would place the largest tasks, and the tenancy lane's."""
    rng = np.random.default_rng(seed)
    inflight = np.where(rng.random(I) < 0.3, -1,
                        rng.integers(0, W, I)).astype(i32)
    pred = rng.choice(np.array([0.0, -1.0, 0.01, 0.5, 1.0], f32), I)
    pred[3] = np.nan
    elapsed = (rng.choice(np.array([0.0, 1.5, 3.0, 3.01, 10.0], f32), I)
               * np.maximum(pred, 0.0)).astype(f32)
    elapsed[rng.random(I) < 0.2] = 2.0
    speed = rng.choice(_SPEEDS, W)
    avoid = np.where(rng.random(T) < 0.5, int(np.argmax(speed)),
                     rng.integers(-1, W, T)).astype(i32)
    return dict(
        task_size=(rng.integers(1, 33, T) / 8).astype(f32),
        task_valid=rng.random(T) < 0.9,
        worker_speed=speed,
        worker_free=rng.integers(0, K + 3, W).astype(i32),
        worker_active=rng.random(W) < 0.9,
        heartbeat_age=rng.uniform(0.0, 12.0, W).astype(f32),
        prev_live=np.ones(W, bool),
        inflight_worker=inflight,
        task_priority=rng.integers(0, 3, T).astype(i32),
        spec_elapsed=elapsed,
        spec_predicted=pred,
        task_avoid_worker=avoid,
        worker_health=rng.choice(np.array([1.0, 0.5, 0.25], f32), W),
        worker_place_cap=rng.integers(0, K + 4, W).astype(i32),
    ), dict(
        task_tenant=rng.integers(0, N, T).astype(i32),
        tenant_share=np.array([8.0, 1.0, 1.0, 2.0, 4.0], f32)[:N],
        tenant_deficit=np.array([0.0, 3.0, 1100.0, 0.5, 0.0], f32)[:N],
        tenant_ahead=np.array([0, 4, 1, 0, 2], i32)[:N],
        tenant_cap=np.array([0, 6, 0, 0, 3], i32)[:N],
    ), rng


@pytest.mark.parametrize("tenancy", [False, True], ids=["flat", "tenancy"])
@pytest.mark.parametrize("placement", ["rank", "auction", "sinkhorn"])
@pytest.mark.parametrize("seed", [0, 1])
def test_scheduler_tick_with_spec_matches_jax(seed, placement, tenancy):
    """The batch tick with the straggler flags and the hedge fixup after
    every placement (on the health-scaled speeds and the capped free
    counts): assignment, flags and liveness exactly JAX's."""
    K = 4
    inputs, ten, rng = _tick_inputs(seed)
    if tenancy:
        inputs.update(ten)
    if placement == "auction":
        inputs["auction_price"] = (rng.integers(0, 32, 8 * K) / 16).astype(
            f32)
    kw = dict(max_slots=K, placement=placement)
    want = j_tick(**{k: jnp.asarray(v) for k, v in inputs.items()},
                  time_to_expire=jnp.float32(10.0), spec_mult=jnp.float32(3.0),
                  spec_min_s=jnp.float32(0.02), **kw)
    got = t_tick(**{k: torch.from_numpy(v) for k, v in inputs.items()},
                 time_to_expire=10.0, spec_mult=3.0, spec_min_s=0.02, **kw)
    for field in ("assignment", "live", "purged", "redispatch", "straggler"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)),
                                      err_msg=field)
    if tenancy:
        np.testing.assert_allclose(got.tenant_deficit.numpy(),
                                   np.asarray(want.tenant_deficit),
                                   rtol=RTOL, atol=0)
    a, av = got.assignment.numpy(), inputs["task_avoid_worker"]
    assert (a >= 0).any() and got.straggler.numpy().any()
    assert not ((av >= 0) & (a == av)).any()
    # the flags and the redispatch set are disjoint
    assert not (got.straggler.numpy() & got.redispatch.numpy()).any()


def test_scheduler_tick_fixup_replaces_vetoed_rank_rows():
    """Rank's deterministic tie-break puts the largest tasks on the
    fastest row, which they avoid: the fixup moves them (the veto alone
    would starve them every tick)."""
    inputs, _, _ = _tick_inputs(2)
    del inputs["spec_elapsed"], inputs["spec_predicted"]
    inputs["task_avoid_worker"] = np.full(64, int(np.argmax(
        inputs["worker_speed"] * inputs["worker_health"])), i32)
    j = {k: jnp.asarray(v) for k, v in inputs.items()}
    want = j_tick(**j, time_to_expire=jnp.float32(10.0), max_slots=4)
    got = t_tick(**{k: torch.from_numpy(v) for k, v in inputs.items()},
                 time_to_expire=10.0, max_slots=4)
    np.testing.assert_array_equal(got.assignment.numpy(),
                                  np.asarray(want.assignment))
    assert got.straggler is None and want.straggler is None
    j.pop("task_avoid_worker")
    plain = np.asarray(j_tick(**j, time_to_expire=jnp.float32(10.0),
                              max_slots=4).assignment)
    moved = (plain == inputs["task_avoid_worker"]) & (got.assignment.numpy()
                                                      >= 0)
    assert moved.any()


# ---------------------------------------------------------------------------
# SchedulerArrays over several ticks (twins of tests/test_spec.py's batch
# and worker-health cases, held against JAX)
# ---------------------------------------------------------------------------
def _both(**kw):
    kw = dict(dict(max_workers=4, max_pending=8, max_inflight=16), **kw)
    return (JArrays(**kw), TArrays(**kw, device="cpu"))


def test_batch_tick_spec_off_has_no_straggler_output():
    for a in _both():
        a.register(b"w0", 2)
        out = a.tick(np.asarray([1.0], dtype=f32))
        assert out.straggler is None


def test_batch_tick_dead_worker_redispatches_never_flags():
    outs = []
    for a in _both(time_to_expire=5.0):
        t = [100.0]
        a.clock = lambda: t[0]
        a.spec_mult, a.spec_min_s = 2.0, 0.01
        a.register(b"w0", 2)
        a.register(b"w1", 2)
        a.tick(np.zeros(0, dtype=f32))
        a.inflight_add("x", 0, pred=0.1)
        a.inflight_add("y", 1, pred=0.1)
        t[0] += 4.0
        a.heartbeat(b"w1")
        t[0] += 4.0  # w0 past the TTL; both past the straggler threshold
        out = a.tick(np.zeros(0, dtype=f32))
        outs.append((np.asarray(out.redispatch), np.asarray(out.straggler)))
    (wr, wf), (gr, gf) = outs
    np.testing.assert_array_equal(gr, wr)
    np.testing.assert_array_equal(gf, wf)
    assert gr[0] and not gf[0]  # the dead worker's slot redispatches
    assert gf[1] and not gr[1]  # the live one's flags


def _health_script(a):
    t = [100.0]
    a.clock = lambda: t[0]
    a.spec_mult = 2.0
    r0 = a.register(b"w0", 2)
    r1 = a.register(b"w1", 2)
    trace = []
    a.note_hedge_loss(r0)
    trace.append(float(a.worker_health[r0]))
    for _ in range(30):
        a.note_hedge_loss(r0)
    trace.append(float(a.worker_health[r0]))
    a.deactivate(r1)
    a.note_hedge_loss(r1)
    a.note_hedge_loss(-1)
    a.note_hedge_loss(99)
    trace.append(float(a.worker_health[r1]))
    a.tick(np.zeros(0, dtype=f32))
    h0 = float(a.worker_health[r0])
    t[0] += a.HEALTH_RECOVERY_TAU
    a.tick(np.zeros(0, dtype=f32))
    h1 = float(a.worker_health[r0])
    trace += [h0, h1]
    t[0] += 40 * a.HEALTH_RECOVERY_TAU
    a.tick(np.zeros(0, dtype=f32))
    trace.append(bool((a.worker_health == 1.0).all()))
    a.note_hedge_loss(r0)
    a.deactivate(r0)
    trace.append(a.register(b"w0b", 2))
    trace.append(float(a.worker_health[r0]))
    return trace


def test_worker_health_decay_floor_recovery_and_register_reset():
    want, got = (_health_script(a) for a in _both())
    assert got == want
    a = TArrays(max_workers=4, max_pending=8, max_inflight=16, device="cpu")
    assert got[0] == pytest.approx(a.HEALTH_DECAY)
    assert got[1] == pytest.approx(a.HEALTH_FLOOR)
    assert got[2] == 1.0
    h0, h1 = got[3], got[4]
    assert h1 == pytest.approx(h0 + (1 - h0) * (1 - math.exp(-1)), abs=1e-3)
    assert got[5] is True and got[7] == 1.0


def _steer_script(a, spec_on):
    t = [100.0]
    a.clock = lambda: t[0]
    if spec_on:
        a.spec_mult = 2.0
    fast = a.register(b"fast", 2, speed=1.0)
    slow = a.register(b"slow", 2, speed=0.6)
    a.tick(np.zeros(0, dtype=f32))
    rows = [int(np.asarray(a.tick(np.asarray([1.0], f32)).assignment)[0])]
    for _ in range(10):
        a.note_hedge_loss(fast)
    rows.append(int(np.asarray(a.tick(np.asarray([1.0], f32)).assignment)[0]))
    if not spec_on:
        t[0] += 1000.0
        a.tick(np.zeros(0, dtype=f32))
        rows.append(float(a.worker_health[fast]))
    return rows, fast, slow


def test_worker_health_steers_placement_away_from_lossy_worker():
    (want, _, _), (got, fast, slow) = (_steer_script(a, True)
                                       for a in _both(max_workers=2))
    assert got == want == [fast, slow]


def test_worker_health_off_plane_is_inert():
    """Speculation off: the decayed health neither recovers nor steers."""
    res = []
    for a in _both(max_workers=2):
        a.register(b"fast", 2, speed=1.0)
        a.register(b"slow", 2, speed=0.6)
        a.worker_health[0] = 0.1
        t = [100.0]
        a.clock = lambda: t[0]
        a.tick(np.zeros(0, dtype=f32))
        row = int(np.asarray(a.tick(np.asarray([1.0], f32)).assignment)[0])
        t[0] += 1000.0
        a.tick(np.zeros(0, dtype=f32))
        res.append((row, float(a.worker_health[0])))
    assert res[0] == res[1] == (0, pytest.approx(0.1))


def _drive_arrays(a, seed, placement, table=None):
    """Several batch ticks with speculation on: dispatches stamped with
    predictions, a silent worker whose slots go stale, hedges submitted
    with the original's row to avoid, hedge losses decaying health."""
    rng = np.random.default_rng(seed)
    clock = [100.0]
    a.clock = lambda: clock[0]
    a.spec_mult, a.spec_min_s = 3.0, 0.02
    if table is not None:
        a.tenancy = table
    for i in range(8):
        a.register(b"w%d" % i, int(rng.integers(1, 4)),
                   speed=float(rng.choice([0.5, 1.0, 2.0, 4.0])))
    outs, hedges = [], []
    n_task = 0
    for k in range(6):
        clock[0] += 0.25
        for i in range(8):
            if i != 3 or k < 2:  # w3 goes silent but stays live (tte 10)
                a.heartbeat(b"w%d" % i)
        n_new = int(rng.integers(6, 14))
        sizes = list((rng.integers(1, 33, n_new) / 8).astype(f32))
        avoid = [-1] * n_new
        for tid, row in hedges:
            sizes.append(1.0)
            avoid.append(row)
        hedges = []
        sizes = np.asarray(sizes, f32)
        kw = dict(task_avoid=np.asarray(avoid, i32))
        if table is not None:
            kw["task_tenants"] = rng.integers(0, table.n_tenants,
                                              len(sizes)).astype(i32)
        out = a.tick(sizes, **kw)
        assign = np.asarray(out.assignment)[: len(sizes)]
        flags = np.asarray(out.straggler)
        outs.append((assign, flags.copy(), np.asarray(out.live)))
        for t in np.flatnonzero(assign >= 0):
            row = int(assign[t])
            a.worker_free[row] -= 1
            a.inflight_add(f"t{n_task}", row, pred=0.1 if row == 3 else 0.5)
            n_task += 1
        for slot in np.flatnonzero(flags):
            hedges.append((a.inflight_task[slot],
                           int(a.inflight_worker[slot])))
            a.note_hedge_loss(int(a.inflight_worker[slot]))
        # results come back for everything but the silent worker's slots
        for slot in np.flatnonzero(a.inflight_worker >= 0):
            if a.inflight_worker[slot] != 3 and rng.random() < 0.5:
                row = a.inflight_done(a.inflight_task[slot])
                a.release_slot(row)
    return outs


@pytest.mark.parametrize("placement", ["rank", "auction", "sinkhorn"])
def test_scheduler_arrays_tick_with_spec_matches_jax(placement):
    kw = dict(max_workers=16, max_pending=64, max_inflight=128, max_slots=4,
              placement=placement)
    want = _drive_arrays(JArrays(**kw), 5, placement)
    got = _drive_arrays(TArrays(**kw, device="cpu"), 5, placement)
    for k, (w, g) in enumerate(zip(want, got)):
        for name, wv, gv in zip(("assignment", "straggler", "live"), w, g):
            np.testing.assert_array_equal(gv, wv, err_msg=f"tick {k} {name}")
    assert any(g[1].any() for g in got), "no straggler flagged"
    assert any((g[0] >= 0).any() for g in got)


def test_scheduler_arrays_tick_with_spec_and_tenancy_matches_jax():
    from tpu_faas.tenancy import TenantTable as JTable
    from tpu_faas_torch.tenancy import TenantTable

    def table(cls):
        t = cls(shares={"light": 8.0, "heavy": 1.0}, caps={"heavy": 5},
                max_tenants=4)
        t.row_for("third")
        return t

    kw = dict(max_workers=16, max_pending=64, max_inflight=128, max_slots=4)
    want = _drive_arrays(JArrays(**kw), 6, "rank", table(JTable))
    got = _drive_arrays(TArrays(**kw, device="cpu"), 6, "rank",
                        table(TenantTable))
    for k, (w, g) in enumerate(zip(want, got)):
        for name, wv, gv in zip(("assignment", "straggler", "live"), w, g):
            np.testing.assert_array_equal(gv, wv, err_msg=f"tick {k} {name}")
    assert any(g[1].any() for g in got)
