"""Auction placement in the PyTorch port against the JAX reference.

The same seeded numpy inputs go through both packages on the CPU, where the
port's bids run the plain version of kernel B2. The contracts, each with
its reason:

- ``_expand_and_square``, ``_rebase`` and ``_rank_spill_close`` are exact:
  they are sorts, scans of integers, comparisons and one subtraction.
- ``_rank_dual_seed`` is within rtol 1e-6: XLA's cumsum (a rewritten
  reduce-window) sums in another order than torch's, so the seed differs
  in the last bit.
- The solver from the same opening prices (a warm ``init_price``, or the
  resident carry with ``carry_refresh=False``) is exact on assignment,
  rounds, prices and flags, on inputs whose products are exact in f32
  (dyadic sizes, power-of-two speeds, ε = 2^-12): there XLA's contraction
  of a product into an add cannot move a bid, so every bid is decisive.
- From the seeded cold start and along the ε-ladder the prices differ by
  an ulp from the start, so the contract is JAX's own solver contract
  (tests/test_sched_pallas.py::test_auction_backend_invariant): a legal
  assignment, the same placed count, and cost within n·ε + 1e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_faas.sched import auction as jau
from tpu_faas.sched import resident as jres
from tpu_faas.sched.oracle import optimal_assignment
from tpu_faas.sched.problem import PlacementProblem, check_assignment
from tpu_faas.sched.state import SchedulerArrays as JArrays
from tpu_faas.sched.state import scheduler_tick_impl as j_tick
from tpu_faas_torch.sched import auction as tau
from tpu_faas_torch.sched import resident as tres
from tpu_faas_torch.sched import state as tstate
from tpu_faas_torch.sched.state import SchedulerArrays as TArrays

f32, i32 = np.float32, np.int32
_FIELDS = ("task_size", "task_valid", "worker_speed", "worker_free",
           "worker_live")


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _problem(seed, n_tasks=60, n_workers=16, dyadic=False, T=None, W=None):
    rng = np.random.default_rng(seed)
    if dyadic:
        sizes = (rng.integers(1, 41, n_tasks) / 8).astype(f32)
        speeds = rng.choice(np.array([0.5, 1.0, 2.0, 4.0], f32), n_workers)
    else:
        sizes = rng.uniform(0.5, 5.0, n_tasks).astype(f32)
        speeds = rng.uniform(0.5, 4.0, n_workers).astype(f32)
    free = rng.integers(0, 5, n_workers).astype(i32)
    live = rng.random(n_workers) > 0.2
    p = PlacementProblem.build(sizes, speeds, free, live, T=T, W=W)
    return {f: np.array(getattr(p, f)) for f in _FIELDS}


def _both(fn_j, fn_t, args, **kw):
    """Run the JAX and the port function on the same numpy arguments."""
    jkw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}
    tkw = {k: torch.from_numpy(v.copy()) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}
    want = fn_j(*(jnp.asarray(a) for a in args), **jkw)
    got = fn_t(*(torch.from_numpy(np.array(a)) for a in args), **tkw)
    return want, got


def _solve(p, **kw):
    return _both(jau.auction_placement, tau.auction_placement,
                 [p[f] for f in _FIELDS], **kw)


def _cost(p, a):
    placed = a >= 0
    return float((p["task_size"][placed]
                  / p["worker_speed"][a[placed]]).sum())


def _assert_exact(want, got):
    for field in ("assignment", "prices", "stranded", "refresh",
                  "n_spilled"):
        np.testing.assert_array_equal(_np(getattr(got, field)),
                                      np.asarray(getattr(want, field)),
                                      err_msg=field)
    assert got.n_rounds == int(want.n_rounds)


def _assert_solver_contract(p, want, got, max_slots, eps):
    a_w, a_g = np.asarray(want.assignment), _np(got.assignment)
    check_assignment(a_g, p["task_valid"],
                     np.minimum(p["worker_free"], max_slots),
                     p["worker_live"])
    assert (a_g >= 0).sum() == (a_w >= 0).sum()
    n = int(p["task_valid"].sum())
    assert abs(_cost(p, a_g) - _cost(p, a_w)) <= n * eps + 1e-4


# -- the module-level helpers ------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_expand_and_square_exact(seed):
    rng = np.random.default_rng(seed)
    W, K = 12, 4
    args = [
        rng.random(40) < 0.7,
        np.round(rng.uniform(0.0, 4.0, W) * 2).astype(f32) / 2,  # ties, 0
        rng.integers(-1, K + 3, W).astype(i32),  # negative and over-cap
        rng.random(W) < 0.8,
    ]
    want, got = _both(lambda *a: jau._expand_and_square(*a, K),
                      lambda *a: tau._expand_and_square(*a, K), args)
    for i, (w, g) in enumerate(zip(want, got)):
        np.testing.assert_array_equal(_np(g), np.asarray(w), err_msg=str(i))


@pytest.mark.parametrize("case", ["mixed", "all_zero", "one_positive"])
def test_rebase_exact(case):
    rng = np.random.default_rng(5)
    prices = rng.uniform(0.0, 9.0, 64).astype(f32)
    prices[rng.random(64) < 0.4] = 0.0
    if case == "all_zero":
        prices[:] = 0.0
    elif case == "one_positive":
        prices[:] = 0.0
        prices[7] = 3.25
    want, got = _both(jau._rebase, tau._rebase, [prices])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _squared(p, K):
    args = [p[f] for f in ("task_valid", "worker_speed", "worker_free",
                           "worker_live")]
    return [np.asarray(x) for x in jau._expand_and_square(
        *(jnp.asarray(a) for a in args), K)]


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_rank_spill_close_exact(seed):
    """A random partial matching (each matched task owning a distinct
    valid slot) closed by the rank spill in both packages."""
    K = 4
    p = _problem(seed)
    slot_valid, slot_worker, slot_speed, _, _, n_match, admitted = \
        _squared(p, K)
    rng = np.random.default_rng(100 + seed)
    T, S = len(admitted), len(slot_valid)
    tasks = np.flatnonzero(admitted & (rng.random(T) < 0.5))
    slots = rng.permutation(np.flatnonzero(slot_valid))[: len(tasks)]
    tasks = tasks[: len(slots)]
    assigned = np.full(T, -1, i32)
    owner = np.full(S, -1, i32)
    assigned[tasks], owner[slots] = slots, tasks
    args = [assigned, owner, admitted, p["task_size"], slot_valid,
            slot_speed, slot_worker, n_match]
    want, got = _both(jau._rank_spill_close, tau._rank_spill_close, args)
    for i, (w, g) in enumerate(zip(want, got)):
        np.testing.assert_array_equal(_np(g), np.asarray(w), err_msg=str(i))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("n_tasks", [20, 60, 200])
def test_rank_dual_seed_within_rtol(seed, n_tasks):
    K = 4
    p = _problem(seed, n_tasks=n_tasks, n_workers=24)
    _, _, _, speed_key, order, n_match, admitted = _squared(p, K)
    args = [p["task_size"], admitted, speed_key, order, n_match]
    want, got = _both(jau._rank_dual_seed, tau._rank_dual_seed, args)
    assert np.asarray(want).max() > 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=0)


# -- the solver ----------------------------------------------------------------
_EPS_EXACT = 2.0**-12  # eps/4 * u is exact in f32


@pytest.mark.parametrize("warm_rounds", [64, 2])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_warm_start_exact_from_same_prices(seed, warm_rounds):
    K = 4
    p = _problem(seed, n_tasks=50, dyadic=True)
    opening = (np.random.default_rng(seed).integers(0, 64, p["worker_speed"]
               .shape[0] * K) / 16).astype(f32)
    want, got = _solve(p, max_slots=K, eps=_EPS_EXACT, init_price=opening,
                       warm_rounds=warm_rounds)
    assert int(want.n_rounds) > 0
    _assert_exact(want, got)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bid_rows_sum_each_rounds_bidders(seed):
    """``n_bid_rows`` adds up each round's bidders: every admitted task in
    the first round, then those still without a slot, a count that never
    grows (a won slot installs one bidder and evicts at most one owner)."""
    K = 4
    p = _problem(seed, n_tasks=50, dyadic=True)
    args = [torch.from_numpy(np.array(p[f])) for f in _FIELDS]
    n_match = int(tau._expand_and_square(*args[1:], K)[5])
    assert n_match > 0
    full = tau.auction_placement_impl(*args, max_slots=K, eps=_EPS_EXACT)
    totals = [0] + [
        tau.auction_placement_impl(*args, max_slots=K, eps=_EPS_EXACT,
                                   warm_rounds=r).n_bid_rows
        for r in range(1, min(full.n_rounds, 8) + 1)
    ]
    per_round = np.diff(totals)
    assert per_round[0] == n_match
    assert (per_round >= 1).all() and (np.diff(per_round) <= 0).all()
    assert full.n_rounds <= full.n_bid_rows <= full.n_rounds * n_match


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_resident_carry_exact_without_refresh(seed):
    K = 4
    p = _problem(seed, n_tasks=40, dyadic=True)
    cold, _ = _solve(p, max_slots=K, eps=_EPS_EXACT)
    opening = np.asarray(cold.prices)
    want, got = _solve(p, max_slots=K, eps=_EPS_EXACT, init_price=opening,
                       carry_refresh=np.asarray(False))
    _assert_exact(want, got)


@pytest.mark.parametrize("kw", [
    dict(),  # the seeded cold start
    dict(seed_from_rank=False),  # the eps-ladder
    dict(carry_refresh=True),  # the resident carry opening from the seed
], ids=["seeded", "ladder", "carry_refresh"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cold_starts_meet_the_solver_contract(seed, kw):
    K, eps = 4, 1e-3
    p = _problem(seed, n_tasks=60)
    if "carry_refresh" in kw:
        kw = dict(carry_refresh=np.asarray(True),
                  init_price=np.zeros(p["worker_speed"].shape[0] * K, f32))
    want, got = _solve(p, max_slots=K, eps=eps, **kw)
    _assert_solver_contract(p, want, got, K, eps)
    assert got.n_rounds > 0
    assert bool(got.stranded) is False


def test_cold_start_on_a_lognormal_fleet():
    """BASELINE config 3's heterogeneous leg, cut to 600 tasks x 60
    workers: lognormal sizes over speeds U(0.5, 4) (seed 33)."""
    K, eps = 4, 1e-3
    rng = np.random.default_rng(33)
    speeds = rng.uniform(0.5, 4.0, 60).astype(f32)
    sizes = rng.lognormal(0.0, 1.0, 600).astype(f32)
    pp = PlacementProblem.build(sizes, speeds, np.full(60, K, i32))
    p = {f: np.array(getattr(pp, f)) for f in _FIELDS}
    want, got = _solve(p, max_slots=K, eps=eps)
    _assert_solver_contract(p, want, got, K, eps)
    # the warm tick after it, from JAX's prices in both packages
    want2, got2 = _solve(p, max_slots=K, eps=eps,
                         init_price=np.asarray(want.prices))
    _assert_solver_contract(p, want2, got2, K, eps)


# -- twins of tests/test_sched_auction.py, on the port ------------------------
def _port_run(sizes, speeds, free, live, max_slots=4, eps=1e-4):
    pp = PlacementProblem.build(sizes, speeds, free, live)
    p = {f: np.array(getattr(pp, f)) for f in _FIELDS}
    res = tau.auction_placement(
        *(torch.from_numpy(p[f]) for f in _FIELDS), max_slots=max_slots,
        eps=eps,
    )
    return p, res.assignment.numpy(), res.n_rounds


def test_auction_matches_hungarian_total_cost():
    rng = np.random.default_rng(7)
    n_tasks, n_workers, max_slots, eps = 40, 12, 4, 1e-4
    sizes = rng.uniform(0.5, 8.0, n_tasks).astype(f32)
    speeds = rng.uniform(0.5, 4.0, n_workers).astype(f32)
    free = np.full(n_workers, max_slots, dtype=i32)
    live = np.ones(n_workers, dtype=bool)
    _, a, _ = _port_run(sizes, speeds, free, live, max_slots, eps)
    placed = a[:n_tasks] >= 0
    assert placed.all()
    cost = float(np.sum(sizes[placed] / speeds[a[:n_tasks][placed]]))
    _, cost_opt = optimal_assignment(sizes, speeds, free, live, max_slots)
    assert cost <= cost_opt + n_tasks * eps * 10 + 1e-3


def test_auction_excess_tasks_admitted_by_arrival():
    _, a, _ = _port_run([5.0, 4.0, 3.0, 2.0], [1.0], [2], [True],
                        max_slots=2)
    assert (a[:2] >= 0).all() and (a[2:4] == -1).all()


def test_auction_no_capacity():
    _, a, rounds = _port_run([1.0, 1.0], [1.0, 1.0], [0, 0], [True, True])
    assert (a == -1).all() and rounds == 0


def test_auction_warm_stale_prices_complete_same_tick():
    rng = np.random.default_rng(13)
    sizes = rng.uniform(0.5, 5.0, 30).astype(f32)
    speeds = rng.uniform(0.5, 4.0, 8).astype(f32)
    free = np.full(8, 4, dtype=i32)
    pp = PlacementProblem.build(sizes, speeds, free, np.ones(8, bool))
    p = {f: torch.from_numpy(np.array(getattr(pp, f))) for f in _FIELDS}
    garbage = rng.uniform(0.0, 50.0, p["worker_speed"].shape[0] * 4)
    res = tau.auction_placement(
        *p.values(), max_slots=4, eps=1e-4, warm_rounds=2,
        init_price=torch.from_numpy(garbage.astype(f32)),
    )
    a = res.assignment.numpy()
    check_assignment(a, p["task_valid"].numpy(), p["worker_free"].numpy(),
                     p["worker_live"].numpy())
    assert (a >= 0).sum() == 30 and not bool(res.stranded)
    if int(res.n_spilled) > 8 and int(res.n_spilled) * 20 > 30:
        assert bool(res.refresh)
    cold = tau.auction_placement(*p.values(), max_slots=4, eps=1e-4)
    assert (cold.assignment.numpy() >= 0).sum() == 30
    assert not bool(cold.stranded)


def test_scheduler_arrays_resets_prices_after_refresh(monkeypatch):
    price_args = []
    real = tstate.packed_tick

    def spy(packed, n_valid, ws, wa, pl, iw, tte, prio, price, *a, **kw):
        price_args.append(price)
        return real(packed, n_valid, ws, wa, pl, iw, tte, prio, price, *a,
                    **kw)

    monkeypatch.setattr(tstate, "packed_tick", spy)
    rng = np.random.default_rng(19)
    arr = TArrays(max_workers=8, max_pending=64, max_slots=4,
                  placement="auction", clock=lambda: 100.0, device="cpu")
    for i in range(6):
        arr.register(b"w%d" % i, 4, speed=float(1.0 + i % 3))
    sizes = rng.uniform(0.5, 5.0, 24).astype(f32)
    arr.tick(sizes)
    assert price_args[0] is None
    arr._d_auction_refresh = torch.tensor(True)
    out = arr.tick(sizes)
    assert price_args[1] is None  # the refresh made this tick cold
    assert (out.assignment.numpy() >= 0).sum() == 24
    arr.tick(sizes)
    assert price_args[2] is not None


def test_scheduler_arrays_auction_carries_prices_across_ticks():
    rng = np.random.default_rng(17)
    arr = TArrays(max_workers=8, max_pending=64, max_slots=4,
                  placement="auction", clock=lambda: 100.0, device="cpu")
    for i in range(6):
        arr.register(b"w%d" % i, 4, speed=float(1.0 + i % 3))
    assert arr._d_auction_price is None
    sizes = rng.uniform(0.5, 5.0, 40).astype(f32)
    out1 = arr.tick(sizes)
    assert arr._d_auction_price is not None
    assert (out1.assignment.numpy() >= 0).sum() == 24
    out2 = arr.tick(sizes * 1.01)
    a2 = out2.assignment.numpy()
    assert (a2 >= 0).sum() == 24
    used, counts = np.unique(a2[a2 >= 0], return_counts=True)
    assert (counts <= 4).all() and (used < 6).all()


# -- the batch tick -------------------------------------------------------------
def _tick_inputs(seed, T=64, W=16, I=96, K=4):
    rng = np.random.default_rng(seed)
    return dict(
        task_size=rng.uniform(0.1, 6.0, T).astype(f32),
        task_valid=rng.random(T) < 0.8,
        worker_speed=rng.uniform(0.5, 4.0, W).astype(f32),
        worker_free=rng.integers(-1, K + 2, W).astype(i32),
        worker_active=rng.random(W) < 0.9,
        heartbeat_age=rng.uniform(0.0, 14.0, W).astype(f32),
        prev_live=rng.random(W) < 0.8,
        inflight_worker=np.where(rng.random(I) < 0.4, -1,
                                 rng.integers(0, W, I)).astype(i32),
    )


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scheduler_tick_auction_matches_jax(seed, warm):
    """Liveness, purge and redispatch are exact; placement meets the
    solver contract cold, and is exact warm from the same prices (ties
    aside, which these draws have none of)."""
    K = 4
    inputs = _tick_inputs(seed)
    extra = {}
    if warm:
        rng = np.random.default_rng(50 + seed)
        extra["auction_price"] = rng.uniform(
            0.0, 2.0, len(inputs["worker_speed"]) * K).astype(f32)
    want, got = _both(
        lambda **kw: j_tick(**kw, time_to_expire=jnp.float32(10.0),
                            max_slots=K, placement="auction"),
        lambda **kw: tstate.scheduler_tick_impl(
            **kw, time_to_expire=10.0, max_slots=K, placement="auction"),
        [], **inputs, **extra,
    )
    for field in ("live", "purged", "redispatch"):
        np.testing.assert_array_equal(_np(getattr(got, field)),
                                      np.asarray(getattr(want, field)),
                                      err_msg=field)
    live = np.asarray(want.live)
    p = dict(task_size=inputs["task_size"], task_valid=inputs["task_valid"],
             worker_speed=inputs["worker_speed"],
             worker_free=np.where(live, inputs["worker_free"], 0).clip(0),
             worker_live=live)
    res_w = jau.AuctionResult(want.assignment, 0, want.auction_price)
    _assert_solver_contract(p, res_w, got, K, 1e-3)
    if warm:
        np.testing.assert_array_equal(got.assignment.numpy(),
                                      np.asarray(want.assignment))
        np.testing.assert_allclose(got.auction_price.numpy(),
                                   np.asarray(want.auction_price),
                                   rtol=0, atol=1e-5)
        assert bool(got.auction_refresh) == bool(want.auction_refresh)


def _drive_auction(a, seed):
    rng = np.random.default_rng(seed)
    clock = [100.0]
    a.clock = lambda: clock[0]
    for i in range(10):
        a.register(b"w%d" % i, int(rng.integers(1, 5)),
                   speed=float(rng.uniform(0.5, 4.0)))
    outs = []
    for k in range(4):
        clock[0] += 1.0
        for i in range(10):
            a.heartbeat(b"w%d" % i)
        sizes = rng.uniform(0.5, 6.0, int(rng.integers(10, 40))).astype(f32)
        out = a.tick(sizes)
        outs.append((sizes, np.asarray(out.assignment)))
    return outs


def test_scheduler_arrays_auction_ticks_match_jax():
    """Four carried-price ticks through ``SchedulerArrays``: each placement
    legal, complete and within the solver contract of JAX's."""
    kw = dict(max_workers=16, max_pending=64, max_inflight=64, max_slots=4,
              placement="auction")
    want = _drive_auction(JArrays(**kw), seed=3)
    got = _drive_auction(TArrays(**kw, device="cpu"), seed=3)
    for (sizes, a_w), (_, a_g) in zip(want, got):
        assert (a_g >= 0).sum() == (a_w >= 0).sum() > 0
        placed_w, placed_g = a_w >= 0, a_g >= 0
        assert placed_g[len(sizes):].sum() == 0
        assert np.bincount(a_g[placed_g], minlength=16).max() <= 4
        assert placed_w.sum() == placed_g.sum()


# -- the resident auction -----------------------------------------------------
_SMALL = dict(max_workers=16, max_pending=64, max_inflight=32, max_slots=4,
              time_to_expire=10.0)


def _leaves(seed, refresh, T=64, W=16, I=32, K=4):
    rng = np.random.default_rng(seed)
    return dict(
        sizes=(rng.integers(1, 33, T) / 8).astype(f32),
        valid=rng.random(T) < 0.6,
        prio=np.zeros(T, i32), tenant=np.zeros(T, i32),
        last_hb=(50.0 - rng.uniform(0.0, 12.0, W)).astype(f32),
        free=rng.integers(0, K + 1, W).astype(i32),
        inflight=np.where(rng.random(I) < 0.5, -1,
                          rng.integers(0, W, I)).astype(i32),
        prev_live=rng.random(W) < 0.9,
        speed=rng.choice(np.array([0.5, 1.0, 2.0, 4.0], f32), W),
        active=rng.random(W) < 0.9,
        price=(rng.integers(0, 32, W * K) / 16).astype(f32),
        t_deficit=np.zeros(1, f32), infl_start=np.zeros(1, f32),
        infl_pred=np.zeros(1, f32), avoid=np.full(1, -1, i32),
        refresh=np.asarray(refresh),
    )


@pytest.mark.parametrize("refresh", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_resident_auction_tick_matches_jax(seed, refresh):
    """One plain resident auction tick against JAX's jitted XLA tick from
    identical state and an empty delta packet: every integer output and
    state leaf exact; the carried prices within 1e-5 (from the carried
    prices, an ulp of bid contraction; from the seed, of the cumsum)."""
    T, W, I, K = 64, 16, 32, 4
    leaves = _leaves(seed, refresh)
    statics = dict(T=T, W=W, I=I, KA=8, KH=8, KF=8, KI=8, KS=8, KB=8,
                   use_priority=False)
    packet = np.zeros(9 + 8 + 2 * 5 * 8, f32)
    packet[0], packet[8] = 50.0, 10.0
    jst = jres._ResidentState(**{k: jnp.asarray(v) for k, v in leaves.items()})
    want, wst = jres._resident_tick(jnp.asarray(packet), jst, **statics,
                                    KP=16, KR=8, max_slots=K,
                                    placement="auction")
    got, gst = tres._resident_tick_impl(
        torch.from_numpy(packet), tres.state_from_numpy(leaves, "cpu"),
        **statics, KP=16, KR=8, max_slots=K, placement="auction",
    )
    assert (np.asarray(want.placed_slots) >= 0).any()
    for field in want._fields:
        np.testing.assert_array_equal(tres.to_host(getattr(got, field)),
                                      np.asarray(getattr(want, field)),
                                      err_msg=field)
    g = tres.state_to_numpy(gst)
    for field in wst._fields:
        w = np.asarray(getattr(wst, field))
        if field == "price":
            np.testing.assert_allclose(g[field], w, rtol=0, atol=1e-5)
        else:
            np.testing.assert_array_equal(g[field], w, err_msg=field)


def _mk_resident(**kw):
    clock_box = [100.0]
    r = tres.ResidentScheduler(**_SMALL, clock=lambda: clock_box[0],
                               device="cpu", **kw)
    r._clock_box = clock_box
    return r


def _drain(r):
    out = []
    while (res := r.resolve_next()) is not None:
        out.append(res)
    return out


def test_resident_auction_matches_jax_resident_script():
    """Two resident auction ticks (the cold tick from the seed, then the
    carried prices) in the port and in JAX's XLA resident scheduler place
    the same tasks on the same rows."""
    def drive(r):
        rng = np.random.default_rng(5)
        speeds = rng.uniform(0.5, 4.0, 6)
        for i in range(6):
            r.register(b"w%d" % i, 2, speed=float(speeds[i]))
        placed = []
        for tick in range(2):
            for i, sz in enumerate(rng.uniform(0.5, 5.0, 10)):
                r.pending_add(f"t{tick}-{i}", float(sz))
            r.tick_resident()
            res = _drain(r)[-1]
            placed.append(sorted(res.placed))
            for _, row in res.placed:
                r.worker_free[row] += 1
            r.clock.t += 0.5
            for i in range(6):
                r.heartbeat(b"w%d" % i)
        return placed

    class Clock:
        t = 100.0

        def __call__(self):
            return self.t

    j = jres.ResidentScheduler(**_SMALL, clock=Clock(), placement="auction",
                               tick_backend="xla")
    t = tres.ResidentScheduler(**_SMALL, clock=Clock(), placement="auction",
                               device="cpu")
    want, got = drive(j), drive(t)
    assert want == got and all(want)


def test_resident_auction_matches_batch_auction_across_ticks():
    """Twin of the JAX suite's resident auction test: tick 1 opens from the
    seed, tick 2 from the carried prices, and each places exactly as the
    batch auction tick does."""
    r = _mk_resident(placement="auction")
    plain = TArrays(max_workers=16, max_pending=64, max_slots=4,
                    time_to_expire=10.0, clock=lambda: 100.0,
                    placement="auction", device="cpu")
    rng = np.random.default_rng(5)
    speeds = rng.uniform(0.5, 4.0, 6)
    for i in range(6):
        r.register(b"w%d" % i, 2, speed=float(speeds[i]))
        plain.register(b"w%d" % i, 2, speed=float(speeds[i]))
    sizes = rng.uniform(0.5, 5.0, 10).astype(f32)
    for i, sz in enumerate(sizes):
        r.pending_add(f"t{i}", float(sz))
    r.tick_resident()
    res1 = _drain(r)[-1]
    ref1 = plain.tick(sizes).assignment.numpy()[:10]
    assert dict(res1.placed) == {f"t{i}": int(w) for i, w in enumerate(ref1)
                                 if w >= 0}
    for _, row in res1.placed:
        r.worker_free[row] = min(r.worker_free[row] + 1,
                                 int(r.worker_procs[row]))
    plain.worker_free[:6] = 2
    r._clock_box[0] += 0.5
    for i in range(6):
        r.heartbeat(b"w%d" % i)
        plain.heartbeat(b"w%d" % i)
    sizes2 = (sizes * 1.01).astype(f32)
    for i, sz in enumerate(sizes2):
        r.pending_add(f"u{i}", float(sz))
    r.tick_resident()
    res2 = _drain(r)[-1]
    ref2 = plain.tick(sizes2).assignment.numpy()[:10]
    assert dict(res2.placed) == {f"u{i}": int(w) for i, w in enumerate(ref2)
                                 if w >= 0}
    assert not bool(r._r_state.refresh)
