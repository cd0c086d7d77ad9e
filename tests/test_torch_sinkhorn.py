"""Sinkhorn placement in the PyTorch port against the JAX reference.

``tpu_faas_torch/sched/sinkhorn.py`` and ``tpu_faas/sched/sinkhorn.py`` get
the same seeded numpy inputs on the CPU. The contract:

- exact for the rounding (``round_plan``, ``_repair_candidates``) fed
  identical inputs;
- ``_sinkhorn_fg`` fed the same arrays: potentials within POT_TOL of
  JAX's, in units of tau, with the same non-finite entries. XLA's CPU
  ``exp``/``log`` and torch's differ by an ulp on about a tenth of their
  inputs, and the sums run in other orders, so the iterations cannot agree
  bit for bit;
- the dense plan rebuilt from the same potentials within 1e-6, and a whole
  dense solve's plan within PLAN_ATOL;
- whole solves and ticks: legal, the same count placed, total cost
  (sum of size/speed) within rtol 1e-4, and the share of tasks assigned
  otherwise pinned at 0: every seeded case here assigns exactly as JAX does.

The JAX suite's own quality checks (tests/test_sched_sinkhorn.py) also run
against the port, as does the batch tick, ``SchedulerArrays(placement=
"sinkhorn")``, over several ticks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_faas.sched import oracle as joracle
from tpu_faas.sched import sinkhorn as J
from tpu_faas.sched.problem import PlacementProblem, check_assignment
from tpu_faas.sched.state import SchedulerArrays as JArrays
from tpu_faas.sched.state import scheduler_tick as j_tick
from tpu_faas_torch.sched import oracle as toracle
from tpu_faas_torch.sched import sinkhorn as P
from tpu_faas_torch.sched.greedy import makespan
from tpu_faas_torch.sched.state import SchedulerArrays as TArrays
from tpu_faas_torch.sched.state import scheduler_tick_impl as t_tick

f32, i32 = np.float32, np.int32
#: potentials, |df|/tau and |dg|/tau: a few ulps of |f/tau| <= 2^5 (3.8e-6
#: each); measured up to 2.4e-6 over 60 iterations
POT_TOL = 1e-5
#: a whole dense solve's plan: one ulp of logp at |logp| near 16 moves a
#: plan entry near 1 by 1.9e-6; measured up to 1.13e-6
PLAN_ATOL = 2e-6
#: total placement cost (sum of size/speed) against JAX's
COST_RTOL = 1e-4


def _problem(seed, T=80, W=24, live_frac=0.75):
    """The JAX suite's random invariants case, padded by PlacementProblem."""
    rng = np.random.default_rng(seed)
    sizes = rng.uniform(0.5, 5.0, T).astype(f32)
    speeds = rng.uniform(0.5, 4.0, W).astype(f32)
    free = rng.integers(0, 6, W).astype(i32)
    live = rng.random(W) > 1 - live_frac
    p = PlacementProblem.build(sizes, speeds, free, live)
    return [np.asarray(x) for x in (p.task_size, p.task_valid,
                                    p.worker_speed, p.worker_free,
                                    p.worker_live)]


def _both(args):
    return ([jnp.asarray(a) for a in args],
            [torch.from_numpy(np.array(a)) for a in args])


def _cost(a, sizes, speeds):
    placed = a >= 0
    return float(np.sum(sizes[placed] / speeds[a[placed]]))


def _assert_same_solve(got, want, sizes, speeds):
    """The whole-solve contract; exact wherever it holds, which is every
    seeded case of this file."""
    got, want = np.asarray(got), np.asarray(want)
    assert (got >= 0).sum() == (want >= 0).sum()
    np.testing.assert_allclose(_cost(got, sizes, speeds),
                               _cost(want, sizes, speeds), rtol=COST_RTOL)
    assert np.mean(got != want) == 0.0
    np.testing.assert_array_equal(got, want)


# -- the rounding, exact on identical inputs ---------------------------------
def _rounding_inputs(seed, T=300, W=24):
    rng = np.random.default_rng(seed)
    return dict(
        task_size=(rng.integers(0, 40, T) / 8).astype(f32),
        task_valid=rng.random(T) < 0.8,
        worker_speed=rng.choice(np.array([0.5, 1.0, 2.0, 4.0], f32), W),
        worker_free=rng.integers(-1, 7, W).astype(i32),
        worker_live=rng.random(W) < 0.85,
    ), rng


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_repair_candidates_matches_jax_exactly(seed):
    """Candidates with tied masses, +0.0 and -0.0, negative free counts and
    dead rows: the lexsort, segment rank, keep mask and rank spill agree
    exactly."""
    inputs, rng = _rounding_inputs(seed)
    T, W = inputs["task_size"].size, inputs["worker_speed"].size
    best_p = (rng.integers(0, 6, T) / 4).astype(f32)
    best_p[rng.random(T) < 0.1] = -0.0
    cand = dict(best_w=rng.integers(0, W, T).astype(i32), best_p=best_p,
                to_slack=rng.random(T) < 0.15)
    args = {**cand, **inputs}
    want = J._repair_candidates(**{k: jnp.asarray(v) for k, v in
                                   args.items()}, max_slots=4)
    got = P._repair_candidates(**{k: torch.from_numpy(v) for k, v in
                                  args.items()}, max_slots=4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy() >= 0).any()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_round_plan_matches_jax_exactly(seed):
    """A plan with tied maxima, exact zeros and slack columns that win,
    lose and tie: per-task argmax (first index), the slack test and the
    repair agree exactly."""
    inputs, rng = _rounding_inputs(seed, T=200, W=16)
    T, W = inputs["task_size"].size, inputs["worker_speed"].size
    plan = (rng.integers(0, 5, (T, W + 1)) / 4).astype(f32)
    plan[rng.random((T, W + 1)) < 0.2] = 0.0
    want = J.round_plan(jnp.asarray(plan),
                        *[jnp.asarray(v) for v in inputs.values()],
                        max_slots=4)
    got = P.round_plan(torch.from_numpy(plan),
                       *[torch.from_numpy(v) for v in inputs.values()],
                       max_slots=4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- the iterations, within tolerance ----------------------------------------
def _balanced(seed, R, C):
    """A balanced log-domain problem with absent rows and columns."""
    rng = np.random.default_rng(seed)
    a = rng.integers(1, 5, R).astype(f32)
    a[-3:-1] = 0
    b = rng.integers(1, 9, C).astype(f32)
    b[[2, 5]] = 0
    a[-1] = b[-1] = 0
    d = a.sum() - b.sum()
    if d > 0:
        b[-1] = d
    else:
        a[-1] = -d
    tau = f32(0.5)
    negc = (-(rng.lognormal(0, 1, R)[:, None]
              * rng.uniform(0.25, 2, C)[None, :]).astype(f32) / tau)
    negc[:, 5] = -np.inf
    negc[-1, -1] = -np.inf

    def log_marginal(x):
        return np.where(x > 0, np.log(np.maximum(x, f32(1e-30))),
                        -np.inf).astype(f32)

    return log_marginal(a), log_marginal(b), negc.astype(f32), tau


def _assert_potentials_close(got, want, tau):
    got, want = np.asarray(got), np.asarray(want)
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    np.testing.assert_array_equal(got[~fin], want[~fin])
    np.testing.assert_allclose(got[fin] / tau, want[fin] / tau, rtol=0,
                               atol=POT_TOL)


@pytest.mark.parametrize("R,C,n_iters", [(81, 25, 60), (1025, 257, 20)],
                         ids=["dense-like", "bucketed-like"])
def test_sinkhorn_fg_within_tolerance(R, C, n_iters):
    loga, logb, negc, tau = _balanced(R + C, R, C)
    fj, gj = jax.jit(J._sinkhorn_fg, static_argnums=(4,))(
        jnp.asarray(loga), jnp.asarray(logb), jnp.asarray(negc),
        jnp.float32(tau), n_iters)
    fp, gp = P._sinkhorn_fg(torch.from_numpy(loga), torch.from_numpy(logb),
                            torch.from_numpy(negc), torch.tensor(tau),
                            n_iters)
    _assert_potentials_close(fp, fj, tau)
    _assert_potentials_close(gp, gj, tau)


def test_dense_plan_from_same_potentials():
    """The dense problem built by the port, iterated by JAX: the port's plan
    from JAX's potentials equals JAX's own rebuild within 1e-6, and so
    does the rounding of it."""
    args = _problem(4)
    _, targs = _both(args)
    loga, logb, negc, tau = P._dense_problem(*targs, tau=P.TAU, max_slots=8)
    fj, gj = jax.jit(J._sinkhorn_fg, static_argnums=(4,))(
        jnp.asarray(loga.numpy()), jnp.asarray(logb.numpy()),
        jnp.asarray(negc.numpy()), jnp.float32(float(tau)), 60)
    plan_j = jnp.exp(jnp.asarray(negc.numpy())
                     + (fj[:, None] + gj[None, :]) / jnp.float32(float(tau)))
    res = P.sinkhorn_placement_impl(
        *targs, potentials=(torch.from_numpy(np.array(fj)),
                            torch.from_numpy(np.array(gj))))
    np.testing.assert_allclose(res.plan.numpy(), np.asarray(plan_j), rtol=0,
                               atol=1e-6)
    T = args[0].size
    want = J.round_plan(plan_j[:T], *[jnp.asarray(a) for a in args],
                        max_slots=8)
    np.testing.assert_array_equal(res.assignment.numpy(), np.asarray(want))


# -- whole solves against JAX, with the JAX suite's quality checks -----------
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sinkhorn_invariants_random(seed):
    args = _problem(seed)
    jargs, targs = _both(args)
    want = J.sinkhorn_placement(*jargs)
    got = P.sinkhorn_placement_impl(*targs)
    a = got.assignment.numpy()
    check_assignment(a, args[1], args[3], args[4])
    assert float(got.marginal_err) < 0.05
    np.testing.assert_allclose(got.plan.numpy(), np.asarray(want.plan),
                               rtol=0, atol=PLAN_ATOL)
    _assert_same_solve(a, want.assignment, args[0], args[2])


def _run_both(sizes, speeds, free, live, **kw):
    p = PlacementProblem.build(np.asarray(sizes, f32), np.asarray(speeds, f32),
                               np.asarray(free, i32), np.asarray(live, bool))
    args = [np.asarray(x) for x in (p.task_size, p.task_valid, p.worker_speed,
                                    p.worker_free, p.worker_live)]
    jargs, targs = _both(args)
    want = np.asarray(J.sinkhorn_placement(*jargs, **kw).assignment)
    got = P.sinkhorn_placement_impl(*targs, **kw).assignment.numpy()
    _assert_same_solve(got, want, args[0], args[2])
    return got


def test_sinkhorn_full_placement_when_capacity_ample():
    rng = np.random.default_rng(3)
    a = _run_both(rng.uniform(0.5, 5.0, 30), rng.uniform(1.0, 2.0, 10),
                  np.full(10, 8), np.ones(10, bool))
    assert (a[:30] >= 0).all()


def test_sinkhorn_overflow_stays_queued():
    a = _run_both(np.ones(10), [1.0, 1.0], [2, 1], [True, True])
    assert (a[:10] >= 0).sum() == 3


def test_sinkhorn_prefers_fast_workers():
    a = _run_both(np.ones(12), [4.0, 1.0], [8, 8], [True, True], tau=0.05)
    assert (a[:12] >= 0).all()
    assert (a[:12] == 0).sum() > (a[:12] == 1).sum()


def test_sinkhorn_dead_fleet():
    a = _run_both([1.0, 2.0], [1.0, 1.0], [4, 4], [False, False])
    assert (a == -1).all()


@pytest.mark.parametrize("bucketed", [False, True], ids=["dense", "bucketed"])
def test_sinkhorn_no_valid_task(bucketed):
    """An empty queue: every row of the problem is absent but the slack
    row, and nothing is placed, in both frameworks."""
    args = _problem(2)
    args[1] = np.zeros_like(args[1])
    jargs, targs = _both(args)
    if bucketed:
        want = J.sinkhorn_placement_bucketed(*jargs, n_iters=20,
                                             rounding="bucket")
        got = P.sinkhorn_placement_bucketed_impl(*targs, n_iters=20,
                                                 rounding="bucket")
    else:
        want = J.sinkhorn_placement(*jargs)
        got = P.sinkhorn_placement_impl(*targs)
    assert (got.assignment.numpy() == -1).all()
    np.testing.assert_array_equal(got.assignment.numpy(),
                                  np.asarray(want.assignment))
    assert bool(torch.isfinite(got.g[:-1]).any())


def test_sinkhorn_equal_speeds_tie_to_the_first_worker():
    """Many workers of one speed: identical columns, so every argmax is an
    exact tie that falls to the first index, in both frameworks."""
    a = _run_both(np.full(40, 2.0), np.full(16, 1.5), np.full(16, 2),
                  np.ones(16, bool))
    assert (a[:32] >= 0).all()


def test_sinkhorn_near_oracle_cost():
    """Total cost within 1.10x of the exact assignment, by the port's copy
    of the oracle (which equals JAX's)."""
    rng = np.random.default_rng(9)
    n = 40
    sizes = rng.uniform(0.5, 6.0, n).astype(f32)
    speeds = rng.uniform(0.5, 4.0, 12).astype(f32)
    free = np.full(12, 4, dtype=i32)
    live = np.ones(12, dtype=bool)
    a = _run_both(sizes, speeds, free, live, tau=0.01, n_iters=200,
                  max_slots=4)
    placed = a[:n] >= 0
    assert placed.all()
    cost = float(np.sum(sizes[placed] / speeds[a[:n][placed]]))
    got, cost_opt = toracle.optimal_assignment(sizes, speeds, free, live,
                                               max_slots=4)
    want, cost_j = joracle.optimal_assignment(sizes, speeds, free, live,
                                              max_slots=4)
    np.testing.assert_array_equal(got, want)
    assert cost_opt == cost_j
    assert cost <= cost_opt * 1.10
    assert toracle.makespan_lower_bound(sizes, speeds, free, live, 4) == (
        joracle.makespan_lower_bound(sizes, speeds, free, live, 4))


@pytest.mark.parametrize("dist", ["uniform", "lognormal", "bytes"],
                         ids=["uniform", "lognormal",
                              "payload-bytes-5-decades"])
@pytest.mark.parametrize("kernel", ["bucketed", "streamed"])
def test_memory_bounded_kernels_match_dense(dist, kernel):
    """The port's bucketed and streamed solvers place the same count as its
    dense one at within 1% of its total cost (the JAX suite's pin), and
    each assigns exactly as its JAX twin."""
    rng = np.random.default_rng(17)
    T, W = 768, 64
    sizes = {
        "uniform": rng.uniform(0.3, 6.0, T),
        "lognormal": rng.lognormal(0.0, 1.5, T),
        "bytes": 10 ** rng.uniform(1, 6, T),
    }[dist].astype(f32)
    speeds = rng.uniform(0.5, 4.0, W).astype(f32)
    free = rng.integers(0, 6, W).astype(i32)
    live = rng.random(W) > 0.2
    p = PlacementProblem.build(sizes, speeds, free, live, T=T, W=W)
    args = [np.asarray(x) for x in (p.task_size, p.task_valid,
                                    p.worker_speed, p.worker_free,
                                    p.worker_live)]
    jargs, targs = _both(args)
    dense = P.sinkhorn_placement_impl(*targs, max_slots=4).assignment.numpy()
    if kernel == "bucketed":
        other = P.sinkhorn_placement_bucketed_impl(*targs, max_slots=4,
                                                   chunk=256)
        twin = J.sinkhorn_placement_bucketed(*jargs, max_slots=4, chunk=256)
    else:
        other = P.sinkhorn_placement_streamed(*targs, max_slots=4, chunk=256)
        twin = J.sinkhorn_placement_streamed(*jargs, max_slots=4, chunk=256)
    a = other.assignment.numpy()
    check_assignment(a, args[1], args[3], args[4])
    assert (a >= 0).sum() == (dense >= 0).sum()
    assert _cost(a, sizes, speeds) <= 1.01 * _cost(dense, sizes, speeds)
    assert float(other.marginal_err) < 0.05
    _assert_same_solve(a, twin.assignment, sizes, speeds)


def test_bucketed_col_err_meaningful_with_excess_capacity():
    rng = np.random.default_rng(11)
    T, W = 64, 128  # 64 tasks on 512 slots
    res = P.sinkhorn_placement_bucketed_impl(
        torch.from_numpy(rng.uniform(0.1, 5.0, T).astype(f32)),
        torch.ones(T, dtype=torch.bool),
        torch.from_numpy(rng.uniform(0.5, 4.0, W).astype(f32)),
        torch.full((W,), 4, dtype=torch.int32),
        torch.ones(W, dtype=torch.bool),
        max_slots=8,
    )
    assert (res.assignment.numpy() >= 0).sum() == T
    assert float(res.marginal_err) < 0.05


@pytest.mark.parametrize("seed", [0, 1])
def test_bucket_rounding_matches_exact_quality(seed):
    """rounding="bucket" (the live tick's) against exact rounding, both in
    the port: the same count placed and makespan within 1.5%."""
    rng = np.random.default_rng(seed)
    n_tasks, n_workers, max_slots = 5_000, 256, 4
    sizes = rng.lognormal(0.0, 1.0, n_tasks).astype(f32)
    speeds = rng.uniform(0.5, 4.0, n_workers).astype(f32)
    free = rng.integers(0, max_slots + 1, n_workers).astype(i32)
    live = rng.random(n_workers) > 0.1
    valid = np.ones(n_tasks, dtype=bool)
    outs = {}
    for mode in ("exact", "bucket"):
        res = P.sinkhorn_placement_bucketed_impl(
            *[torch.from_numpy(x) for x in (sizes, valid, speeds, free,
                                            live)],
            tau=0.05, n_iters=20, max_slots=max_slots, rounding=mode)
        a = res.assignment.numpy()
        check_assignment(a, valid, free, live)
        outs[mode] = a
    assert (outs["bucket"] >= 0).sum() == (outs["exact"] >= 0).sum()
    ms_exact = makespan(outs["exact"], sizes, speeds, max_slots)
    ms_bucket = makespan(outs["bucket"], sizes, speeds, max_slots)
    assert ms_bucket <= ms_exact * 1.015, (ms_bucket, ms_exact)


@pytest.mark.parametrize("bucketed", [False, True], ids=["dense", "bucketed"])
def test_potentials_keyword_replays_the_rounding(bucketed):
    """A solve's own final potentials, given back by keyword, reproduce its
    assignment exactly: how a rounding is replayed from the CUDA kernel's
    potentials."""
    args = _problem(7, T=300, W=40)
    _, targs = _both(args)
    kw = dict(max_slots=4)
    fn = P.sinkhorn_placement_impl
    if bucketed:
        fn = P.sinkhorn_placement_bucketed_impl
        kw.update(n_iters=20, rounding="bucket")
    first = fn(*targs, **kw)
    again = fn(*targs, potentials=(first.f, first.g), **kw)
    np.testing.assert_array_equal(again.assignment.numpy(),
                                  first.assignment.numpy())
    assert float(again.tau) == float(first.tau)


# -- the batch tick ----------------------------------------------------------
def _tick_args(rng, T, W, I=64):
    free = rng.integers(-1, 5, W).astype(i32)
    return dict(
        task_size=rng.uniform(0.5, 5.0, T).astype(f32),
        task_valid=rng.random(T) < 0.9,
        worker_speed=rng.uniform(0.5, 4.0, W).astype(f32),
        worker_free=free,
        worker_active=rng.random(W) < 0.95,
        heartbeat_age=rng.uniform(0.0, 12.0, W).astype(f32),
        prev_live=rng.random(W) < 0.9,
        inflight_worker=np.where(rng.random(I) < 0.5, -1,
                                 rng.integers(0, W, I)).astype(i32),
    )


@pytest.mark.parametrize("T,W", [(64, 16), (8192, 2049)],
                         ids=["dense", "bucketed-8192x2049"])
def test_scheduler_tick_sinkhorn_matches_jax(T, W):
    """The tick's static route on T*W: dense below 2^24, bucketed with
    bucket rounding above (the JAX suite's 8,192 x 2,049)."""
    rng = np.random.default_rng(T + W)
    args = _tick_args(rng, T, W)
    want = j_tick(**{k: jnp.asarray(v) for k, v in args.items()},
                  time_to_expire=jnp.float32(10.0), max_slots=4,
                  placement="sinkhorn")
    got = t_tick(**{k: torch.from_numpy(v) for k, v in args.items()},
                 time_to_expire=10.0, max_slots=4, placement="sinkhorn")
    for field in ("live", "purged", "redispatch"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)))
    a = got.assignment.numpy()
    live = got.live.numpy()
    check_assignment(a, args["task_valid"], np.maximum(args["worker_free"], 0),
                     live)
    cap = int(np.clip(args["worker_free"], 0, 4)[live].sum())
    assert (a >= 0).sum() == min(int(args["task_valid"].sum()), cap)
    assert got.sinkhorn_f.shape[0] == (1025 if T * W > 2**24 else T + 1)
    _assert_same_solve(a, want.assignment, args["task_size"],
                       args["worker_speed"])


def _drive_arrays(a, seed):
    """Registrations, a silent worker, in-flight churn and varied batches
    over six Sinkhorn batch ticks; each tick's outputs as numpy."""
    rng = np.random.default_rng(seed)
    clock = [100.0]
    a.clock = lambda: clock[0]
    for i in range(12):
        a.register(b"w%d" % i, int(rng.integers(1, 5)),
                   speed=float(rng.uniform(0.5, 4.0)))
    outs = []
    for k in range(6):
        clock[0] += 1.0 if k != 3 else 11.0
        for i in range(12):
            if i != 2:  # w2 goes silent and is purged on tick 3
                a.heartbeat(b"w%d" % i)
        for j in range(int(rng.integers(0, 6))):
            a.inflight_add(f"t{k}-{j}", int(rng.integers(0, 12)))
        sizes = rng.lognormal(0.0, 1.0, int(rng.integers(5, 60))).astype(f32)
        out = a.tick(sizes)
        outs.append({f: np.asarray(getattr(out, f)) for f in
                     ("assignment", "live", "purged", "redispatch")})
        for row in np.flatnonzero(outs[-1]["purged"]):
            a.deactivate(int(row))
        # results come back for a few placements
        for w in np.unique(outs[-1]["assignment"][outs[-1]["assignment"]
                                                  >= 0])[:4]:
            a.release_slot(int(w))
    return outs


def test_scheduler_arrays_sinkhorn_matches_jax():
    kw = dict(max_workers=16, max_pending=64, max_inflight=128, max_slots=4,
              placement="sinkhorn")
    want = _drive_arrays(JArrays(**kw), seed=5)
    got = _drive_arrays(TArrays(**kw, device="cpu"), seed=5)
    assert any(o["purged"].any() for o in want)
    assert all((o["assignment"] >= 0).any() for o in want)
    for k, (w, g) in enumerate(zip(want, got)):
        for field in w:
            np.testing.assert_array_equal(g[field], w[field],
                                          err_msg=f"tick {k} {field}")
