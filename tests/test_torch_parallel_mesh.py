"""The port's mesh (``tpu_faas_torch/parallel/mesh.py``) against JAX's
``tpu_faas/parallel/mesh.py``: JAX on the suite's 8 virtual CPU devices,
the port on 8 CPU positions of one process, the same seeded numpy inputs.

Integer outputs (assignments, round counts, liveness, purge, redispatch)
must be equal. Float outputs are held to the tolerances the suite pins: the
sharded Sinkhorn's plan to JAX's sharded plan within 2e-6 (slice 4; every
live speed here is >= 0.5), and where a seed misses that, the miss is the
single-device solvers' own (pinned below). The auction is held to JAX on dyadic sizes and
power-of-two speeds, where every product and the seed's sum are exact in
f32 (slice 2's contract, tests/test_torch_auction.py: elsewhere XLA's
contraction and its cumsum order move the last bit of a bid); on any
input the port's sharded auction equals its single-device one exactly,
which the twin ``test_sharded_auction_permute_exact_parity`` holds.

The JAX file ``tests/test_parallel_mesh.py`` also runs against the port as
twins (``load_twins``): ``PlacementProblem`` is read from the reference and
turned into torch tensors, and ``jnp.asarray`` in its bodies into
``torch`` tensors.
"""

import types
from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_host_copies import load_twins
from tpu_faas.parallel import mesh as jmesh
from tpu_faas.sched.problem import PlacementProblem as JaxProblem
from tpu_faas_torch.parallel import mesh as tmesh
from tpu_faas_torch.sched import resident as tres
from tpu_faas_torch.sched import sinkhorn as tsink
from tpu_faas_torch.sched.scripted import scripted
from tpu_faas_torch.sched import state as tstate

# the suite runs as several worker processes sharing the machine's cores:
# torch's intra-op pool on every core makes their parallel regions wait on
# each other (a test of seconds took minutes), so each takes one thread
torch.set_num_threads(1)

f32 = np.float32
PLAN_ATOL = 2e-6  # slice 4's pin on a whole solve
PRICE_ATOL = 1e-5  # slice 2's pin on the bid values


@dataclass
class _CpuArrays(tstate.SchedulerArrays):
    """The port's SchedulerArrays on the CPU, where a JAX test builds one."""

    device: str = "cpu"


class _TorchProblem:
    """``PlacementProblem`` from the reference, its fields as torch."""

    @classmethod
    def build(cls, *a, **kw):
        p = JaxProblem.build(*a, **kw)
        return types.SimpleNamespace(**{
            f: torch.from_numpy(np.array(getattr(p, f)))
            for f in ("task_size", "task_valid", "worker_speed",
                      "worker_free", "worker_live")
        })


_torch_np = types.SimpleNamespace(
    asarray=lambda x: torch.from_numpy(np.array(x)),
    float32=lambda v: torch.tensor(v, dtype=torch.float32),
)


@pytest.fixture
def arrays_on_cpu(monkeypatch):
    monkeypatch.setattr(tstate, "SchedulerArrays", _CpuArrays)


_twins = load_twins(
    "test_parallel_mesh.py", {}, keep=("tpu_faas.sched.problem",),
    overrides={"make_mesh": partial(tmesh.make_mesh, device="cpu"),
               "PlacementProblem": _TorchProblem, "jnp": _torch_np},
)
for _name, _fn in _twins.items():
    if _name.startswith("test_"):
        globals()[_name] = pytest.mark.usefixtures("arrays_on_cpu")(_fn)
    elif _name == "mesh":
        globals()["mesh"] = _fn


@pytest.fixture(scope="module")
def meshes():
    if len(jax.devices()) < 8:
        pytest.skip("needs the suite's 8 virtual CPU devices")
    return jmesh.make_mesh(8), tmesh.make_mesh(8, device="cpu")


def _t(a):
    return torch.from_numpy(np.array(a))


def _problem(seed, T=512, W=32, n=300, K=4, dyadic=False):
    rng = np.random.default_rng(seed)
    sizes = np.zeros(T, f32)
    valid = np.zeros(T, bool)
    valid[:n] = True
    if dyadic:  # exact products and sums in f32 (the auction's contract)
        sizes[:n] = rng.integers(1, 21, n) * 0.25
        speeds = (2.0 ** rng.integers(-1, 3, W)).astype(f32)
    else:
        sizes[:n] = rng.uniform(0.2, 5.0, n)
        speeds = rng.uniform(0.5, 4.0, W).astype(f32)
    free = rng.integers(0, K + 1, W).astype(np.int32)
    live = rng.random(W) > 0.15
    return sizes, valid, speeds, free, live


# -- the ring ----------------------------------------------------------------
def _ring_inputs(seed, n=8, S=64):
    """Per-position bids from a few values (ties across positions), with
    -inf, 0.0 and -0.0 among them, and task ids with BIG sentinels."""
    rng = np.random.default_rng(seed)
    vals = np.array([-np.inf, -0.0, 0.0, 1.5, 1.5, 2.25, 3.0], f32)
    bids = vals[rng.integers(0, len(vals), (n, S))]
    tids = rng.integers(0, 64, (n, S)).astype(np.int32)
    tids[rng.random((n, S)) < 0.2] = tmesh.BIG
    tids[np.isneginf(bids)] = tmesh.BIG
    return bids, tids


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ring_winner_resolve_matches_jax(meshes, seed):
    jm, tm = meshes
    bids, tids = _ring_inputs(seed)
    n, S = bids.shape
    P = jax.sharding.PartitionSpec
    ring = jmesh._shard_map(
        lambda b, t: jmesh.ring_winner_resolve(b, t, n), jm,
        in_specs=(P(jmesh.TASK_AXIS), P(jmesh.TASK_AXIS)),
        out_specs=(P(jmesh.TASK_AXIS), P(jmesh.TASK_AXIS)),
    )
    jp, jt = (np.asarray(x).reshape(n, S)
              for x in jax.jit(ring)(jnp.asarray(bids.reshape(-1)),
                                     jnp.asarray(tids.reshape(-1))))
    tp, tt = tmesh.ring_winner_resolve(tm, [_t(b) for b in bids],
                                       [_t(t) for t in tids])
    for i in range(n):
        got_p, got_t = tp[i].numpy(), tt[i].numpy()
        np.testing.assert_array_equal(got_p, jp[i])
        np.testing.assert_array_equal(np.signbit(got_p), np.signbit(jp[i]))
        np.testing.assert_array_equal(got_t, jt[i])
    # every position holds the same winners
    assert all(torch.equal(tt[0], x) for x in tt)


def test_collectives_reduce_and_shift_in_position_order():
    m = tmesh.make_mesh(4, device="cpu")
    xs = [torch.tensor([float(i), -float(i)]) for i in range(4)]
    assert all(torch.equal(s, torch.tensor([6.0, -6.0]))
               for s in tmesh.psum(m, xs))
    assert all(torch.equal(s, torch.tensor([3.0, 0.0]))
               for s in tmesh.pmax(m, xs))
    assert [float(v[0]) for v in tmesh.ppermute(m, xs)] == [3.0, 0.0, 1.0,
                                                            2.0]
    assert torch.equal(tmesh.all_gather(m, xs),
                       torch.tensor([0.0, -0.0, 1, -1, 2, -2, 3, -3]))


def test_make_mesh_fails_fast_without_the_cards(monkeypatch):
    """JAX's device-count message: a mesh silently on fewer cards than
    asked for is a misconfiguration."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError,
                       match="mesh_devices=4 but only 1 CUDA devices"):
        tmesh.make_mesh(4, device="cuda")
    m = tmesh.make_mesh(devices=["cpu"] * 4)
    assert m.size == 4 and m.devices == [torch.device("cpu")] * 4


# -- the sharded functions against JAX's --------------------------------------
def _jax_sharded_plan(monkeypatch, jm, *args):
    """JAX's sharded plan f32[T, W+1]: its ``sharded_sinkhorn_placement``
    traced afresh with the rounding replaced by the identity."""
    monkeypatch.setattr(jmesh, "round_plan", lambda plan, *a: plan)

    def plan_only(*a):  # a new function: JAX traces it afresh
        return jmesh.sharded_sinkhorn_placement.__wrapped__(
            jm, *a, max_slots=4)

    return np.asarray(jax.jit(plan_only)(*args))


def _sinkhorn_both(meshes, seed, monkeypatch):
    """(port assignment, JAX assignment, port plan, JAX plan) of the
    sharded Sinkhorn on one seeded problem."""
    jm, tm = meshes
    sizes, valid, speeds, free, live = _problem(seed, W=32)
    jts, jtv = jmesh.shard_task_arrays(jm, jnp.asarray(sizes),
                                       jnp.asarray(valid))
    jws, jwf, jwl = jmesh.replicate(jm, jnp.asarray(speeds),
                                    jnp.asarray(free), jnp.asarray(live))
    want = np.asarray(jmesh.sharded_sinkhorn_placement(
        jm, jts, jtv, jws, jwf, jwl, max_slots=4))
    ts, tv = tmesh.shard_task_arrays(tm, sizes, valid)
    got = tmesh.sharded_sinkhorn_placement(tm, ts, tv, _t(speeds), _t(free),
                                           _t(live), max_slots=4)
    plan = tmesh.sharded_sinkhorn_plan(tm, ts, tv, _t(speeds), _t(free),
                                       _t(live), max_slots=4)
    want_plan = _jax_sharded_plan(monkeypatch, jm, jts, jtv, jws, jwf, jwl)
    return got.numpy(), want, plan.numpy(), want_plan


@pytest.mark.parametrize("seed", [2, 4, 6])
def test_sharded_sinkhorn_matches_jax(meshes, seed, monkeypatch):
    got, want, plan, want_plan = _sinkhorn_both(meshes, seed, monkeypatch)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(plan, want_plan, rtol=0, atol=PLAN_ATOL)


@pytest.mark.parametrize("seed", [0, 3])
def test_sharded_sinkhorn_gap_is_the_dense_solvers_gap(meshes, seed,
                                                      monkeypatch):
    """Pinned (ROADMAP, differences no code can remove): on these seeds
    the plans differ by more than PLAN_ATOL (3.76e-6 and 3.46e-6), and so
    do the single-device dense solves, JAX's against the port's, on the
    same inputs: the gap is slice 4's (XLA's exp, log and reduction order
    against torch's), and the sharded path adds none of its own. The
    assignments are equal."""
    from tpu_faas.sched.sinkhorn import sinkhorn_placement as jax_dense
    from tpu_faas_torch.sched.sinkhorn import sinkhorn_placement

    got, want, plan, want_plan = _sinkhorn_both(meshes, seed, monkeypatch)
    np.testing.assert_array_equal(got, want)
    args = _problem(seed)
    dense_gap = np.abs(
        np.asarray(jax_dense(*(jnp.asarray(x) for x in args),
                             max_slots=4).plan)
        - sinkhorn_placement(*(_t(x) for x in args), max_slots=4)
        .plan.numpy())[:len(args[0])].max()
    gap = np.abs(plan - want_plan).max()
    assert PLAN_ATOL < gap <= dense_gap


def _stacked_case(seed: int):
    """A problem for the sharded plan: position counts, shard lengths and
    widths varied, with a NaN size, equal sizes, a zero speed and negative
    free counts among the seeds."""
    rng = np.random.default_rng(seed)
    P, Tl, W = (1, 2, 4, 8)[seed % 4], (2, 8, 64, 300)[seed % 4], \
        (32, 7, 129, 512)[seed % 3]
    ts = torch.tensor(rng.lognormal(0, 1, P * Tl).astype(f32))
    tv = torch.tensor(rng.random(P * Tl) < 0.8)
    if seed == 5:
        ts[3] = float("nan")
    if seed == 6:
        ts[:] = 1.0
    sp = torch.tensor(rng.uniform(0.5, 4.0, W).astype(f32))
    if seed == 7:
        sp[0] = 0.0
    fr = torch.tensor(rng.integers(-1, 9, W).astype(np.int32))
    lv = torch.tensor(rng.random(W) < 0.9)
    m = tmesh.make_mesh(P, device="cpu")
    return m, (*tmesh.shard_task_arrays(m, ts, tv), sp, fr, lv)


def _runs_of_one(mesh):
    """Each position a run of its own: the layout of a process whose
    positions each have a card."""
    return [(i, i + 1, d) for i, d in enumerate(mesh.devices)]


def _eager_sinkhorn_plan(mesh, runs, task_size, task_valid, worker_speed,
                         worker_free, worker_live, tau=0.05, n_iters=60,
                         max_slots=8):
    """The sharded plan's body as eager torch ops, one process: the body
    the scripted one replaced (ROADMAP C.11), kept as its reference. The
    scripted body must issue these ops in this order, bit for bit."""
    inf = float("inf")
    lead = mesh.lead

    def per_run(x):
        if isinstance(x, (list, tuple)):
            return [x[a].to(d) for a, _, d in runs]
        return [x.to(d) for _, _, d in runs]

    def fold(parts, op):
        local = (parts[0].to(lead) if len(parts) == 1
                 else torch.cat([q.to(lead) for q in parts]))
        first, *rest = local.to(lead).unbind(0)
        for x in rest:
            first = op(first, x)
        return [first.to(d) for _, _, d in runs]

    R = range(len(runs))
    ts = [torch.stack(list(task_size[a:b])) for a, b, _ in runs]
    tv = [torch.stack(list(task_valid[a:b])) for a, b, _ in runs]
    speed, free, live = (per_run(x)
                         for x in (worker_speed, worker_free, worker_live))
    cap = [torch.where(lv, fr.clamp(max=max_slots), 0).to(torch.float32)
           for lv, fr in zip(live, free)]
    n_tasks = fold([v.sum(1).to(torch.float32) for v in tv], torch.add)
    total_cap = [c.sum() for c in cap]
    cost = [ts[r][:, :, None] / speed[r].clamp_min(1e-6)[None, None, :]
            for r in R]
    mask = [tv[r][:, :, None] & (cap[r][None, None, :] > 0) for r in R]
    cmax = fold([torch.where(mask[r], cost[r], 0.0).amax(dim=(1, 2))
                 for r in R], torch.maximum)
    loga, loga_slack, logb, negc, negc_slack, tau_eff = [], [], [], [], [], []
    for r in R:
        slack_cost = cmax[r] + 1.0
        te = tau * cmax[r].clamp_min(1e-30)
        cost_all = torch.cat([
            torch.where(mask[r], cost[r], inf),
            torch.where(tv[r], slack_cost, inf)[:, :, None],
        ], dim=2)
        b = torch.cat([cap[r],
                       (n_tasks[r] - total_cap[r]).clamp_min(0.0)[None]])
        a_slack = (total_cap[r] - n_tasks[r]).clamp_min(0.0)
        loga.append(torch.where(tv[r], 0.0, -inf))
        loga_slack.append(torch.where(
            a_slack > 0, torch.log(a_slack.clamp_min(1e-30)), -inf))
        logb.append(torch.where(b > 0, torch.log(b.clamp_min(1e-30)), -inf))
        negc.append(-cost_all / te)
        negc_slack.append(torch.cat([
            torch.where(cap[r] > 0, 0.0, -inf),
            torch.full((1,), -inf, device=cap[r].device),
        ]))
        tau_eff.append(te)
    W = cap[0].shape[0]
    f = [torch.zeros_like(t) for t in ts]
    g = [torch.zeros(W + 1, dtype=torch.float32, device=d) for *_, d in runs]
    rows_in, slack_in, cols_in = ([torch.isfinite(x) for x in xs]
                                  for xs in (loga, loga_slack, logb))
    for _ in range(n_iters):
        z, slack_z = [], []
        for r in R:
            te = tau_eff[r]
            g_te = g[r] / te
            fi = te * (loga[r] - tsink._logsumexp(negc[r] + g_te, 2))
            f[r] = torch.where(rows_in[r], fi, -inf)
            fs = te * (loga_slack[r]
                       - tsink._logsumexp(negc_slack[r] + g_te, 0))
            f_slack = torch.where(slack_in[r], fs, -inf)
            z.append(negc[r] + f[r][:, :, None] / te)
            slack_z.append(negc_slack[r] + f_slack / te)
        zmax = fold([zr.amax(dim=1) for zr in z], torch.maximum)
        zmax_s = [torch.maximum(zmax[r], slack_z[r]) for r in R]
        zmax_safe = [torch.where(torch.isfinite(m), m, 0.0) for m in zmax_s]
        expsum = fold([torch.exp(z[r] - zmax_safe[r]).sum(1) for r in R],
                      torch.add)
        for r in R:
            es = expsum[r] + torch.exp(slack_z[r] - zmax_safe[r])
            lse = zmax_safe[r] + torch.log(es.clamp_min(1e-30))
            lse = torch.where(torch.isfinite(zmax_s[r]), lse, -inf)
            gi = tau_eff[r] * (logb[r] - lse)
            g[r] = torch.where(cols_in[r], gi, -inf)
    plan = [torch.exp(negc[r] + (f[r][:, :, None] + g[r]) / tau_eff[r])
            for r in R]
    return torch.cat([p.to(lead) for pr in plan for p in pr.unbind(0)])


def _same_bits(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.equal(got.nan_to_num(7.0).view(torch.int32),
                       want.nan_to_num(7.0).view(torch.int32))


@pytest.mark.parametrize("layout", ["one_run", "runs_of_one"])
@pytest.mark.parametrize("seed", range(8))
def test_scripted_sinkhorn_plan_is_the_eager_body(seed, layout, monkeypatch):
    """ROADMAP C.11: the scripted plan (one call a solve) equals the eager
    body it replaced bit for bit, NaN in the same places, with the
    process's positions stacked as one run and each a run of its own."""
    m, args = _stacked_case(seed)
    if layout == "runs_of_one":
        monkeypatch.setattr(tmesh, "_device_runs", _runs_of_one)
    got = tmesh.sharded_sinkhorn_plan(m, *args, max_slots=8)
    _same_bits(got, _eager_sinkhorn_plan(m, tmesh._device_runs(m), *args,
                                         max_slots=8))


@pytest.mark.parametrize("seed", range(8))
def test_stacked_sinkhorn_plan_is_the_position_loop(seed, monkeypatch):
    """ROADMAP C.11: one process holding every position on one device
    iterates them as one stacked run; the plan is that of the same
    positions iterated one a run (one card a position) bit for bit, NaN
    in the same places."""
    m, args = _stacked_case(seed)
    got = tmesh.sharded_sinkhorn_plan(m, *args, max_slots=8)
    assert len(tmesh._device_runs(m)) == 1
    monkeypatch.setattr(tmesh, "_device_runs", _runs_of_one)
    want = tmesh.sharded_sinkhorn_plan(m, *args, max_slots=8)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.equal(got.nan_to_num(7.0), want.nan_to_num(7.0))


def test_device_runs_group_neighbours_on_one_device():
    """The runs are maximal neighbours on one device, in position order."""
    a, b = torch.device("cuda", 0), torch.device("cuda", 1)
    m = tmesh.Mesh([(0, a), (0, a), (0, b), (0, a)])
    assert tmesh._device_runs(m) == [(0, 2, a), (2, 3, b), (3, 4, a)]
    cpu = torch.device("cpu")
    assert tmesh._device_runs(tmesh.make_mesh(4, device="cpu")) == [
        (0, 4, cpu)]


def test_stacked_sinkhorn_issues_a_fraction_of_the_ops(monkeypatch):
    """ROADMAP C.11: the shared mesh dispatchers' tick (8 pending, 32
    workers, 4 host positions) holds the interpreter lock for each torch
    op it issues. At 60 iterations the per-position loop this body
    replaced issued about 20,800 (aten ops), which under a loaded suite
    stretched a tick past the 3 s lease (a live sibling's claims adopted,
    the race monitor's double dispatches); the body run one position a run
    issues about 17,500, and the 4 positions stacked as one run about
    4,700."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    m = tmesh.make_mesh(4, device="cpu")
    ts, tv = tmesh.shard_task_arrays(m, torch.ones(8),
                                     torch.ones(8, dtype=torch.bool))
    fleet = (torch.ones(32), torch.full((32,), 2, dtype=torch.int32),
             torch.arange(32) < 2)

    def ops() -> int:
        Count.n = 0
        with Count():
            tmesh.sharded_sinkhorn_plan(m, ts, tv, *fleet)
        return Count.n

    stacked = ops()
    monkeypatch.setattr(tmesh, "_device_runs", _runs_of_one)
    looped = ops()
    assert looped > 15_000 and stacked * 3.5 < looped, (looped, stacked)


def _twin_shape_tick(placement="sinkhorn"):
    """A tick function at the shared mesh dispatchers' shape
    (tests/test_combined_modes_e2e.py): 8 pending over 4 host positions,
    32 worker rows, two of them live with two free slots, 256 in-flight
    rows."""
    m = tmesh.make_mesh(4, device="cpu")
    (ts,) = tmesh.shard_task_arrays(m, np.linspace(0.5, 2.0, 8, dtype=f32))
    live = torch.arange(32) < 2
    fleet = (torch.ones(32), torch.where(live, 2, 0).to(torch.int32), live,
             torch.where(live, 0.1, 9.0), live,
             torch.full((256,), -1, dtype=torch.int32))

    def tick():
        return tmesh.sharded_scheduler_tick(m, ts, None, *fleet, 2.0,
                                            placement=placement, n_valid=8)

    return tick


#: torch calls from Python a Sinkhorn mesh tick may make (ROADMAP C.11:
#: 4,056 before its body was scripted, each a hand-off of the lock)
MAX_TICK_CALLS = 200


def test_sinkhorn_tick_makes_few_torch_calls_from_python():
    """ROADMAP C.11: each torch call from Python releases and retakes the
    interpreter lock around its op, and under threads contending in the
    dispatcher's process a tick of thousands outlasted the shared
    dispatchers' 3 s lease. The scripted tick makes at most
    MAX_TICK_CALLS (counted by a TorchFunctionMode, which sees no op
    inside a scripted call), and places as the eager body did."""
    from tpu_faas_torch.sched.scripted import CallCount

    tick = _twin_shape_tick()
    first = tick()
    with CallCount() as calls:
        out = tick()
    assert calls.n <= MAX_TICK_CALLS, calls.n
    assert torch.equal(out.assignment, first.assignment)
    assert int((out.assignment >= 0).sum()) == 4  # two workers, two slots


def test_scripted_sinkhorn_runs_unfused_where_the_fuser_is_on():
    """The body runs with the graph executor's optimisations off (a
    thread's own setting, where ``torch.jit.fuser("none")`` would switch
    process-wide flags under the other dispatcher's thread), so no fuser
    touches it even where one is on, as NNC is for the card on a CUDA
    build: with the CPU fuser forced on, the graph it executed holds no
    fusion group and its plan keeps the eager body's bits."""
    fusers = ("prim::TensorExprGroup", "prim::FusionGroup",
              "prim::CudaFusionGroup")
    m, args = _stacked_case(2)
    want = _eager_sinkhorn_plan(m, tmesh._device_runs(m), *args, n_iters=3)
    old = torch._C._jit_can_fuse_on_cpu(), torch._C._jit_texpr_fuser_enabled()
    torch._C._jit_override_can_fuse_on_cpu(True)
    torch._C._jit_set_texpr_fuser_enabled(True)
    try:
        for _ in range(3):  # past the profiling executor's warm-up runs
            got = tmesh.sharded_sinkhorn_plan(m, *args, n_iters=3)
        graph = str(torch.jit.last_executed_optimized_graph())
    finally:
        torch._C._jit_override_can_fuse_on_cpu(old[0])
        torch._C._jit_set_texpr_fuser_enabled(old[1])
    _same_bits(got, want)
    assert "aten::exp" in graph and "aten::log" in graph
    assert not any(k in graph for k in fusers)


def test_sinkhorn_body_that_fails_to_compile_raises(monkeypatch):
    """No eager fallback: a body TorchScript refuses fails the tick."""
    def refuse(fn, *a, **kw):
        raise RuntimeError("refused")

    scripted.cache_clear()
    monkeypatch.setattr(torch.jit, "script", refuse)
    try:
        with pytest.raises(RuntimeError, match="refused"):
            _twin_shape_tick()()
    finally:
        monkeypatch.undo()
        scripted.cache_clear()


def test_mesh_arrays_compile_the_sinkhorn_tick_before_their_first(
        monkeypatch):
    """SchedulerArrays(mesh_devices=N, placement="sinkhorn") compiles the
    scripted tick where it is built (the dispatcher's constructor), so the
    first tick, inside a lease, compiles nothing."""
    scripted.cache_clear()
    a = tstate.SchedulerArrays(max_workers=32, max_pending=8, max_slots=8,
                               placement="sinkhorn", mesh_devices=4,
                               device="cpu")

    def refuse(fn, *args, **kw):
        raise AssertionError("compiled inside a tick")

    monkeypatch.setattr(torch.jit, "script", refuse)
    a.register(b"w0", 2)
    out = a.tick(np.ones(3, f32))
    assert int((out.assignment >= 0).sum()) == 2


@pytest.mark.parametrize("warm", [False, True])
def test_permute_auction_bids_a_run_as_one_block(warm, monkeypatch):
    """The permute auction bids each run of positions on one device as one
    block (one B2 launch a run a round, ROADMAP C.11's cut of its host
    calls): its result equals the same positions bid one a run and
    resolved around the ring, bit for bit, on sizes and speeds that are
    not dyadic, warm and cold."""
    m = tmesh.make_mesh(4, device="cpu")
    sizes, valid, speeds, free, live = _problem(9, T=256, W=64, n=200)
    ts, tv = tmesh.shard_task_arrays(m, sizes, valid)
    fleet = (_t(speeds), _t(free), _t(live))
    kw = {}
    if warm:
        cold = tmesh.sharded_auction_placement(m, ts, tv, *fleet,
                                               max_slots=4)
        kw["init_price"] = cold.prices * 1.01
    calls = []
    bid = tmesh.bid_top2
    monkeypatch.setattr(tmesh, "bid_top2",
                        lambda *a, **k: calls.append(1) or bid(*a, **k))

    def solve():
        calls.clear()
        return tmesh.sharded_auction_placement(m, ts, tv, *fleet,
                                               max_slots=4, **kw), len(calls)

    (got, got_calls), runs = solve(), tmesh._device_runs(m)
    monkeypatch.setattr(tmesh, "_device_runs", _runs_of_one)
    want, want_calls = solve()
    assert got.n_rounds > 1
    assert (got_calls, want_calls) == (got.n_rounds * len(runs),
                                       want.n_rounds * 4)
    for f in got._fields:
        a, b = getattr(got, f), getattr(want, f)
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b) and a.dtype == b.dtype, f
            if a.is_floating_point():
                assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        else:
            assert a == b, f


@pytest.mark.parametrize("warm", [False, True])
def test_sharded_auction_matches_jax(meshes, warm):
    jm, tm = meshes
    sizes, valid, speeds, free, live = _problem(5, T=1024, W=128, n=600,
                                                dyadic=True)
    jts, jtv = jmesh.shard_task_arrays(jm, jnp.asarray(sizes),
                                       jnp.asarray(valid))
    jfleet = jmesh.replicate(jm, jnp.asarray(speeds), jnp.asarray(free),
                             jnp.asarray(live))
    ts, tv = tmesh.shard_task_arrays(tm, sizes, valid)
    fleet = (_t(speeds), _t(free), _t(live))
    jkw, tkw = {}, {}
    if warm:
        cold = jmesh.sharded_auction_placement(jm, jts, jtv, *jfleet,
                                               max_slots=4)
        prices = np.asarray(cold.prices)
        jkw["init_price"] = jnp.asarray(prices)
        tkw["init_price"] = _t(prices)
    want = jmesh.sharded_auction_placement(jm, jts, jtv, *jfleet,
                                           max_slots=4, **jkw)
    got = tmesh.sharded_auction_placement(tm, ts, tv, *fleet, max_slots=4,
                                          **tkw)
    np.testing.assert_array_equal(got.assignment.numpy(),
                                  np.asarray(want.assignment))
    assert got.n_rounds == int(want.n_rounds)
    np.testing.assert_allclose(got.prices.numpy(), np.asarray(want.prices),
                               rtol=0, atol=PRICE_ATOL)
    assert bool(got.refresh) == bool(want.refresh)


@pytest.mark.parametrize("placement,resolve", [
    ("rank", "gspmd"), ("auction", "gspmd"), ("auction", "permute"),
    ("sinkhorn", "gspmd"),
])
def test_sharded_tick_matches_jax(meshes, placement, resolve):
    jm, tm = meshes
    rng = np.random.default_rng(11)
    T, W, I = 512, 64, 256
    sizes, valid, speeds, free, _ = _problem(
        11, T=T, W=W, dyadic=placement == "auction")
    active = rng.random(W) > 0.1
    hb_age = rng.uniform(0.0, 15.0, W).astype(f32)
    prev_live = rng.random(W) > 0.5
    inflight = rng.integers(-1, W, I).astype(np.int32)
    prio = rng.integers(-2, 3, T).astype(np.int32)
    use_prio = placement == "rank"
    jts, jtv, jpr = jmesh.shard_task_arrays(
        jm, jnp.asarray(sizes), jnp.asarray(valid), jnp.asarray(prio))
    jfleet = jmesh.replicate(
        jm, *(jnp.asarray(x) for x in (speeds, free, active, hb_age,
                                       prev_live, inflight)))
    want = jmesh.sharded_scheduler_tick(
        jm, jts, jtv, *jfleet, jnp.float32(10.0), max_slots=4,
        placement=placement, task_priority=jpr if use_prio else None,
        winner_resolve=resolve)
    ts, tv, pr = tmesh.shard_task_arrays(tm, sizes, valid, prio)
    got = tmesh.sharded_scheduler_tick(
        tm, ts, tv, *(_t(x) for x in (speeds, free, active, hb_age,
                                      prev_live, inflight)),
        10.0, max_slots=4, placement=placement,
        task_priority=pr if use_prio else None, winner_resolve=resolve)
    for field in ("assignment", "live", "purged", "redispatch"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)),
                                      err_msg=field)
    if placement == "auction":
        np.testing.assert_allclose(got.auction_price.numpy(),
                                   np.asarray(want.auction_price),
                                   rtol=0, atol=PRICE_ATOL)


@pytest.mark.parametrize("placement", ["rank", "auction", "sinkhorn"])
def test_scheduler_arrays_mesh_matches_jax(meshes, placement):
    """SchedulerArrays(mesh_devices=8): two ticks (the auction's second
    warm) on the port's 8 CPU positions and JAX's 8 virtual devices."""
    from tpu_faas.sched.state import SchedulerArrays as JaxArrays

    def build(cls, **kw):
        a = cls(max_workers=32, max_pending=200, max_slots=4,
                placement=placement, mesh_devices=8, clock=lambda: 100.0,
                **kw)
        rng = np.random.default_rng(7)
        for i in range(12):
            speed = (2.0 ** int(rng.integers(-1, 3)) if dyadic
                     else float(rng.uniform(0.5, 3.0)))
            a.register(f"w{i}".encode(), int(rng.integers(1, 5)),
                       speed=speed)
        return a

    dyadic = placement == "auction"
    jax_a, port = build(JaxArrays), build(tstate.SchedulerArrays,
                                          device="cpu")
    assert port.max_pending == jax_a.max_pending == 200
    assert port.mesh.size == 8
    rng = np.random.default_rng(12)
    sizes = (rng.integers(1, 37, 150) * 0.25 if dyadic
             else rng.uniform(0.1, 9.0, 150)).astype(f32)
    prios = rng.integers(-2, 3, 150).astype(np.int32)
    for scale in (1.0, 1.5 if dyadic else 1.01):
        kw = {"task_priorities": prios} if placement == "rank" else {}
        want = jax_a.tick(sizes * f32(scale), **kw)
        got = port.tick(sizes * f32(scale), **kw)
        np.testing.assert_array_equal(got.assignment.numpy(),
                                      np.asarray(want.assignment))
        np.testing.assert_array_equal(got.live.numpy(),
                                      np.asarray(want.live))


def test_scheduler_arrays_mesh_pads_and_refuses_single_device_lanes():
    a = tstate.SchedulerArrays(max_pending=100, mesh_devices=8,
                               device="cpu")
    assert a.max_pending == 104 and a.mesh.size == 8
    with pytest.raises(ValueError, match="single-device"):
        a.tick(np.ones(3, f32), task_avoid=np.full(3, -1))
    with pytest.raises(ValueError, match="single-device"):
        a.tick(np.ones(3, f32), task_pref=np.full(104, -1, np.int32))


# -- the resident state under a mesh ----------------------------------------
def _mesh_scenario(r):
    """Registrations, prioritized arrivals, heartbeats, a result freeing a
    slot, late arrivals — resolved tick for tick (JAX's
    tests/test_sched_resident.py scenario)."""
    def drain():
        out = []
        while (res := r.resolve_next()) is not None:
            out.append(res)
        return out

    clock = r._clock_box
    rng = np.random.default_rng(0)
    speeds = rng.uniform(0.5, 4.0, 6)
    for i in range(6):
        r.register(b"w%d" % i, 1 + i % 3, speed=float(speeds[i]))
    for i, s in enumerate(rng.uniform(0.5, 5.0, 20)):
        r.pending_add(f"t{i}", float(s), priority=i % 3)
    r.tick_resident()
    outs = drain()
    clock[0] += 1.0
    for i in range(6):
        r.heartbeat(b"w%d" % i)
    r.pending_add("late1", 2.0)
    r.pending_add("late2", 0.3)
    r.tick_resident()
    outs += drain()
    return [(sorted(res.placed), res.n_pending) for res in outs]


def _resident(cls, **kw):
    clock_box = [100.0]
    r = cls(max_workers=16, max_pending=64, max_inflight=32, max_slots=4,
            time_to_expire=10.0, clock=lambda: clock_box[0],
            use_priority=True, **kw)
    r._clock_box = clock_box
    return r


@pytest.mark.parametrize("placement", ["rank", "sinkhorn", "auction"])
def test_resident_mesh_matches_jax(placement):
    """JAX's test_resident_mesh_matches_single_device contract, held to
    JAX itself: the port's resident state under an 8-position mesh resolves
    rank and auction placement for placement like JAX's single-device
    resident path (and like the port's own single-device path), Sinkhorn
    with the same placed counts and pending totals."""
    from tpu_faas.sched.resident import ResidentScheduler as JaxResident

    want = _mesh_scenario(_resident(JaxResident, placement=placement))
    mesh = _resident(tres.ResidentScheduler, placement=placement,
                     mesh_devices=8, device="cpu")
    assert mesh.mesh is not None and mesh.mesh.size == 8
    got = _mesh_scenario(mesh)
    single = _mesh_scenario(_resident(tres.ResidentScheduler,
                                      placement=placement, device="cpu"))
    assert got == single
    if placement in ("rank", "auction"):
        assert got == want
    else:
        assert [(len(p), n) for p, n in got] == [(len(p), n)
                                                 for p, n in want]


def test_fused_tick_serves_the_mesh():
    """Where JAX refuses its fused backend on a mesh
    (tests/test_sched_fused.py::test_fused_rejects_mesh_combination), the
    port runs B1 (its plain version on the CPU) on every tick under the
    mesh: one launch a tick, the task axis padded to the mesh, the task
    leaves whole on the first position's device."""
    r = tres.ResidentScheduler(max_workers=8, max_pending=30, max_slots=2,
                               mesh_devices=4, device="cpu")
    assert r.max_pending == 32 and r.mesh.size == 4
    r.register(b"w0", 2)
    for i in range(5):
        r.pending_add(f"t{i}", 1.0)
    r.tick_resident()
    assert r.device_dispatches_last_tick == 1
    assert r._r_state.sizes.shape == (32,)
    res = r.resolve_next()
    assert len(res.placed) == 2 and res.n_pending == 3
