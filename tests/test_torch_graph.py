"""The graph frontier in the PyTorch port against the JAX reference.

``tpu_faas_torch/graph/frontier.py`` (the dependency mask, the byte
preference, the locality exchange and the copied host bookkeeping) and the
batch tick's graph lanes get the same seeded numpy inputs as
``tpu_faas/graph/frontier.py`` and JAX's ``SchedulerArrays.tick`` (on the
CPU). Every output is an integer or bool vector and must be exactly equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_faas.graph import frontier as jfr
from tpu_faas.sched.state import SchedulerArrays as JArrays
from tpu_faas.tenancy import TenantTable as JTable
from tpu_faas_torch.core.payload import payload_digest
from tpu_faas_torch.graph.frontier import (
    GraphFrontier,
    dep_ready_mask,
    locality_exchange,
    pad_edges,
    pad_pref,
    parent_pref_impl,
)
from tpu_faas_torch.sched.state import SchedulerArrays as TArrays
from tpu_faas_torch.sched.state import packed_tick
from tpu_faas_torch.tenancy import TenantTable

f32, i32 = np.float32, np.int32


def _t(*xs):
    return [torch.from_numpy(np.asarray(x)) for x in xs]


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


class _Task:
    def __init__(self, tid):
        self.task_id = tid


# ---------------------------------------------------------------------------
# twins of tests/test_graph.py's device-frontier cases
# ---------------------------------------------------------------------------
def _mask_both(child, undone, T):
    got = dep_ready_mask(*_t(child, undone), T=T).numpy()
    want = np.asarray(jfr.dep_ready_mask(*_j(child, undone), T=T))
    np.testing.assert_array_equal(got, want)
    return got


def _exchange_both(assignment, pref, speed):
    got = locality_exchange(*_t(assignment, pref, speed)).numpy()
    want = np.asarray(jfr.locality_exchange(*_j(assignment, pref, speed)))
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32
    return got


def test_dep_ready_mask_segment_reduce():
    T = 8
    child, undone = pad_edges([2, 2, 3], [0, 1, 0], T)
    mask = _mask_both(child, undone, T)
    assert not mask[2]  # one unconfirmed parent blocks
    assert mask[3]  # all parents confirmed
    assert mask[0] and mask[7]  # edge-free rows (flat tasks) stay ready


def test_locality_exchange_swaps_only_equal_speed_workers():
    assignment = np.array([1, 0, -1, 2], dtype=i32)
    speed = np.array([1.0, 1.0, 2.0], dtype=f32)
    # task 0 prefers w0 (equal speed with its w1): swap with holder task 1
    pref = np.array([0, -1, -1, -1], dtype=i32)
    assert list(_exchange_both(assignment, pref, speed)) == [0, 1, -1, 2]
    # preferring a FASTER worker: no swap (would not be makespan-neutral)
    pref2 = np.array([2, -1, -1, -1], dtype=i32)
    assert list(_exchange_both(assignment, pref2, speed)) == [1, 0, -1, 2]
    # unassigned preferring task: no swap
    pref3 = np.array([-1, -1, 0, -1], dtype=i32)
    assert list(_exchange_both(assignment, pref3, speed)) == [1, 0, -1, 2]


# ---------------------------------------------------------------------------
# twins of tests/test_result_plane.py's frontier and pref-lane cases
# ---------------------------------------------------------------------------
def test_frontier_confirmed_parents_and_cleanup():
    for cls in (GraphFrontier, jfr.GraphFrontier):
        g = cls()
        g.add(_Task("child"), ["p1", "p2", "p3"])
        d = payload_digest("RES")
        g.note_parent("p1", True, row=2, digest=d, size=4500)
        g.note_parent("p2", True, row=5)  # store-resident parent: no digest
        g.note_parent("p3", False, row=1)  # failed: never delivered
        assert g.confirmed_parents("child") == [
            ("p1", d, 4500),
            ("p2", None, 0),
        ]
        assert g.failed_parent_of("child") == "p3"
        # pop drops the edges and the now-unreferenced parent states
        assert g.pop("child") is not None
        assert g.confirmed_parents("child") == []
        assert g._parent_state == {}


def test_frontier_pref_arrays_weighs_holder_bytes():
    results = []
    for cls in (GraphFrontier, jfr.GraphFrontier):
        g = cls()
        g.add(_Task("c"), ["p1", "p2"])
        d1, d2 = payload_digest("one"), payload_digest("two")
        g.note_parent("p1", True, row=0, digest=d1, size=6000)
        g.note_parent("p2", True, row=1, digest=d2, size=9000)
        rows = {3: "c"}
        # worker row 4 holds BOTH parents, row 7 only the bigger one
        triplets = g.pref_arrays(rows, 16, {d1: {4}, d2: {4, 7}})
        assert triplets is not None
        child, row, nbytes = triplets
        acc = {
            (int(c), int(r)): float(b)
            for c, r, b in zip(child, row, nbytes)
            if int(c) != 16
        }
        assert acc == {(3, 4): 15000.0, (3, 7): 9000.0}
        results.append(triplets)
        # no digest-form parents anywhere -> None (the tick keeps its
        # pref-free lanes)
        g2 = cls()
        g2.add(_Task("c"), ["p"])
        g2.note_parent("p", True, row=0)
        assert g2.pref_arrays({0: "c"}, 16, {}) is None
    for got, want in zip(*results):
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype


def test_parent_pref_scores_max_bytes_and_tie_breaks_low_row():
    T = 8
    child, row, nbytes = pad_pref(
        [2, 2, 5, 5], [3, 1, 6, 4], [100.0, 900.0, 500.0, 500.0], T
    )
    out = parent_pref_impl(*_t(child, row, nbytes), T=T).numpy()
    want = np.asarray(jfr.parent_pref(*_j(child, row, nbytes), T=T))
    np.testing.assert_array_equal(out, want)
    assert out[2] == 1  # row 1 holds 900 > row 3's 100
    assert out[5] == 4  # equal bytes: lowest row wins
    assert all(out[i] == -1 for i in (0, 1, 3, 4, 6, 7))  # lane-free rows


def test_packed_tick_pref_lane_overrides_function_locality():
    """With the pref triplets on, a ready child lands on the worker holding
    its parent's result bytes even when function locality prefers another
    equal-speed worker; the same calls in JAX's ``_packed_tick`` agree."""
    from tpu_faas.sched.state import _packed_tick

    T, W = 8, 3
    packed = np.zeros(T + 2 * W, dtype=f32)
    packed[:T] = 1.0  # sizes
    packed[T + W :] = 1.0  # one slot per worker: every worker gets a holder
    common = dict(
        worker_speed=np.ones(W, f32),
        worker_active=np.ones(W, dtype=bool),
        prev_live=np.ones(W, dtype=bool),
        inflight_worker=np.full(16, -1, i32),
    )
    task_pref = np.full(T, -1, dtype=i32)
    task_pref[0] = 1  # function locality: worker 1
    c, r, b = pad_pref([0], [2], [8192.0], T)  # result bytes: worker 2

    def port(**lanes):
        return packed_tick(
            torch.from_numpy(packed), 3, *_t(*common.values()), 60.0, None,
            T=T, W=W, max_slots=4, placement="rank",
            **{k: torch.from_numpy(v) for k, v in lanes.items()},
        ).assignment.numpy()

    def jax_(**lanes):
        return np.asarray(_packed_tick(
            jnp.asarray(packed), jnp.int32(3), *_j(*common.values()),
            jnp.float32(60.0), None, None, T=T, W=W, max_slots=4,
            placement="rank", **{k: jnp.asarray(v) for k, v in lanes.items()},
        ).assignment)

    base = port(task_pref=task_pref)
    pref = port(task_pref=task_pref, pref_child=c, pref_row=r, pref_bytes=b)
    np.testing.assert_array_equal(base, jax_(task_pref=task_pref))
    np.testing.assert_array_equal(
        pref,
        jax_(task_pref=task_pref, pref_child=c, pref_row=r, pref_bytes=b),
    )
    # three equal tasks on three equal single-slot workers: the exchange
    # can always swap task 0 onto its preferred row
    assert int(base[0]) == 1
    assert int(pref[0]) == 2


# ---------------------------------------------------------------------------
# random parity of the three device ops
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", range(6))
def test_dep_ready_mask_matches_jax_random(seed):
    """Repeated children, pad lanes at T, negative children (one wrap, and
    one past the wrap, which drops) and children past T."""
    rng = np.random.default_rng(seed)
    T = 16
    E = int(rng.integers(1, 48))
    child = rng.integers(-T - 3, T + 3, E).astype(i32)
    child[: E // 3] = rng.integers(0, 4, E // 3)  # repeats on a few rows
    undone = rng.integers(0, 3, E).astype(i32)
    c, u = pad_edges(child.tolist(), undone.tolist(), T)
    mask = _mask_both(c, u, T)
    assert len(c) & (len(c) - 1) == 0 and (c[E:] == T).all()
    assert mask.dtype == bool


@pytest.mark.parametrize("seed", range(8))
def test_parent_pref_matches_jax_random(seed):
    """Repeated (child, row) lanes, equal byte ties, zero, -0.0, negative
    and NaN bytes, pad lanes and a negative child: the scatter-max, the
    win mask and the masked scatter-min over repeated indices."""
    rng = np.random.default_rng(seed)
    T = 12
    P = int(rng.integers(1, 40))
    child = rng.integers(0, 5, P).astype(i32)
    child[0] = -1 if seed % 2 else -T - 1
    row = rng.integers(0, 9, P).astype(i32)
    odd = [np.nan, -3.0] if seed % 2 else [512.0, 512.0]
    nbytes = rng.choice(np.array([0.0, -0.0, 512.0, 512.0, 4096.0, 9000.5,
                                  *odd], f32), P)
    c, r, b = pad_pref(child.tolist(), row.tolist(), nbytes.tolist(), T)
    got = parent_pref_impl(*_t(c, r, b), T=T).numpy()
    want = np.asarray(jfr.parent_pref(*_j(c, r, b), T=T))
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32


@pytest.mark.parametrize("seed", range(10))
def test_locality_exchange_matches_jax_random(seed):
    """Equal speeds, -0.0 against 0.0, speeds one ulp apart (within the
    1e-6 tolerance), a NaN speed, unassigned and preference-free tasks,
    several tasks wanting one worker, and preferences past the last worker
    (clipped)."""
    rng = np.random.default_rng(seed)
    T, W = 24, 7
    classes = np.array([0.0, -0.0, 1.0, 1.0, np.nextafter(f32(1), f32(2)),
                        2.0, np.nan if seed % 3 == 0 else 2.0], f32)
    speed = rng.permutation(classes).astype(f32)
    assignment = rng.integers(-1, W, T).astype(i32)
    pref = rng.integers(-1, W + 1, T).astype(i32)
    pref[rng.random(T) < 0.4] = -1
    out = _exchange_both(assignment, pref, speed)
    # the exchange only permutes assignments: the per-worker counts hold
    np.testing.assert_array_equal(np.sort(out), np.sort(assignment))


def test_locality_exchange_swaps_in_random_states():
    """Across the random states the exchange does fire, and every changed
    task moved between two equal-speed workers."""
    fired = 0
    for seed in range(10):
        rng = np.random.default_rng(seed)
        T, W = 24, 7
        speed = rng.permutation(np.array([0.0, -0.0, 1.0, 1.0, 1.0, 2.0, 2.0],
                                         f32))
        assignment = rng.integers(-1, W, T).astype(i32)
        pref = rng.integers(-1, W, T).astype(i32)
        out = _exchange_both(assignment, pref, speed)
        moved = np.flatnonzero(out != assignment)
        fired += len(moved)
        for t in moved:
            assert speed[out[t]] == speed[assignment[t]]
    assert fired > 0


# ---------------------------------------------------------------------------
# the batch tick with all three graph lanes
# ---------------------------------------------------------------------------
def _table(cls):
    t = cls(shares={"light": 8.0, "heavy": 1.0}, caps={"heavy": 5},
            max_tenants=4)
    t.row_for("third")
    return t


def _drive_graph(a, frontier_cls, seed, tenancy, spec):
    """Batch ticks fed by a graph frontier: each tick holds diamonds (a
    root, three middles, a sink) beside flat tasks; some parents are
    confirmed, with the worker row that ran them and a result digest that
    one or two rows hold. Worker speeds fall into equal-speed classes, so
    the locality exchange fires."""
    rng = np.random.default_rng(seed)
    clock = [100.0]
    a.clock = lambda: clock[0]
    if spec:
        a.spec_mult, a.spec_min_s = 3.0, 0.02
    if tenancy:
        a.tenancy = _table(TenantTable if isinstance(a, TArrays) else JTable)
    speeds = [1.0, 1.0, 1.0, 2.0, 2.0, 0.5, 0.5, 2.0]
    for i, s in enumerate(speeds):
        a.register(b"w%d" % i, int(rng.integers(1, 4)), speed=s)
    g = frontier_cls()
    outs, hedges, n_task = [], [], 0
    T = a.max_pending
    for k in range(4):
        clock[0] += 0.25
        for i in range(8):
            if i != 3 or k < 2:  # w3 goes silent but stays live
                a.heartbeat(b"w%d" % i)
        ids, sizes, avoid = [], [], []
        for tid, row in hedges:
            ids.append(tid)
            sizes.append(1.0)
            avoid.append(row)
        hedges = []
        for f in range(int(rng.integers(2, 6))):
            ids.append(f"f{k}_{f}")
        holder_rows: dict[str, set[int]] = {}
        for d in range(4):
            root, sink = f"r{k}_{d}", f"s{k}_{d}"
            mids = [f"m{k}_{d}_{j}" for j in range(3)]
            g.add(_Task(root), [])
            for m in mids:
                g.add(_Task(m), [root])
            g.add(_Task(sink), mids)
            ids += [root, *mids, sink]
            for p in [root, *mids]:
                if rng.random() < 0.55:
                    row = int(rng.integers(0, 8))
                    digest = payload_digest(p) if rng.random() < 0.7 else None
                    g.note_parent(p, rng.random() < 0.9, row=row,
                                  digest=digest, size=int(rng.integers(0, 9000)))
                    if digest is not None:
                        holder_rows[digest] = {row, int(rng.integers(0, 8))}
        n = len(ids)
        sizes = np.asarray(
            sizes + list((rng.integers(1, 33, n - len(sizes)) / 8)), f32)
        avoid = np.asarray(avoid + [-1] * (n - len(avoid)), i32)
        rows = {r: tid for r, tid in enumerate(ids) if tid in g.waiting}
        child, undone, pref = g.edge_arrays(rows, T)
        kw = dict(dep_edges=(child, undone), task_pref=pref,
                  pref_edges=g.pref_arrays(rows, T, holder_rows))
        if spec:
            kw["task_avoid"] = avoid
        if tenancy:
            kw["task_tenants"] = rng.integers(0, 3, n).astype(i32)
        out = a.tick(sizes, **kw)
        assign = np.asarray(out.assignment)[:n]
        flags = None if out.straggler is None else np.asarray(out.straggler)
        outs.append((assign, np.asarray(out.live), flags, pref is not None,
                     kw["pref_edges"] is not None))
        for t in np.flatnonzero(assign >= 0):
            row = int(assign[t])
            a.worker_free[row] -= 1
            a.inflight_add(f"t{n_task}", row, pred=0.1 if row == 3 else 0.5)
            n_task += 1
        if flags is not None:
            for slot in np.flatnonzero(flags):
                hedges.append((a.inflight_task[slot],
                               int(a.inflight_worker[slot])))
        for slot in np.flatnonzero(a.inflight_worker >= 0):
            if a.inflight_worker[slot] != 3 and rng.random() < 0.5:
                a.release_slot(a.inflight_done(a.inflight_task[slot]))
        for tid in list(g.waiting):
            g.pop(tid)
    return outs


@pytest.mark.parametrize("spec", [False, True], ids=["nospec", "spec"])
@pytest.mark.parametrize("tenancy", [False, True], ids=["flat", "tenancy"])
@pytest.mark.parametrize("placement", ["rank", "auction", "sinkhorn"])
def test_scheduler_arrays_tick_with_graph_lanes_matches_jax(placement,
                                                           tenancy, spec):
    kw = dict(max_workers=16, max_pending=64, max_inflight=128, max_slots=4,
              placement=placement)
    want = _drive_graph(JArrays(**kw), jfr.GraphFrontier, 11, tenancy, spec)
    got = _drive_graph(TArrays(**kw, device="cpu"), GraphFrontier, 11,
                       tenancy, spec)
    for k, (w, g) in enumerate(zip(want, got)):
        for name, wv, gv in zip(("assignment", "live", "straggler"), w, g):
            if wv is None:
                assert gv is None
                continue
            np.testing.assert_array_equal(gv, wv, err_msg=f"tick {k} {name}")
        assert w[3:] == g[3:]
    assert any(g[3] for g in got) and any(g[4] for g in got)
    assert any((g[0] >= 0).any() for g in got)
    assert any((g[0] < 0).any() for g in got)


def test_exchange_can_move_a_hedge_onto_its_avoid_row_like_jax():
    """A behaviour of the reference, reproduced: the locality exchange
    runs after the hedge fixup and knows nothing of avoid rows, so a
    hedge holding an equal-speed worker swaps onto its avoid row when the
    task there prefers the hedge's row."""
    outs = []
    for cls, extra in ((JArrays, {}), (TArrays, dict(device="cpu"))):
        a = cls(max_workers=4, max_pending=8, max_inflight=8, **extra)
        a.register(b"w0", 1, speed=1.0)
        a.register(b"w1", 1, speed=1.0)
        pref = np.full(8, -1, i32)
        pref[0] = 1  # task 0 prefers the hedge's row
        out = a.tick(np.asarray([2.0, 1.0], f32),
                     task_avoid=np.asarray([-1, 0], i32), task_pref=pref)
        outs.append(np.asarray(out.assignment)[:2].tolist())
    assert outs[0] == outs[1] == [1, 0]  # the hedge (task 1) sits on row 0

