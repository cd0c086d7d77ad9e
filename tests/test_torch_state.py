"""The batch tick in the PyTorch port against the JAX reference.

``scheduler_tick_impl`` and ``SchedulerArrays.tick`` get the same seeded
numpy inputs in both packages (on the CPU); every output is an integer or
bool vector and must be exactly equal. The mesh and multihost layouts are
held against JAX in tests/test_torch_parallel_mesh.py and
tests/test_torch_multihost.py; here, that they build and tick.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_faas.sched.state import SchedulerArrays as JArrays
from tpu_faas.sched.state import scheduler_tick_impl as j_tick
from tpu_faas_torch.sched.resident import ResidentScheduler
from tpu_faas_torch.sched.state import SchedulerArrays as TArrays
from tpu_faas_torch.sched.state import TickOutput
from tpu_faas_torch.sched.state import scheduler_tick_impl as t_tick

f32, i32 = np.float32, np.int32


def _tick_inputs(seed, T=64, W=16, I=128, K=4):
    rng = np.random.default_rng(seed)
    return dict(
        task_size=np.round(rng.uniform(0.0, 6.0, T)).astype(f32),
        task_valid=rng.random(T) < 0.8,
        worker_speed=np.round(rng.uniform(0.5, 4.0, W) * 2).astype(f32) / 2,
        worker_free=rng.integers(-1, K + 2, W).astype(i32),
        worker_active=rng.random(W) < 0.9,
        # ages straddle time_to_expire (10 s), including exactly 10.0
        heartbeat_age=np.where(rng.random(W) < 0.1, 10.0,
                               rng.uniform(0.0, 14.0, W)).astype(f32),
        prev_live=rng.random(W) < 0.8,
        inflight_worker=np.where(rng.random(I) < 0.4, -1,
                                 rng.integers(0, W, I)).astype(i32),
    ), rng


@pytest.mark.parametrize("lane", ["none", "priority", "health", "place_cap"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scheduler_tick_matches_jax(seed, lane):
    inputs, rng = _tick_inputs(seed)
    T, W = len(inputs["task_size"]), len(inputs["worker_speed"])
    extra = {}
    if lane == "priority":
        extra["task_priority"] = rng.integers(-3, 4, T).astype(i32)
    elif lane == "health":
        extra["worker_health"] = rng.choice(
            np.array([0.25, 0.5, 1.0], f32), W)
    elif lane == "place_cap":
        extra["worker_place_cap"] = rng.integers(0, 3, W).astype(i32)
    want = j_tick(
        **{k: jnp.asarray(v) for k, v in {**inputs, **extra}.items()},
        time_to_expire=jnp.float32(10.0), max_slots=4,
    )
    got = t_tick(
        **{k: torch.from_numpy(v) for k, v in {**inputs, **extra}.items()},
        time_to_expire=10.0, max_slots=4,
    )
    for field in ("assignment", "live", "purged", "redispatch"):
        np.testing.assert_array_equal(
            getattr(got, field).numpy(), np.asarray(getattr(want, field)),
            err_msg=field,
        )


def _drive_arrays(a, seed):
    """Registrations, in-flight churn (small and full in-flight uploads),
    a silent worker, priorities and quarantine caps over several ticks;
    returns each tick's outputs as numpy."""
    rng = np.random.default_rng(seed)
    clock = [100.0]
    a.clock = lambda: clock[0]
    for i in range(10):
        a.register(b"w%d" % i, int(rng.integers(1, 5)),
                   speed=float(rng.uniform(0.5, 4.0)))
    outs = []
    for k in range(6):
        clock[0] += 1.0 if k != 3 else 11.0
        for i in range(10):
            if i != 2:  # w2 goes silent and is purged on tick 3
                a.heartbeat(b"w%d" % i)
        for j in range(int(rng.integers(0, 5 if k != 4 else 80))):
            a.inflight_add(f"t{k}-{j}", int(rng.integers(0, 10)))
        n = int(rng.integers(5, 40))
        sizes = np.round(rng.uniform(0.0, 6.0, n)).astype(f32)
        kw = {}
        if k % 2:
            kw["task_priorities"] = rng.integers(0, 3, n).astype(i32)
        if k == 5:
            kw["worker_place_cap"] = rng.integers(0, 3, a.max_workers)
        out = a.tick(sizes, **kw)
        outs.append({f: np.asarray(getattr(out, f)) for f in
                     ("assignment", "live", "purged", "redispatch")})
        for row in np.flatnonzero(outs[-1]["purged"]):
            a.deactivate(int(row))
        for slot in np.flatnonzero(outs[-1]["redispatch"])[:3]:
            a.inflight_clear_slot(int(slot))
    return outs


def test_scheduler_arrays_tick_matches_jax():
    kw = dict(max_workers=16, max_pending=64, max_inflight=128, max_slots=4)
    want = _drive_arrays(JArrays(**kw), seed=3)
    got = _drive_arrays(TArrays(**kw, device="cpu"), seed=3)
    assert any(o["purged"].any() for o in want)
    assert any(o["redispatch"].any() for o in want)
    for k, (w, g) in enumerate(zip(want, got)):
        for field in w:
            np.testing.assert_array_equal(g[field], w[field],
                                          err_msg=f"tick {k} {field}")


@pytest.mark.parametrize("lane", ["none", "priority", "place_cap"])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_scripted_rank_tick_is_the_eager_tick(seed, lane):
    """ROADMAP C.12: ``packed_tick``'s rank tick with no plane or graph
    lane is one scripted call (``state._rank_tick``); it equals
    ``scheduler_tick_impl`` run eagerly on the unpacked inputs, every
    output, with a float and a tensor ``time_to_expire``."""
    from tpu_faas_torch.sched.state import packed_tick

    inputs, rng = _tick_inputs(seed)
    T, W = len(inputs["task_size"]), len(inputs["worker_speed"])
    n = int(rng.integers(1, T))
    t = {k: torch.from_numpy(v) for k, v in inputs.items()}
    packed = torch.cat([t["task_size"] * (torch.arange(T) < n),
                        t["heartbeat_age"], t["worker_free"].float()])
    prio = (torch.from_numpy(rng.integers(-3, 4, T).astype(i32))
            if lane == "priority" else None)
    cap = (torch.from_numpy(rng.integers(0, 3, W).astype(i32))
           if lane == "place_cap" else None)
    want = t_tick(packed[:T], torch.arange(T) < n, t["worker_speed"],
                  t["worker_free"], t["worker_active"], t["heartbeat_age"],
                  t["prev_live"], t["inflight_worker"], 10.0, max_slots=4,
                  task_priority=prio, worker_place_cap=cap)
    for tte in (10.0, torch.tensor(10.0)):
        got = packed_tick(packed, n, t["worker_speed"], t["worker_active"],
                          t["prev_live"], t["inflight_worker"], tte, prio,
                          None, cap, T=T, W=W, max_slots=4)
        for field in ("assignment", "live", "purged", "redispatch"):
            a, b = getattr(got, field), getattr(want, field)
            assert a.dtype == b.dtype and torch.equal(a, b), field


def test_rank_tick_makes_few_torch_calls_from_python():
    """ROADMAP C.12: the express dispatcher's tick (rank, no lane) held
    the interpreter lock for each of its 57 torch calls, and under threads
    contending in its process each call waited for the lock: its sub-tick
    took hundreds of milliseconds where JAX's one compiled call took tens.
    Now ``SchedulerArrays.tick`` makes the packed upload and one scripted
    call, counted by a ``TorchFunctionMode`` (which sees no op inside a
    scripted call)."""
    from tpu_faas_torch.sched.scripted import CallCount

    a = TArrays(max_workers=16, max_pending=128, max_slots=2, device="cpu")
    a.register(b"w0", 2)
    sizes = np.ones(3, f32)
    a.tick(sizes)
    with CallCount() as calls:
        out = a.tick(sizes)
    assert calls.n <= 5, calls.n
    assert int((out.assignment >= 0).sum()) == 2


@pytest.mark.parametrize("placement,exc", [
    pytest.param("auction", None, id="auction-NotImplementedError"),
    pytest.param("sinkhorn", None, id="sinkhorn-NotImplementedError"),
    ("bogus", ValueError),
])
def test_unported_placements_raise(placement, exc):
    """Every placement is ported, the resident tick's speculation lane
    included: a resident auction or Sinkhorn scheduler with ``spec_mult``
    builds and ticks (tests/test_torch_fused_spec.py holds it against
    JAX); an unknown placement raises."""
    if exc is not None:
        with pytest.raises(exc, match="unknown"):
            TArrays(placement=placement, device="cpu")
        return
    r = ResidentScheduler(placement=placement, device="cpu", spec_mult=2.0,
                          max_workers=4, max_pending=8, max_inflight=8)
    r.register(b"w0", 2)
    r.pending_add("t0", 1.0)
    r.tick_resident()
    res = r.resolve_next()
    assert res.placed == [("t0", 0)] and res.straggler_slots == []


class _LeadStub:
    """A MultihostTick's lead side: records the tick it is handed."""

    def __init__(self):
        self.calls = []

    def lead_tick(self, sizes, speed, free, active, hb_age, inflight, tte,
                  task_priorities=None):
        self.calls.append((sizes, hb_age, task_priorities))
        live = active & (hb_age <= tte)
        return TickOutput(np.full(len(sizes), -1, np.int32), live,
                                 np.zeros_like(live), None)


@pytest.mark.parametrize("kw", [dict(mesh_devices=2),
                                dict(multihost=_LeadStub())])
def test_multi_device_layouts_raise(kw):
    """The name dates from when the port refused these layouts. A mesh
    pads the task axis and ticks over its positions like the single-device
    tick; a multihost tick hands the host inputs to the lead and keeps its
    live vector."""
    a = TArrays(device="cpu", max_pending=7, clock=lambda: 100.0, **kw)
    one = TArrays(device="cpu", max_pending=8, clock=lambda: 100.0)
    for arr in (a, one):
        arr.register(b"w0", 2, speed=2.0)
        arr.register(b"w1", 1, speed=1.0)
    sizes = np.array([3.0, 1.0, 2.0], np.float32)
    out = a.tick(sizes, task_priorities=np.array([0, 1, 0], np.int32))
    if "mesh_devices" in kw:
        assert a.max_pending == 8 and a.mesh.size == 2
        want = one.tick(sizes, task_priorities=np.array([0, 1, 0], np.int32))
        np.testing.assert_array_equal(out.assignment.numpy(),
                                      want.assignment.numpy())
    else:
        (got_sizes, hb_age, prio), = kw["multihost"].calls
        np.testing.assert_array_equal(got_sizes, sizes)
        assert list(prio) == [0, 1, 0] and hb_age[0] == 0.0
        assert list(a.prev_live[:2]) == [True, True]


@pytest.mark.parametrize("arg,want", [
    (dict(dep_edges=(np.zeros(1, i32), np.ones(1, i32))), [-1, 0]),
    (dict(task_pref=np.zeros(8, i32)), [0, 0]),
    (dict(pref_edges=(np.zeros(1, i32), np.zeros(1, i32), np.zeros(1, f32))),
     [0, 0]),
    (dict(task_avoid=np.zeros(2, i32)), [-1, -1]),
])
def test_unported_tick_lanes_raise(arg, want):
    """Every tick lane is ported and runs (the graph lanes, the tenancy
    and the speculation lanes: tests/test_torch_graph.py,
    tests/test_torch_tenancy.py, tests/test_torch_spec.py). An unconfirmed
    parent holds task 0 back; a preference for the only worker, or a
    zero-byte pref lane, changes nothing; both tasks avoid row 0, the only
    worker, so the fixup leaves them queued."""
    a = TArrays(max_workers=4, max_pending=8, max_inflight=8, device="cpu")
    a.register(b"w0", 2)
    out = a.tick(np.ones(2, f32), **arg)
    assert out.assignment.numpy()[:2].tolist() == want
