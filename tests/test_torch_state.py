"""The batch tick in the PyTorch port against the JAX reference.

``scheduler_tick_impl`` and ``SchedulerArrays.tick`` get the same seeded
numpy inputs in both packages (on the CPU); every output is an integer or
bool vector and must be exactly equal. Unported features raise
``NotImplementedError``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_faas.sched.state import SchedulerArrays as JArrays
from tpu_faas.sched.state import scheduler_tick_impl as j_tick
from tpu_faas_torch.sched.resident import ResidentScheduler
from tpu_faas_torch.sched.state import SchedulerArrays as TArrays
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


@pytest.mark.parametrize("kw", [dict(mesh_devices=2),
                                dict(multihost=object())])
def test_multi_device_layouts_raise(kw):
    with pytest.raises(NotImplementedError, match="ROADMAP A.11"):
        TArrays(device="cpu", **kw)


@pytest.mark.parametrize("arg", [
    dict(dep_edges=(np.zeros(1, i32), np.zeros(1, i32))),
    dict(task_pref=np.zeros(4, i32)),
    dict(pref_edges=(np.zeros(1, i32), np.zeros(1, i32), np.zeros(1, f32))),
    dict(task_avoid=np.zeros(2, i32)),
])
def test_unported_tick_lanes_raise(arg):
    """The graph lanes raise; the speculation lane runs (the tenancy and
    speculation lanes are ported: tests/test_torch_tenancy.py,
    tests/test_torch_spec.py). Both tasks avoid row 0, the only worker,
    so the fixup leaves them queued."""
    a = TArrays(max_workers=4, max_pending=8, max_inflight=8, device="cpu")
    a.register(b"w0", 2)
    if "task_avoid" in arg:
        out = a.tick(np.ones(2, f32), **arg)
        assert (out.assignment.numpy() == -1).all()
        return
    with pytest.raises(NotImplementedError, match="ROADMAP A.7"):
        a.tick(np.ones(2, f32), **arg)
