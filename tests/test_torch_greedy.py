"""Rank placement in the PyTorch port against the JAX reference.

The same seeded numpy inputs go through ``tpu_faas.sched.greedy`` and
``tpu_faas_torch.sched.greedy`` on the CPU; the assignment must be EXACTLY
equal (an integer output, and both sort with stable argsorts on the same
keys). The host helpers are copies and must agree exactly too.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_faas.sched import greedy as jg
from tpu_faas_torch.sched import greedy as tg

f32, i32 = np.float32, np.int32


def _case(seed, T, W, K, ties=False, zeros=False, dead=False, prio=False,
          adm_rank=False):
    rng = np.random.default_rng(seed)
    sizes = rng.uniform(0.1, 10.0, T).astype(f32)
    speed = rng.uniform(0.5, 4.0, W).astype(f32)
    if ties:
        sizes = np.round(sizes / 2).astype(f32)
        speed = np.round(speed).astype(f32)
    if zeros:
        sizes[rng.random(T) < 0.3] = 0.0
        sizes[rng.random(T) < 0.1] = -0.0
        speed[rng.random(W) < 0.2] = 0.0
    valid = rng.random(T) < 0.8
    free = rng.integers(-1, K + 3, W).astype(i32)
    live = np.zeros(W, bool) if dead else rng.random(W) < 0.8
    extra = {}
    if prio:
        extra["task_priority"] = rng.integers(-2, 3, T).astype(i32)
    if adm_rank:
        rank = np.arange(T, 2 * T, dtype=i32)  # invalid rows: never admitted
        idx = np.flatnonzero(valid)
        rank[rng.permutation(idx)] = np.arange(len(idx), dtype=i32)
        extra["task_adm_rank"] = rank
    return (sizes, valid, speed, free, live), extra


CASES = {
    "basic": dict(T=64, W=8, K=4),
    "T>S": dict(T=64, W=4, K=4),
    "T<S": dict(T=16, W=32, K=4),
    "ties": dict(T=64, W=16, K=4, ties=True),
    "zero_sizes": dict(T=48, W=16, K=2, zeros=True, ties=True),
    "priority": dict(T=64, W=8, K=4, prio=True, ties=True),
    "all_dead": dict(T=32, W=8, K=4, dead=True),
    "adm_rank": dict(T=64, W=8, K=4, adm_rank=True),
}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("name", list(CASES))
def test_rank_placement_matches_jax(name, seed):
    kw = dict(CASES[name])
    T, W, K = kw.pop("T"), kw.pop("W"), kw.pop("K")
    arrays, extra = _case(seed, T, W, K, **kw)
    want = np.asarray(jg.rank_match_placement_impl(
        *map(jnp.asarray, arrays), max_slots=K,
        **{k: jnp.asarray(v) for k, v in extra.items()},
    ))
    got = tg.rank_match_placement_impl(
        *map(torch.from_numpy, arrays), max_slots=K,
        **{k: torch.from_numpy(v) for k, v in extra.items()},
    )
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    if name == "all_dead":
        assert (want == -1).all()


def test_negative_zero_ties_break_by_index():
    """The parity hazard the port pins: -0.0 and 0.0 sort equal and keep
    index order in both frameworks."""
    sizes = np.array([0.0, -0.0, 0.0, 5.0], f32)
    arrays = (sizes, np.ones(4, bool), np.ones(2, f32), np.full(2, 1, i32),
              np.ones(2, bool))
    want = np.asarray(jg.rank_match_placement_impl(
        *map(jnp.asarray, arrays), max_slots=1))
    got = tg.rank_match_placement_impl(*map(torch.from_numpy, arrays),
                                       max_slots=1)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", [0, 1])
def test_host_helpers_are_exact_copies(seed):
    rng = np.random.default_rng(seed)
    T, W = 200, 24
    sizes = rng.uniform(0.1, 10.0, T).astype(f32)
    speed = rng.uniform(0.5, 4.0, W).astype(f32)
    free = rng.integers(0, 8, W).astype(i32)
    live = rng.random(W) < 0.9
    for fn in ("host_greedy_reference", "host_greedy_vectorized"):
        a = getattr(tg, fn)(sizes, speed, free, live)
        np.testing.assert_array_equal(
            a, getattr(jg, fn)(sizes, speed, free, live), err_msg=fn
        )
    ref = tg.host_greedy_reference(sizes, speed, free, live)
    np.testing.assert_array_equal(
        tg.host_greedy_vectorized(sizes, speed, free, live), ref
    )
    assert tg.makespan(ref, sizes, speed) == jg.makespan(ref, sizes, speed)
