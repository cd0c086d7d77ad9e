"""The CUDA rank branch's decomposition, as plain models, against JAX.

Kernel B1's rank branch no longer sorts every slot and task: it compacts the
valid slots and the admitted tasks in index order and sorts only those, cuts
the priority admission with a radix select instead of a sort of all T, and
computes the tenancy lane's within-tenant rank over tiles. The plain models
of that decomposition (``tpu_faas_torch.sched.greedy.rank_match_compacted``
with ``radix_select`` and ``admit_select``, and
``tpu_faas_torch.tenancy.fairshare.tenant_admission_tiled``) must give
EXACTLY what JAX's ``rank_match_placement_impl`` and
``tenant_fair_admission_impl`` give on the same seeded numpy inputs: the
select's threshold, the admitted set, the placement, and the eligibility
and demand. A -inf or NaN speed on a valid slot or size on an admitted task
must send the model down the full-length path (it would sort among the
invalid ones). The main path runs none of these models: the card runs the
kernel, the CPU the plain version.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_faas.sched import greedy as jg
from tpu_faas.tenancy import fairshare as jfair
from tpu_faas_torch.sched import greedy as tg
from tpu_faas_torch.tenancy import fairshare as tfair

f32, i32 = np.float32, np.int32
I32_MIN, I32_MAX = np.iinfo(i32).min, np.iinfo(i32).max


# -- the select itself --------------------------------------------------------
def _keys(rng, n, kind):
    if kind == "ties":  # a few distinct keys, thousands of ties each
        k = rng.choice(np.array([5, 2**32 + 7, 2**63, 2**64 - 2], np.uint64), n)
    elif kind == "wide":  # every byte differs somewhere
        k = rng.integers(0, 2**63, n, dtype=np.uint64) * np.uint64(2) + \
            rng.integers(0, 2, n, dtype=np.uint64)
    else:  # one key for every member (FCFS)
        k = np.zeros(n, np.uint64)
    k[rng.random(n) < 0.2] = np.uint64(tg.NO_KEY)
    return k


@pytest.mark.parametrize("kind", ["ties", "wide", "one"])
@pytest.mark.parametrize("seed", [0, 1])
def test_select_is_the_stable_order(kind, seed):
    """The threshold is the key at position k - 1 of the members' stable
    order, and the members below it plus ``need`` equal ones are k."""
    rng = np.random.default_rng(seed)
    keys = _keys(rng, 5000, kind)
    members = np.sort(keys[keys != np.uint64(tg.NO_KEY)], kind="stable")
    M = members.size
    for k in (0, 1, 2, 17, M // 2, M - 1, M, M + 9):
        thr, need, passes = tg.radix_select(keys, k)
        assert passes <= 8
        if k == 0:
            assert need == 0
        elif k >= M:
            assert thr == tg.NO_KEY and need == 0
        else:
            assert thr == int(members[k - 1])
            below = int((members < np.uint64(thr)).sum())
            assert below + need == k
            assert 1 <= need <= int((members == np.uint64(thr)).sum())
            if kind == "one":
                assert passes == 0


# -- rank placement: the compacted model against JAX --------------------------
def _rank_case(seed, T, W, K, kind):
    rng = np.random.default_rng(seed)
    sizes = rng.uniform(0.1, 10.0, T).astype(f32)
    tie = rng.random(T) < 0.3
    sizes[tie] = np.round(sizes[tie] * 2) / 2
    speed = (np.round(rng.uniform(0.5, 4.0, W) * 2) / 2).astype(f32)
    valid = rng.random(T) < 0.7
    free = rng.integers(-1, K + 3, W).astype(i32)
    live = rng.random(W) < 0.85
    prio = rng.integers(-2, 3, T).astype(i32)
    expect_full = False
    if kind == "tie_straddle":  # thousands of one priority over the cut
        prio = np.where(rng.random(T) < 0.05, 1, 0).astype(i32)
    elif kind == "int32_extremes":
        prio = rng.choice(np.array([I32_MIN, I32_MIN + 1, -1, 0, 1,
                                    I32_MAX - 1, I32_MAX], i32), T)
    elif kind == "signed_zeros":
        sizes[rng.random(T) < 0.4] = 0.0
        sizes[rng.random(T) < 0.3] = -0.0
        speed[rng.random(W) < 0.3] = 0.0
        speed[rng.random(W) < 0.3] = -0.0
    elif kind in ("neg_inf_size", "nan_size"):
        bad = np.float32(-np.inf if kind == "neg_inf_size" else np.nan)
        first = np.flatnonzero(valid)[:3]  # admitted under FCFS
        sizes[first] = bad
        expect_full = True
    elif kind in ("neg_inf_speed", "nan_speed"):
        live[:] = True
        free[0] = K  # a valid slot on row 0
        speed[0] = np.float32(-np.inf if kind == "neg_inf_speed" else np.nan)
        expect_full = True
    elif kind == "no_slots":
        free[:] = 0
    elif kind == "every_slot":
        free[:] = K + 1
        live[:] = True
    elif kind == "slots_past_valid":
        valid = rng.random(T) < 0.05
        free[:] = K
        live[:] = True
    return (sizes, valid, speed, free, live), prio, expect_full


RANK_KINDS = ["basic", "tie_straddle", "int32_extremes", "signed_zeros",
              "neg_inf_size", "nan_size", "neg_inf_speed", "nan_speed",
              "no_slots", "every_slot", "slots_past_valid"]


@pytest.mark.parametrize("tile", [1, 7, 1024, "T"])
@pytest.mark.parametrize("use_priority", [False, True])
@pytest.mark.parametrize("kind", RANK_KINDS)
def test_rank_compacted_matches_jax(kind, use_priority, tile):
    T, W, K = 600, 40, 4
    arrays, prio, expect_full = _rank_case(3, T, W, K, kind)
    extra = {"task_priority": prio} if use_priority else {}
    want = np.asarray(jg.rank_match_placement_impl(
        *map(jnp.asarray, arrays), max_slots=K,
        **{k: jnp.asarray(v) for k, v in extra.items()},
    ))
    got, full, passes = tg.rank_match_compacted(
        *map(torch.from_numpy, arrays), max_slots=K,
        **{k: torch.from_numpy(v) for k, v in extra.items()},
        tile=T if tile == "T" else tile,
    )
    np.testing.assert_array_equal(got.numpy(), want)
    assert full == expect_full
    if kind == "no_slots":
        assert (want == -1).all()
    if kind == "tie_straddle" and use_priority:
        assert passes >= 1


def test_priority_hole_where_an_invalid_task_takes_a_rank():
    """At the INT32_MAX key an invalid task holds a priority rank below
    n_slots, as in greedy.py's sort: the list keeps its place as a hole,
    and a valid task of that key past the cut stays queued."""
    T, W, K = 8, 1, 8
    sizes = np.arange(1, T + 1, dtype=f32)
    valid = np.array([0, 1, 0, 1, 1, 1, 1, 1], bool)
    prio = np.full(T, I32_MIN + 1, i32)  # -prio = INT32_MAX, the invalid key
    prio[4:] = 0
    arrays = (sizes, valid, np.ones(W, f32), np.full(W, 6, i32),
              np.ones(W, bool))
    want = np.asarray(jg.rank_match_placement_impl(
        *map(jnp.asarray, arrays), max_slots=K,
        task_priority=jnp.asarray(prio)))
    got, full, _ = tg.rank_match_compacted(
        *map(torch.from_numpy, arrays), max_slots=K,
        task_priority=torch.from_numpy(prio), tile=3)
    np.testing.assert_array_equal(got.numpy(), want)
    assert not full
    assert list(want) == [-1, 0, -1, -1, 0, 0, 0, 0]
    keys = tg.int_key(np.where(valid, -prio, I32_MAX).astype(i32)).astype(
        np.uint64) << np.uint64(32)
    _, lst, _ = tg.admit_select(keys, valid, 6, 3)
    assert list(lst) == [-1, 1, 4, 5, 6, 7]


# -- the tenancy lane: tiled j and the admission select ----------------------
def _tenancy_case(seed, N, T):
    rng = np.random.default_rng(seed)
    tenant = rng.integers(-2, N + 2, T).astype(i32)
    if N > 32:  # crowd a few rows too, so runs cross the tiles
        tenant[rng.random(T) < 0.5] = rng.integers(0, 4)
    valid = rng.random(T) < 0.75
    prio = rng.choice(np.array([I32_MIN, -1, 0, 0, 0, 2, I32_MAX], i32), T)
    share = rng.choice(np.array([0.5, 1.0, 2.0, 3.0, 1e-9], f32), N)
    deficit = rng.choice(np.array([0.0, 1.0, 2.0, 1023.5, 1024.0, 4096.0],
                                  f32), N)
    ahead = rng.integers(0, 6, N).astype(i32)
    cap = rng.choice(np.array([0, 0, 2, 5, 9], i32), N)
    return valid, tenant, prio, share, deficit, ahead, cap


@pytest.mark.parametrize("tile", [1, 7, 1024, "T"])
@pytest.mark.parametrize("N", [1, 32, 1100])
def test_tenancy_tiled_matches_jax(N, tile):
    T, W, K = 700, 30, 4
    valid, tenant, prio, share, deficit, ahead, cap = _tenancy_case(N, N, T)
    j_elig, j_rank, j_demand = (np.asarray(x) for x in
                                jfair.tenant_fair_admission_impl(
        jnp.asarray(valid), jnp.asarray(tenant), jnp.asarray(prio),
        jnp.asarray(share), jnp.asarray(deficit), jnp.asarray(ahead),
        jnp.asarray(cap)))
    elig, keys, demand = tfair.tenant_admission_tiled(
        valid, tenant, prio, share, deficit, ahead, cap,
        tile=T if tile == "T" else tile)
    np.testing.assert_array_equal(elig, j_elig)
    np.testing.assert_array_equal(demand, j_demand)
    n_elig = int(elig.sum())
    for n_slots in (0, 1, n_elig // 3, n_elig - 1, n_elig, n_elig + 5):
        admitted, _, _ = tg.admit_select(keys, elig, n_slots,
                                         T if tile == "T" else tile)
        np.testing.assert_array_equal(admitted, j_elig & (j_rank < n_slots))
    # the whole placement, on a fleet with fewer slots than eligible tasks
    rng = np.random.default_rng(N)
    fleet = (rng.uniform(0.5, 4.0, W).astype(f32),
             rng.integers(0, K + 1, W).astype(i32), rng.random(W) < 0.9)
    sizes = rng.uniform(0.1, 10.0, T).astype(f32)
    want = np.asarray(jg.rank_match_placement_impl(
        jnp.asarray(sizes), j_elig, *map(jnp.asarray, fleet), max_slots=K,
        task_adm_rank=j_rank))
    got, full, _ = tg.rank_match_compacted(
        torch.from_numpy(sizes), torch.from_numpy(elig),
        *map(torch.from_numpy, fleet), max_slots=K, adm_key=keys,
        tile=T if tile == "T" else tile)
    np.testing.assert_array_equal(got.numpy(), want)
    assert not full
