"""Kernel B1's lanes over the grid, as plain models, against JAX.

Kernel B1 no longer places the hedge fixup's vetoed tasks with one block-wide
argmax each: it lists the first ``HEDGE_FIXUP_K + 1`` rows with slots left
by a 64-bit key cut with the rank branch's radix select, and one warp walks
the vetoed tasks over that list. It no longer counts the deficit carry's
placements on one block either: each block counts its tile. The plain
models of that decomposition (``tpu_faas_torch.spec.straggler.
hedge_fixup_listed`` and ``tpu_faas_torch.tenancy.fairshare.
tenant_deficit_tiled``) must give EXACTLY what JAX's ``hedge_fixup_impl``
gives, and what the port's plain ``tenant_deficit_update_impl`` gives (JAX's
within the pinned share-sum tolerance, exactly on shares that sum exactly),
on the same seeded numpy inputs. The main path runs none of these models:
the card runs the kernel, the CPU the plain version.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_faas.spec import straggler as jspec
from tpu_faas.tenancy import fairshare as jfair
from tpu_faas_torch.spec import straggler as tspec
from tpu_faas_torch.tenancy import fairshare as tfair

f32, i32 = np.float32, np.int32
I32_MIN, I32_MAX = np.iinfo(i32).min, np.iinfo(i32).max
K = tspec.HEDGE_FIXUP_K
RTOL = 1e-6  # the deficit's share sum (ROADMAP C, "Slice 5")


# -- the hedge fixup ----------------------------------------------------------
def _fixup_case(rng, T, W, n_veto):
    """Placements on about half the tasks, ``n_veto`` of them vetoed (the
    avoid row is the placement), other tasks avoiding a row they are not
    on or none; speeds with ties; raw free counts from -2 past the
    placements; about a tenth of the rows dead."""
    assign = np.where(rng.random(T) < 0.5, rng.integers(0, W, T),
                      -1).astype(i32)
    avoid = np.where(rng.random(T) < 0.3, rng.integers(0, W, T),
                     -1).astype(i32)
    placed = np.flatnonzero(assign >= 0)
    veto = rng.choice(placed, min(n_veto, placed.size), replace=False)
    avoid[veto] = assign[veto]
    clash = (avoid == assign) & (assign >= 0)
    clash[veto] = False
    avoid[clash] = -1
    speed = (np.round(rng.uniform(0.5, 4.0, W) * 4) / 4).astype(f32)
    free = rng.integers(-2, 6, W).astype(i32) + np.bincount(
        assign[assign >= 0], minlength=W).astype(i32)
    live = rng.random(W) < 0.9
    return assign, avoid, speed, free, live


def _fixup_all(assign, avoid, speed, free, live):
    """(JAX's, the port's plain version's, the listed model's, the list)."""
    want = np.asarray(jspec.hedge_fixup(
        jnp.asarray(assign), jnp.asarray(avoid), jnp.asarray(speed),
        jnp.asarray(free), jnp.asarray(live)))
    plain = tspec.hedge_fixup_impl(
        torch.from_numpy(assign), torch.from_numpy(avoid),
        torch.from_numpy(speed), torch.from_numpy(free),
        torch.from_numpy(live)).numpy()
    got, rows = tspec.hedge_fixup_listed(assign, avoid, speed, free, live)
    return want, plain, got, rows


def _check(case):
    want, plain, got, rows = _fixup_all(*case)
    np.testing.assert_array_equal(plain, want)
    np.testing.assert_array_equal(got, want)
    assert rows.size <= K + 1
    return want, rows


def _edited(edit, seed=0, T=3000, W=4096, n_veto=200):
    assign, avoid, speed, free, live = _fixup_case(
        np.random.default_rng(seed), T, W, n_veto)
    edit(assign, avoid, speed, free, live)
    return assign, avoid, speed, free, live


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("n_veto", [0, 1, 17, 64, 65, 500])
def test_listed_fixup_equals_jax(seed, n_veto):
    """Random states: none, a few, exactly 64, 65 and hundreds of vetoed
    tasks (the first 64 in index order are re-placed)."""
    case = _fixup_case(np.random.default_rng(seed), 3000, 4096, n_veto)
    want, _ = _check(case)
    veto = (case[1] >= 0) & (case[0] == case[1])
    if n_veto > K:
        # the 65th vetoed task onward stays queued
        assert (want[np.flatnonzero(veto)[K:]] == -1).all()


def test_all_equal_speeds_over_4096_rows():
    """Every key differs in the row alone: the select cuts on the low
    bits, and the list runs in row order."""
    def edit(assign, avoid, speed, free, live):
        speed[:] = 1.0
    case = _edited(edit)
    want, rows = _check(case)
    assert rows.size == K + 1 and (np.diff(rows) > 0).all()


def test_signed_zero_speeds_tie():
    """-0.0 and +0.0 rank as one speed: ties go to the lower row."""
    def edit(assign, avoid, speed, free, live):
        speed[:] = np.where(np.arange(speed.size) % 2, -0.0, 0.0)
        speed[:5] = 1.0
    case = _edited(edit, seed=1)
    want, rows = _check(case)
    assert (np.diff(rows[np.abs(case[2][rows]) == 0]) > 0).all()


@pytest.mark.parametrize("seed", [0, 1])
def test_nan_and_minus_inf_speeds(seed):
    """NaN rows rank first (jnp.argmax's maximum) and keep a task queued;
    -inf rows are never candidates."""
    def edit(assign, avoid, speed, free, live):
        rng = np.random.default_rng(10 + seed)
        speed[rng.choice(speed.size, 40, replace=False)] = np.nan
        speed[rng.choice(speed.size, 400, replace=False)] = -np.inf
    _check(_edited(edit, seed=seed))


def test_a_nan_row_that_is_every_tasks_best():
    """One live NaN row with slots and no task avoiding it: every vetoed
    task stays queued, and the NaN row takes nothing."""
    def edit(assign, avoid, speed, free, live):
        speed[7] = np.nan
        live[7] = True
        free[7] = 1000
        assign[assign == 7] = -1
        avoid[avoid == 7] = -1
    case = _edited(edit, seed=2)
    want, rows = _check(case)
    veto = (case[1] >= 0) & (case[0] == case[1])
    assert rows[0] == 7 and (want[veto] == -1).all()


def test_the_avoid_row_is_the_fastest():
    """Every vetoed task avoids the one fastest row: each takes the next."""
    def edit(assign, avoid, speed, free, live):
        speed[3] = 100.0
        live[3] = True
        free[3] += 500
        on3 = np.flatnonzero((assign == 3))[:50]
        avoid[on3] = 3
    case = _edited(edit, seed=3)
    want, rows = _check(case)
    assert rows[0] == 3
    assert not (want[(case[1] == 3) & (case[0] == 3)] == 3).any()


def test_every_candidate_row_emptied_by_the_fixup():
    """One slot left on each of 100 rows in speed order, 64 vetoed tasks:
    step k takes row k; the last task avoids row 63, so its pick is the
    list's last position, K."""
    T, W = 200, 100
    speed = np.linspace(10.0, 1.0, W).astype(f32)
    live = np.ones(W, bool)
    assign = np.full(T, -1, i32)
    avoid = np.full(T, -1, i32)
    # 64 tasks vetoed on rows past the list's reach, keeping no slot
    assign[:K] = 99
    avoid[:K] = 99
    avoid[K - 1] = 63
    assign[K - 1] = 63
    free = np.ones(W, i32)
    free[99] = 0
    free[63] = 1
    want, rows = _check((assign, avoid, speed, free, live))
    assert rows.size == K + 1
    assert list(want[: K - 1]) == list(range(K - 1))
    assert want[K - 1] == K and rows[K] == K


@pytest.mark.parametrize("W", [1, 2, 64, 65, 66])
def test_fewer_rows_than_the_list(W):
    """W below, at and just past the list's length, W = 1 included."""
    for seed in range(3):
        _check(_fixup_case(np.random.default_rng(seed), 300, W, 80))


def test_negative_and_wrapping_raw_free_counts():
    """Raw free counts below zero leave no slot; INT32_MIN less a kept
    placement wraps to INT32_MAX slots, as XLA's int32 subtraction."""
    def edit(assign, avoid, speed, free, live):
        free[: free.size // 2] = -3
        kept = (assign >= 0) & (avoid != assign)
        row = int(assign[np.flatnonzero(kept)[0]])
        free[row] = I32_MIN
        live[row] = True
        speed[row] = 50.0
    _check(_edited(edit, seed=4))


def test_dead_rows():
    """Half the rows dead, the fastest among them: no slot there."""
    def edit(assign, avoid, speed, free, live):
        live[::2] = False
        speed[0] = 99.0
        free[0] = 100
    _check(_edited(edit, seed=5))


# -- the deficit carry --------------------------------------------------------
def _deficit_case(seed, N, T=6000, shares=None):
    rng = np.random.default_rng(seed)
    share = (rng.uniform(0.1, 5.0, N).astype(f32) if shares is None
             else np.resize(np.asarray(shares, f32), N))
    return dict(
        assignment=np.where(rng.random(T) < 0.5, -1,
                            rng.integers(0, 64, T)).astype(i32),
        task_tenant=rng.integers(-1, N + 1, T).astype(i32),
        demand=rng.random(N) < 0.7,
        tenant_share=share,
        tenant_deficit=rng.choice(np.array([0.0, 0.5, 7.25, 4095.0], f32),
                                  N),
    )


def _deficit_all(case, tile):
    want = np.asarray(jfair.tenant_deficit_update_impl(
        **{k: jnp.asarray(v) for k, v in case.items()}))
    plain = tfair.tenant_deficit_update_impl(
        **{k: torch.from_numpy(v) for k, v in case.items()}).numpy()
    got = tfair.tenant_deficit_tiled(**case, tile=tile)
    return want, plain, got


@pytest.mark.parametrize("tile", [7, 388, 6000])
@pytest.mark.parametrize("N", [1, 32, 1100])
def test_tiled_deficit_equals_the_plain_version(N, tile):
    """Per-tile counts summed give the plain version's deficit bit for
    bit, and JAX's within the share sum's tolerance up to 32 tenant rows
    (XLA sums 1,100 shares in its own order: there the model is held to
    JAX exactly on shares that sum exactly, below)."""
    for seed in range(2):
        want, plain, got = _deficit_all(_deficit_case(seed, N), tile)
        np.testing.assert_array_equal(got, plain)
        if N <= 32:
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)


@pytest.mark.parametrize("shares", [(8.0, 1.0), (3.0, 1.0)])
@pytest.mark.parametrize("N", [1, 32, 1100])
def test_tiled_deficit_exact_on_exactly_summing_shares(N, shares):
    want, plain, got = _deficit_all(_deficit_case(3, N, shares=shares), 388)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(plain, want)
