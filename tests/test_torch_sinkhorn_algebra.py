"""The algebra of B1's Sinkhorn branch on Hopper, in its plain torch forms,
against JAX on the CPU.

The CUDA kernel (``tpu_faas_torch/csrc/fused_tick.cu``) computes each
logsumexp of an iteration as online (max, sum) folds in base 2 over a
lane's cells, merged per warp and per row or column in no fixed order; and
it runs the capacity repair and spill over compacted lists. Both have a
plain form in ``tpu_faas_torch/sched/sinkhorn.py``:

- ``split_logsumexp``: the cells cut into 1-8 chunks, each folded, the
  folds merged in shuffled orders, against ``jax.nn.logsumexp``. Within
  LSE_ATOL: the cells are scaled by log2(e) and the result by ln 2 (one
  rounding of each, at most 2^-24 of |x| <= 40, 2.4e-6) and the sums run in
  other orders; JAX's hazards exactly (an all -inf row gives -inf, a NaN
  cell NaN, a row absent from the slack column -inf).
- ``repair_compacted``: exactly JAX's ``_repair_candidates`` on the same
  candidates, ties, signed zeros and NaN masses, cap-0 workers, every task
  to slack, one worker drawing every candidate, and non-finite sizes and
  speeds (which take rank placement's own sorts).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_faas.sched import sinkhorn as J
from tpu_faas_torch.sched import sinkhorn as P

f32, i32 = np.float32, np.int32
#: |split - jax.nn.logsumexp| on rows of |x| <= 40: two roundings of the
#: base change (2^-24 * 40 * 1.44 each) and the sums' order; measured
#: below 1e-5
LSE_ATOL = 2e-5


def _cuts(rng, n, k):
    """k chunks of [0, n): k - 1 distinct interior bounds, sorted."""
    return sorted(rng.choice(np.arange(1, n), k - 1, replace=False).tolist())


def _check_split(x, rng, k):
    want = np.asarray(jax.nn.logsumexp(jnp.asarray(x), axis=-1))
    xt = torch.from_numpy(x)
    for _ in range(3):
        bounds = _cuts(rng, x.shape[-1], k)
        order = rng.permutation(k).tolist()
        got = P.split_logsumexp(xt, bounds, order).numpy()
        fin = np.isfinite(want)
        np.testing.assert_array_equal(np.isfinite(got), fin)
        np.testing.assert_array_equal(got[~fin], want[~fin])
        np.testing.assert_allclose(got[fin], want[fin], rtol=0,
                                   atol=LSE_ATOL)


@pytest.mark.parametrize("k", [1, 2, 3, 5, 8])
def test_split_logsumexp_random_rows(k):
    """Rows in the iterations' range (-cost/tau + g/tau within [-40, 40])
    with -inf cells mixed in."""
    rng = np.random.default_rng(k)
    x = rng.uniform(-40.0, 40.0, (24, 257)).astype(f32)
    x[rng.random(x.shape) < 0.1] = -np.inf
    _check_split(x, rng, k)


@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_split_logsumexp_hazards(k):
    """An all -inf row gives -inf (never NaN); a chunk that is all -inf
    merges as nothing; a NaN cell makes its row NaN; a +inf cell +inf; a
    row whose finite cells lie far below 0 keeps them."""
    rng = np.random.default_rng(10 + k)
    x = rng.uniform(-5.0, 5.0, (6, 64)).astype(f32)
    x[0] = -np.inf  # all -inf
    x[1, :40] = -np.inf  # -inf chunks beside finite ones
    x[2, 17] = np.nan  # a NaN cell
    x[3, 5] = np.inf
    x[4] = rng.uniform(-3000.0, -2900.0, 64)  # 2^(x - 0) would underflow
    x[5, ::2] = -np.inf
    want = np.asarray(jax.nn.logsumexp(jnp.asarray(x), axis=-1))
    assert want[0] == -np.inf and np.isnan(want[2]) and want[3] == np.inf
    _check_split(x[[0, 1, 2, 3, 5]], rng, k)
    # the far row: atol scaled to its magnitude (|x| near 3,000)
    got = P.split_logsumexp(torch.from_numpy(x[4:5]), _cuts(rng, 64, k),
                            rng.permutation(k).tolist()).numpy()
    np.testing.assert_allclose(got, want[4:5], rtol=2e-7, atol=0)


def _bucketed_matrix(seed, K=12, W=40):
    """A bucketed problem's [K+1, W+1] -cost/tau as the plain version
    builds it (absent rows, closed columns, the slack row and column), and
    potentials g, f of its first iteration."""
    rng = np.random.default_rng(seed)
    rep = np.exp(rng.uniform(-1.0, 2.0, K)).astype(f32)
    inv = (1.0 / rng.uniform(0.5, 4.0, W)).astype(f32)
    row_open = rng.random(K) < 0.8
    col_open = rng.random(W) < 0.7
    tau = f32(0.05 * rep.max() * inv.max())
    slack = f32(rep.max() * inv.max() + 1.0)
    negc = np.full((K + 1, W + 1), -np.inf, f32)
    real = -(rep[:, None] * inv[None, :]) / tau
    negc[:K, :W] = np.where(row_open[:, None] & col_open[None, :], real,
                            -np.inf)
    negc[:K, W] = np.where(row_open, -slack / tau, -np.inf)
    negc[K, :W] = np.where(col_open, 0.0, -np.inf)
    g = rng.uniform(-5.0, 5.0, W + 1).astype(f32)
    g[:W][~col_open] = -np.inf
    f = rng.uniform(-5.0, 5.0, K + 1).astype(f32)
    f[:K][~row_open] = -np.inf
    return negc, f, g


@pytest.mark.parametrize("k", [1, 3, 8])
@pytest.mark.parametrize("seed", [0, 1])
def test_split_logsumexp_slack_row_and_column(seed, k):
    """The f-update's rows (the slack row's last cell -inf) and the
    g-update's columns (the slack column's last cell -inf) of a bucketed
    problem, with absent rows and closed columns all -inf."""
    negc, f, g = _bucketed_matrix(seed)
    rng = np.random.default_rng(20 + seed)
    rows = negc + g[None, :]
    cols = (negc + f[:, None]).T.copy()
    assert np.isneginf(rows[-1, -1]) and np.isneginf(cols[-1, -1])
    _check_split(rows, rng, k)
    _check_split(cols, rng, k)


# -- the close: exactly JAX's _repair_candidates ------------------------------
def _close_case(kind, seed=0, T=400, W=48, K=4):
    rng = np.random.default_rng(seed)
    args = dict(
        best_w=rng.integers(0, W, T).astype(i32),
        best_p=(rng.integers(0, 6, T) / 4 - 0.5).astype(f32),
        to_slack=rng.random(T) < 0.2,
        task_size=(rng.integers(0, 40, T) / 8).astype(f32),
        task_valid=rng.random(T) < 0.8,
        worker_speed=rng.choice(np.array([0.5, 1.0, 2.0, 4.0], f32), W),
        worker_free=rng.integers(-1, 7, W).astype(i32),
        worker_live=rng.random(W) < 0.85,
    )
    if kind == "ties in best_p":
        args["best_p"] = np.full(T, 0.25, f32)
    elif kind == "signed zeros":
        bp = args["best_p"]
        bp[rng.random(T) < 0.3] = 0.0
        bp[rng.random(T) < 0.3] = -0.0
    elif kind == "NaN best_p":
        args["best_p"][rng.random(T) < 0.1] = np.nan
    elif kind == "every task to slack":
        args["to_slack"][:] = True
    elif kind == "workers with cap 0":
        free = args["worker_free"]
        free[::2] = 0
        args["worker_live"][1::4] = False
    elif kind == "one worker draws every candidate":
        args["best_w"][:] = 7
        args["worker_free"][7] = 6
        args["worker_live"][7] = True
    elif kind == "few candidates, ample capacity":
        args["to_slack"] = rng.random(T) < 0.95
        args["worker_free"][:] = K
    elif kind == "NaN and -inf sizes":
        args["to_slack"][:] = True
        args["task_size"][[3, 50]] = np.nan
        args["task_size"][[4, 9]] = -np.inf
    elif kind == "NaN and -inf speeds":
        args["worker_speed"][[1, 2]] = np.nan
        args["worker_speed"][5] = -np.inf
        args["worker_live"][[1, 2, 5]] = True
        args["worker_free"][[1, 2, 5]] = 3
    return args, K


CLOSE_KINDS = ["random", "ties in best_p", "signed zeros", "NaN best_p",
               "every task to slack", "workers with cap 0",
               "one worker draws every candidate",
               "few candidates, ample capacity", "NaN and -inf sizes",
               "NaN and -inf speeds"]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("kind", CLOSE_KINDS)
def test_compacted_close_matches_jax_repair(kind, seed):
    """The kernel's close over compacted lists (candidates, spilled tasks,
    slots left) gives JAX's ``_repair_candidates`` assignment exactly."""
    args, K = _close_case(kind, seed)
    want = J._repair_candidates(**{k: jnp.asarray(v) for k, v in
                                   args.items()}, max_slots=K)
    got = P.repair_compacted(**{k: torch.from_numpy(v) for k, v in
                                args.items()}, max_slots=K)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if kind == "one worker draws every candidate":
        kept = (got.numpy() == 7) & ~args["to_slack"] & args["task_valid"]
        assert kept.sum() <= 6
    if kind == "every task to slack":
        assert (got.numpy() >= 0).any()  # the spill alone places them
