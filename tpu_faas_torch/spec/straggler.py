"""Straggler scoring and the hedge's anti-affinity, as torch ops.

Counterpart of ``tpu_faas/spec/straggler.py``, whose ``_impl`` forms the
JAX tick traces (inside the fused Pallas resident kernel too). Here they
are plain torch ops on the device of their inputs: the batch tick
(``sched/state.py``) runs them there, and the resident tick's plain version
(``sched/resident.py``) runs them wherever its state lies. On the card the
resident tick runs the same lane inside kernel B1 (``csrc/fused_tick.cu``),
which equals these ops exactly.

- :func:`straggler_flags_impl` flags in-flight slots whose elapsed time is
  past ``max(quantile_mult x predicted, min_runtime_s)``;
- :func:`anti_affinity_veto_impl` reverts a placement that landed a task on
  its forbidden worker row;
- :func:`hedge_fixup_impl` vetoes, then re-places up to
  :data:`HEDGE_FIXUP_K` vetoed rows greedily onto the fastest live worker
  with capacity left after the main pass, never the row's own forbidden
  worker.

Also here: :func:`hedge_fixup_listed`, a plain model of how kernel B1
computes the fixup over its grid (a candidate list of
``HEDGE_FIXUP_K + 1`` rows cut by a radix select, then a walk over it),
for the tests; the card's path never runs it.

Parity rules with the JAX twin: ``max`` is ``torch.maximum`` (NaN
propagates, as ``jnp.maximum``), and the fixup's ``argmax`` is spelled out
as ``jnp.argmax`` decides it: the first maximum, a NaN counting as the
maximum. None of them reads a value back to the host: the fixup's
:data:`HEDGE_FIXUP_K` steps are tensor ops whether or not a row is vetoed.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_faas_torch.sched.greedy import NO_KEY, float_key, radix_select
from tpu_faas_torch.sched.scatter import scatter_add, scatter_set

_I32 = torch.int32

#: default absolute floor (seconds) under which an execution is never
#: flagged, whatever the multiplier says
DEFAULT_MIN_RUNTIME_S = 0.05

#: per-tick bound on vetoed rows re-placed by the fixup; a surplus waits a
#: tick
HEDGE_FIXUP_K = 64


def straggler_flags_impl(
    inflight_elapsed: torch.Tensor,  # f32[I] seconds since dispatch
    inflight_predicted: torch.Tensor,  # f32[I] predicted runtime, <=0 opts out
    inflight_occupied: torch.Tensor,  # bool[I] slot holds a live dispatch
    quantile_mult,  # f32 scalar: flag past mult x predicted
    min_runtime_s,  # f32 scalar: absolute floor
) -> torch.Tensor:
    """bool[I]: in-flight slots whose execution has outlived its
    prediction. A slot opts out with ``predicted <= 0``."""
    mult = torch.as_tensor(quantile_mult, dtype=torch.float32,  # faas: allow(trace.host-sync) a host float on the batch tick (a device scalar on the resident one copies nothing)
                           device=inflight_predicted.device)
    floor = torch.as_tensor(min_runtime_s, dtype=torch.float32,  # faas: allow(trace.host-sync) a host float on the batch tick (a device scalar on the resident one copies nothing)
                            device=inflight_predicted.device)
    threshold = torch.maximum(mult * inflight_predicted, floor)
    return (
        inflight_occupied
        & (inflight_predicted > 0.0)
        & (inflight_elapsed > threshold)
    )


def anti_affinity_veto_impl(
    assignment: torch.Tensor,  # i32[T] placement output, -1 = queued
    task_avoid_worker: torch.Tensor,  # i32[T] forbidden row per task, -1 none
) -> torch.Tensor:
    """Revert placements that landed a task on its forbidden worker row;
    the vetoed task stays queued."""
    veto = (task_avoid_worker >= 0) & (assignment == task_avoid_worker)
    return torch.where(veto, -1, assignment).to(_I32)


def _first_argmax(score: torch.Tensor) -> torch.Tensor:
    """``jnp.argmax`` of a float vector as an int64[1] tensor: the first
    maximum, the first NaN if there is one; all -inf gives 0."""
    n = score.shape[0]
    is_nan = torch.isnan(score)
    top = torch.where(is_nan, float("-inf"), score).max()
    hit = torch.where(is_nan.any(), is_nan, score == top)
    rows = torch.arange(n, device=score.device)
    return torch.where(hit, rows, n).min().reshape(1)


def hedge_fixup_impl(
    assignment: torch.Tensor,  # i32[T] placement output
    task_avoid_worker: torch.Tensor,  # i32[T] forbidden row (-1 = none)
    worker_speed: torch.Tensor,  # f32[W]
    worker_free: torch.Tensor,  # i32[W] capacity the placement pass saw
    worker_live: torch.Tensor,  # bool[W]
) -> torch.Tensor:
    """Veto, then re-place up to :data:`HEDGE_FIXUP_K` vetoed rows (the
    first in index order), each in turn onto the fastest live worker with
    free slots left after the main pass, never its own forbidden row. A
    row with no such worker stays queued. ``worker_free`` is the raw count
    (not clamped to ``max_slots``), as in the JAX reference."""
    T = assignment.shape[0]
    W = worker_speed.shape[0]
    dev = assignment.device
    veto = (task_avoid_worker >= 0) & (assignment == task_avoid_worker)
    assignment = torch.where(veto, -1, assignment).to(_I32)
    # capacity remaining after the main pass
    placed = assignment >= 0
    counts = scatter_add(
        torch.zeros(W, dtype=_I32, device=dev),
        torch.where(placed, assignment, W).long(), 1,
    )
    free_rem = torch.clamp(
        torch.where(worker_live, worker_free, 0) - counts, min=0
    ).to(_I32)
    # the first HEDGE_FIXUP_K vetoed rows, in index order, -1 padded
    K = HEDGE_FIXUP_K
    pos = torch.cumsum(veto.to(_I32), 0, dtype=_I32) - 1
    idx = torch.where(veto & (pos < K), pos, K).long()
    vet_idx = scatter_set(torch.full((K,), -1, dtype=_I32, device=dev), idx,
                          torch.arange(T, dtype=_I32, device=dev))
    rows = torch.arange(W, dtype=_I32, device=dev)
    # every step reads its operands as 1-element tensors (index_select, not
    # a 0-d index): nothing is read back to the host
    for k in range(K):
        t = vet_idx[k : k + 1]
        safe_t = t.clamp(min=0).long()
        avoid = task_avoid_worker.index_select(0, safe_t)
        score = torch.where(worker_live & (free_rem > 0) & (rows != avoid),
                            worker_speed, float("-inf"))
        row = _first_argmax(score)
        can = (t >= 0) & (score.index_select(0, row) > float("-inf"))
        assignment = scatter_set(assignment, torch.where(can, safe_t, T),
                                 row.to(_I32))
        free_rem = scatter_add(free_rem, row,
                               torch.where(can, -1, 0).to(_I32))
    return assignment


def hedge_fixup_listed(
    assignment: np.ndarray,  # i32[T] placement output
    task_avoid_worker: np.ndarray,  # i32[T] forbidden row (-1 = none)
    worker_speed: np.ndarray,  # f32[W]
    worker_free: np.ndarray,  # i32[W] raw free counts
    worker_live: np.ndarray,  # bool[W]
) -> tuple[np.ndarray, np.ndarray]:
    """:func:`hedge_fixup_impl` as kernel B1 computes it over its grid:
    ``(assignment, rows)``, with ``rows`` the candidate list in key order.
    The rows with slots left after the veto (int32 arithmetic, floored at
    0) whose speed is not -inf are keyed ``(~float_key(speed) << 32) |
    row``: ascending keys run NaN first, then by speed down, ties to the
    lower row, all distinct. The list is the first ``HEDGE_FIXUP_K + 1``
    of them, cut by :func:`~tpu_faas_torch.sched.greedy.radix_select`.
    Each of the first ``HEDGE_FIXUP_K`` vetoed tasks in index order then
    takes the first listed row with slots left that is not its avoid row,
    unless that row's speed is NaN (``jnp.argmax``'s NaN fails ``> -inf``:
    the task stays queued). A step's pick lies among the first ``k + 2``
    positions (the rows before it were emptied by the ``k`` earlier steps,
    or are its avoid row), so the list is enough; the walk asserts it."""
    W = worker_speed.shape[0]
    a = assignment.astype(np.int64)
    avoid = task_avoid_worker.astype(np.int64)
    veto = (avoid >= 0) & (a == avoid)
    a = np.where(veto, -1, a)
    kept = np.bincount(a[a >= 0], minlength=W)
    raw = np.where(worker_live, worker_free.astype(np.int64), 0) - kept
    rem = np.maximum((raw + 2**31) % 2**32 - 2**31, 0)  # int32 wraps
    cand = (rem > 0) & (worker_speed != np.float32(-np.inf))
    rows_all = np.arange(W, dtype=np.uint64)
    keys = np.where(
        cand,
        ((~float_key(worker_speed.astype(np.float32))).astype(np.uint64)
         << np.uint64(32)) | rows_all,
        np.uint64(NO_KEY))
    K = HEDGE_FIXUP_K
    thr = radix_select(keys, K + 1)[0] if int(cand.sum()) > K + 1 else NO_KEY
    listed = cand & (keys <= np.uint64(thr))
    rows = np.flatnonzero(listed)[np.argsort(keys[listed], kind="stable")]
    assert rows.size <= K + 1
    for k, t in enumerate(np.flatnonzero(veto)[:K]):
        fit = np.flatnonzero((rem[rows] > 0) & (rows != avoid[t]))
        if fit.size == 0:
            # none fits anywhere: a list of K + 1 rows always holds one
            assert rows.size <= K
            continue
        assert fit[0] <= k + 1
        w = rows[fit[0]]
        if np.isnan(worker_speed[w]):
            continue
        a[t] = w
        rem[w] -= 1
    return a.astype(np.int32), rows.astype(np.int32)
