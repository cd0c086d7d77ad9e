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

Parity rules with the JAX twin: ``max`` is ``torch.maximum`` (NaN
propagates, as ``jnp.maximum``), and the fixup's ``argmax`` is spelled out
as ``jnp.argmax`` decides it: the first maximum, a NaN counting as the
maximum. None of them reads a value back to the host: the fixup's
:data:`HEDGE_FIXUP_K` steps are tensor ops whether or not a row is vetoed.
"""

from __future__ import annotations

import torch

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
