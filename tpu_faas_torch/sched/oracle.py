"""Host-side oracles for testing and makespan comparison.

Counterpart of ``tpu_faas/sched/oracle.py``, a copy in numpy:

- `optimal_assignment`: exact min-cost matching (scipy Hungarian) on the
  slot-expanded problem — ground truth for placement-quality tests.
- `makespan_lower_bound`: the LP/offline bound BASELINE.md measures against:
  a placement can never beat max(total work / total speed capacity, largest
  single task on the fastest worker).
"""

from __future__ import annotations

import numpy as np


def expand_slots(
    worker_speeds: np.ndarray,
    worker_free: np.ndarray,
    worker_live: np.ndarray,
    max_slots: int,
) -> tuple[np.ndarray, np.ndarray]:
    """(slot_worker, slot_speed) for every free slot of every live worker."""
    slot_worker, slot_speed = [], []
    for w in range(len(worker_speeds)):
        if not worker_live[w]:
            continue
        for _ in range(min(int(worker_free[w]), max_slots)):
            slot_worker.append(w)
            slot_speed.append(worker_speeds[w])
    return np.asarray(slot_worker, dtype=np.int32), np.asarray(
        slot_speed, dtype=np.float32
    )


def optimal_assignment(
    task_sizes: np.ndarray,
    worker_speeds: np.ndarray,
    worker_free: np.ndarray,
    worker_live: np.ndarray,
    max_slots: int = 8,
) -> tuple[np.ndarray, float]:
    """Exact min-total-cost assignment of tasks to slots (cost = size/speed).

    Returns (assignment i32[T] with -1 for unplaced, total_cost). When tasks
    outnumber slots, scipy places the cost-minimizing subset.
    """
    from scipy.optimize import linear_sum_assignment

    slot_worker, slot_speed = expand_slots(
        worker_speeds, worker_free, worker_live, max_slots
    )
    T, S = len(task_sizes), len(slot_worker)
    assignment = np.full(T, -1, dtype=np.int32)
    if S == 0 or T == 0:
        return assignment, 0.0
    cost = task_sizes[:, None] / slot_speed[None, :]
    rows, cols = linear_sum_assignment(cost)
    total = float(cost[rows, cols].sum())
    assignment[rows] = slot_worker[cols]
    return assignment, total


def makespan_lower_bound(
    task_sizes: np.ndarray,
    worker_speeds: np.ndarray,
    worker_free: np.ndarray,
    worker_live: np.ndarray,
    max_slots: int = 8,
) -> float:
    """Offline LP bound on one-wave makespan (parallel slots per worker)."""
    _, slot_speed = expand_slots(worker_speeds, worker_free, worker_live, max_slots)
    if len(slot_speed) == 0:
        return float("inf")
    total_work = float(np.sum(task_sizes))
    total_speed = float(np.sum(slot_speed))
    fastest = float(np.max(slot_speed))
    largest = float(np.max(task_sizes)) if len(task_sizes) else 0.0
    return max(total_work / total_speed, largest / fastest)
