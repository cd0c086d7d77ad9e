"""Rank-matching placement — the headline scheduler path, in PyTorch.

Counterpart of ``tpu_faas/sched/greedy.py``. The placement rule: expand each
live worker into its free process slots (capped at ``max_slots`` per worker
per tick), sort slots by worker speed descending, admit tasks (FCFS, by
priority, or by a precomputed admission rank), sort admitted tasks by size
descending, and pair rank-for-rank. Tasks beyond the available slots stay
queued for the next tick.

Parity rules with the JAX twin: every argsort is ``stable=True`` on literally
the same key (``argsort(-x)``, never ``descending=True``, so ``-0.0`` and
``0.0`` tie and break by index exactly as ``jnp.argsort`` does), and every
integer is int32 where JAX has i32.

Also here: copies of the NumPy host baselines ``host_greedy_reference``,
``host_greedy_vectorized`` and ``makespan``.
"""

from __future__ import annotations

import heapq

import numpy as np
import torch

_I32 = torch.int32
_I32_MAX = int(np.iinfo(np.int32).max)


def rank_match_placement_impl(
    task_size: torch.Tensor,  # f32[T]
    task_valid: torch.Tensor,  # bool[T]
    worker_speed: torch.Tensor,  # f32[W]
    worker_free: torch.Tensor,  # i32[W]
    worker_live: torch.Tensor,  # bool[W]
    max_slots: int = 8,
    task_priority: torch.Tensor | None = None,  # i32[T], higher first
    task_adm_rank: torch.Tensor | None = None,  # i32[T] precomputed order
) -> torch.Tensor:
    """Return assignment i32[T]: worker index per task, -1 = stay queued."""
    T = task_size.shape[0]
    W = worker_speed.shape[0]
    S = W * max_slots
    dev = task_size.device

    free = torch.where(worker_live, worker_free.to(_I32), 0)
    k = torch.arange(max_slots, dtype=_I32, device=dev)
    slot_valid = (k[None, :] < free[:, None]).reshape(S)
    slot_worker = torch.arange(W, dtype=_I32, device=dev).repeat_interleave(
        max_slots
    )
    slot_speed = torch.where(
        slot_valid,
        worker_speed[:, None].expand(W, max_slots).reshape(S),
        -torch.inf,
    )

    # fastest valid slots first (invalid sink to the end)
    slot_order = torch.argsort(-slot_speed, stable=True)
    slot_worker_sorted = slot_worker[slot_order]

    # admission: FCFS by default; with task_priority (priority desc, arrival
    # asc — the stable sort keeps FCFS as the tie-break); with task_adm_rank
    # a direct rank compare against the slot count
    n_slots = slot_valid.sum(dtype=_I32)
    if task_adm_rank is not None:
        admitted = task_valid & (task_adm_rank < n_slots)
    elif task_priority is None:
        arrival_rank = torch.cumsum(task_valid.to(_I32), 0, dtype=_I32) - 1
        admitted = task_valid & (arrival_rank < n_slots)
    else:
        # integer key (a float key would collapse priorities above 2**24);
        # invalid tasks sink to the end via int32 max
        adm_key = torch.where(
            task_valid, -task_priority.to(_I32), _I32_MAX
        ).to(_I32)
        adm_order = torch.argsort(adm_key, stable=True)
        adm_rank = torch.zeros(T, dtype=_I32, device=dev)
        adm_rank[adm_order] = torch.arange(T, dtype=_I32, device=dev)
        admitted = task_valid & (adm_rank < n_slots)

    # largest admitted tasks first (non-admitted sink to the end)
    task_key = torch.where(admitted, task_size, -torch.inf)
    task_order = torch.argsort(-task_key, stable=True)

    n_tasks = admitted.sum(dtype=_I32)
    L = min(T, S)  # static pairing length
    n_pairs = torch.minimum(n_slots, n_tasks)
    pair_ok = torch.arange(L, dtype=_I32, device=dev) < n_pairs

    paired_tasks = task_order[:L]
    paired_workers = torch.where(pair_ok, slot_worker_sorted[:L], -1).to(_I32)

    assignment = torch.full((T,), -1, dtype=_I32, device=dev)
    assignment[paired_tasks] = paired_workers
    return assignment


def host_greedy_reference(
    task_sizes: np.ndarray,
    worker_speeds: np.ndarray,
    worker_free: np.ndarray,
    worker_live: np.ndarray,
) -> np.ndarray:
    """Reference-style greedy, on host, in Python: walk pending tasks in
    arrival order, hand each to the free live worker with most free slots
    (the LRU deque's effect), stop when capacity is exhausted."""
    free = np.where(worker_live, worker_free, 0).astype(np.int64).copy()
    assignment = np.full(len(task_sizes), -1, dtype=np.int32)

    heap = [(-free[w], w) for w in range(len(free)) if free[w] > 0]
    heapq.heapify(heap)
    for t in range(len(task_sizes)):
        while heap:
            negf, w = heapq.heappop(heap)
            if -negf != free[w]:  # stale entry
                continue
            break
        else:
            break
        assignment[t] = w
        free[w] -= 1
        if free[w] > 0:
            heapq.heappush(heap, (-free[w], w))
    return assignment


def host_greedy_vectorized(
    task_sizes: np.ndarray,
    worker_speeds: np.ndarray,
    worker_free: np.ndarray,
    worker_live: np.ndarray,
) -> np.ndarray:
    """``host_greedy_reference`` as one numpy pass — bit-identical policy.

    The heap walk grants slots in order of (current free count desc, worker
    index asc); worker ``w``'s j-th granted slot is taken while its free
    count reads ``free_w - j``, so the grant sequence is all (w, j) slot
    pairs sorted by (free_w - j) descending, worker ascending."""
    free = np.where(worker_live, worker_free, 0).astype(np.int64)
    total = int(free.sum())
    n = min(len(task_sizes), total)
    assignment = np.full(len(task_sizes), -1, dtype=np.int32)
    if n == 0:
        return assignment
    slot_worker = np.repeat(np.arange(len(free), dtype=np.int64), free)
    # free count each slot's grant observes: free_w, free_w - 1, ...
    ends = np.cumsum(free)
    level = ends[slot_worker] - np.arange(len(slot_worker))
    order = np.lexsort((slot_worker, -level))
    assignment[:n] = slot_worker[order[:n]].astype(np.int32)
    return assignment


def makespan(
    assignment: np.ndarray,
    task_sizes: np.ndarray,
    worker_speeds: np.ndarray,
    max_slots: int = 8,
) -> float:
    """Host metric: completion time of a one-wave placement. Each worker runs
    its assigned tasks on parallel process slots (up to max_slots); a
    worker's time is its own tasks LPT-packed onto its slots."""
    assignment = np.asarray(assignment)
    total = 0.0
    for w in np.unique(assignment[assignment >= 0]):
        sizes = np.sort(task_sizes[assignment == w])[::-1]
        slots = np.zeros(max_slots)
        for s in sizes:
            i = slots.argmin()
            slots[i] += s / worker_speeds[w]
        total = max(total, slots.max())
    return float(total)
