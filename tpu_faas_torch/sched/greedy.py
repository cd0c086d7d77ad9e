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

Also here: :func:`rank_match_compacted`, a plain model of how the CUDA
kernel decomposes the same placement (the valid slots and the admitted tasks
compacted in index order and sorted alone, the priority cut found by a radix
select), for the tests; and copies of the NumPy host baselines
``host_greedy_reference``, ``host_greedy_vectorized`` and ``makespan``.
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


#: the admission key of a task the select does not rank
NO_KEY = 2**64 - 1


def float_key(x: np.ndarray) -> np.ndarray:
    """The kernel's order-preserving uint32 key of float32 values: -0.0
    ties 0.0 and every NaN sorts last, as both frameworks sort them."""
    b = np.asarray(x, np.float32).view(np.uint32).copy()
    b[np.asarray(x) == 0] = 0
    b[np.isnan(x)] = 0x7FC00000
    return np.where(b & 0x80000000, ~b, b | 0x80000000).astype(np.uint32)


def int_key(x: np.ndarray) -> np.ndarray:
    """The kernel's order-preserving uint32 key of int32 values."""
    return (np.asarray(x, np.int32).view(np.uint32)
            ^ np.uint32(0x80000000)).astype(np.uint32)


def radix_select(keys: np.ndarray, k: int) -> tuple[int, int, int]:
    """The kernel's admission threshold over the members' uint64 keys
    (``NO_KEY`` on the others): the key at position ``k - 1`` of their
    stable order, found most significant byte first. Each pass keeps the
    members that share the chosen bucket's prefix, buckets them by the
    first byte where the bucket's least and greatest key differ, and picks
    the digit that holds the position; it ends when a bucket holds one key.
    Returns ``(threshold, need, passes)``: the first ``need`` members equal
    to the threshold in index order are admitted with every member below
    it. ``k == 0`` admits none, ``k`` at or past the members all."""
    m = keys[keys != np.uint64(NO_KEY)]
    if k == 0:
        return 0, 0, 0
    if k >= m.size:
        return NO_KEY, 0, 0
    bmin, bmax = int(m.min()), int(m.max())
    below = passes = 0
    while bmin != bmax:
        shift = ((bmin ^ bmax).bit_length() - 1) & ~7
        if shift < 56:
            m = m[(m >> np.uint64(shift + 8)) == np.uint64(bmin >> (shift + 8))]
        digit = ((m >> np.uint64(shift)) & np.uint64(0xFF)).astype(np.int64)
        count = np.bincount(digit, minlength=256)
        start = np.cumsum(count) - count
        d = int(np.searchsorted(start + count, k - 1 - below, side="right"))
        below += int(start[d])
        m = m[digit == d]
        bmin, bmax = int(m.min()), int(m.max())
        passes += 1
    return bmin, k - below, passes


def _tile_prefix(mask: np.ndarray, tile: int) -> np.ndarray:
    """Exclusive prefix counts of ``mask`` as the kernel takes them: each
    tile's count, their scan over the tiles, then the scan inside a tile."""
    n_tiles = -(-mask.size // tile)
    counts = np.add.reduceat(mask.astype(np.int64), np.arange(n_tiles) * tile)
    tile_off = np.cumsum(counts) - counts
    inside = np.concatenate([np.cumsum(c) - c for c in
                             np.array_split(mask.astype(np.int64),
                                            np.arange(1, n_tiles) * tile)])
    return np.repeat(tile_off, tile)[: mask.size] + inside


def admit_select(keys: np.ndarray, ok: np.ndarray, k: int, tile: int):
    """The kernel's admission from the select: ``(admitted bool[T], list,
    passes)``. ``list`` holds the candidates in index order at the
    positions the kernel writes them (below-threshold count before a task,
    plus its rank among the equal ones, capped at ``need``), a candidate
    that is not ``ok`` (an invalid task holding a priority rank) as -1."""
    thr, need, passes = radix_select(keys, k)
    member = keys != np.uint64(NO_KEY)
    lt = member & (keys < np.uint64(thr))
    eq = member & (keys == np.uint64(thr))
    lt_before = _tile_prefix(lt, tile)
    eq_before = _tile_prefix(eq, tile)
    cand = lt | (eq & (eq_before < need))
    pos = lt_before + np.minimum(eq_before, need)
    lst = np.full(int(lt.sum()) + min(int(eq.sum()), need), -2, np.int64)
    lst[pos[cand]] = np.where(ok[cand], np.flatnonzero(cand), -1)
    assert (lst >= -1).all(), "a list position was left unwritten"
    return cand & ok, lst, passes


def rank_match_compacted(
    task_size: torch.Tensor,  # f32[T]
    task_valid: torch.Tensor,  # bool[T]
    worker_speed: torch.Tensor,  # f32[W]
    worker_free: torch.Tensor,  # i32[W]
    worker_live: torch.Tensor,  # bool[W]
    max_slots: int = 8,
    task_priority: torch.Tensor | None = None,  # i32[T], higher first
    adm_key: np.ndarray | None = None,  # u64[T] the tenancy lane's keys
    tile: int = 1024,
) -> tuple[torch.Tensor, bool, int]:
    """:func:`rank_match_placement_impl` as the CUDA kernel decomposes it,
    with the same result: ``(assignment, full_length, passes)``. The valid
    slots, taken in index order, are the only slots sorted by -speed. The
    admission is a select (:func:`admit_select`): FCFS ranks the valid
    tasks on one key; priority ranks every task on ``-prio`` (wrapping),
    ``INT32_MAX`` on an invalid one, as greedy.py's sort does; with
    ``adm_key`` (the tenancy lane's keys,
    ``fairshare.tenant_admission_tiled``) the eligible tasks. The admitted
    tasks, in index order, are the only tasks sorted by -size. A valid slot
    whose speed or an admitted task whose size is -inf or NaN would sort
    among the invalid ones in the full-length sorts; then the placement
    takes them (``full_length``)."""
    T = task_size.shape[0]
    W = worker_speed.shape[0]
    K = max_slots
    valid = task_valid.numpy()
    free = torch.where(worker_live, worker_free, 0).clamp(0, K)
    k = torch.arange(K, dtype=_I32)
    slots = torch.nonzero((k[None, :] < free[:, None]).reshape(W * K))
    slots = slots.flatten()
    if adm_key is not None:
        keys, ok = adm_key, adm_key != np.uint64(NO_KEY)
    elif task_priority is None:
        keys = np.where(valid, np.uint64(0), np.uint64(NO_KEY))
        ok = valid
    else:
        neg = (np.uint32(0) - task_priority.numpy().view(np.uint32)
               ).view(np.int32)
        k32 = np.where(valid, neg, np.int32(_I32_MAX))
        keys = int_key(k32).astype(np.uint64) << np.uint64(32)
        ok = valid
    admitted, lst, passes = admit_select(keys, ok, slots.numel(), tile)
    tasks = torch.from_numpy(lst[lst >= 0])
    speed_s = worker_speed[slots // K]
    size_t = task_size[tasks]
    if bool((~(speed_s > -torch.inf)).any()) or bool(
            (~(size_t > -torch.inf)).any()):
        full = rank_match_placement_impl(
            task_size, torch.from_numpy(admitted), worker_speed, worker_free,
            worker_live, max_slots=max_slots,
        )
        return full, True, passes
    slots = slots[torch.argsort(-speed_s, stable=True)]
    tasks = tasks[torch.argsort(-size_t, stable=True)]
    n_pairs = min(tasks.numel(), slots.numel(), T, W * K)
    assignment = torch.full((T,), -1, dtype=_I32)
    assignment[tasks[:n_pairs]] = (slots[:n_pairs] // K).to(_I32)
    return assignment, False, passes


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
