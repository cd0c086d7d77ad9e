"""Device-computed ready frontier for task graphs (the batch tick).

Counterpart of ``tpu_faas/graph/frontier.py``. The tpu-push dispatcher
keeps WAITING graph nodes resident beside the pending batch and feeds the
batch tick a padded edge list; the readiness mask is ONE segment-reduce
composed into the tick (``sched/state.packed_tick``), so dependency-aware
placement happens where placement already happens. The host side of this
module (:func:`pad_pref`, :func:`pad_edges`, :class:`GraphFrontier`) is a
copy of the JAX module's bookkeeping: which nodes are waiting, which
parents have been CONFIRMED complete, and which worker rows hold their
results.

The device ops are plain torch ops, as they are plain XLA ops in JAX (no
kernel): :func:`dep_ready_mask`, :func:`parent_pref_impl` and the
post-placement :func:`locality_exchange`, which swaps a preferring task
with the task holding its preferred worker only between EQUAL-SPEED
workers, where the swap is makespan-neutral. JAX's ``.at[idx]`` scatters
with ``mode="drop"`` wrap a negative index once and drop index T and
above; its scatter-add, -min and -max are ``scatter_add_`` and
``scatter_reduce_(..., include_self=True)`` on a buffer initialized as JAX
initializes it, so repeated indices reduce alike. A lane that drops (a pad
lane, an unassigned or preference-free task) reduces the buffer's own
fill, a no-op, into a row of its own (its lane number mod the length):
piled onto one sentinel row, tens of thousands of such lanes would
serialize on one address's atomics on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_faas_torch.sched.scatter import scatter_set

_I32 = torch.int32


def _reduce_into(N: int, fill, dtype: torch.dtype, idx: torch.Tensor,
                 keep: torch.Tensor, vals: torch.Tensor,
                 reduce: str) -> torch.Tensor:
    """``jnp.full(N, fill).at[idx].add/min/max(vals, mode="drop")`` over
    the lanes ``keep`` marks. A negative index wraps once; what still
    falls outside [0, N) drops. ``fill`` must leave the reduction's rows
    unchanged (0 for a sum, the init for a min, a floor the values never
    go under for a max): every dropped lane reduces it into row
    ``lane % N``."""
    dev = idx.device
    idx = torch.where(idx < 0, idx + N, idx)
    keep = keep & (idx >= 0) & (idx < N)
    lane = torch.arange(idx.shape[0], device=dev) % N
    out = torch.full((N,), fill, dtype=dtype, device=dev)
    at = torch.where(keep, idx, lane).long()
    v = torch.where(keep, vals.to(dtype), fill)
    if reduce == "sum":
        return out.scatter_add_(0, at, v)
    return out.scatter_reduce_(0, at, v, reduce, include_self=True)


def dep_ready_mask(
    edge_child: torch.Tensor,  # i32[E] batch row per edge (T = dropped pad)
    edge_undone: torch.Tensor,  # i32[E] 1 while the edge's parent is unconfirmed
    *,
    T: int,
) -> torch.Tensor:
    """bool[T]: True where a batch row has no unconfirmed parents — the
    segment-reduce over the edge list. Rows without edges are ready."""
    every = torch.ones_like(edge_child, dtype=torch.bool)
    blocked = _reduce_into(T, 0, _I32, edge_child, every, edge_undone, "sum")
    return blocked == 0


def locality_exchange(
    assignment: torch.Tensor,  # i32[T] worker row per task, -1 queued
    task_pref: torch.Tensor,  # i32[T] preferred worker row, -1 none
    worker_speed: torch.Tensor,  # f32[W]
) -> torch.Tensor:
    """Swap preferring tasks toward their preferred workers, makespan-
    neutrally. For each preferred worker the (index-lowest) preferring
    task swaps assignments with that worker's (index-lowest) currently
    assigned task, iff both workers' speeds are equal and the holder is
    itself preference-free (so no task takes part in two swaps). Both
    ``.set`` scatters have distinct indices by construction; invalid lanes
    go to the sentinel row and drop. ``old_of_t`` is read before either."""
    T = assignment.shape[0]
    W = worker_speed.shape[0]
    dev = assignment.device
    tidx = torch.arange(T, dtype=_I32, device=dev)
    BIG = T
    assigned = assignment >= 0
    a_clip = assignment.clamp(0, W - 1).long()
    p_clip = task_pref.clamp(0, W - 1).long()
    # |s[a] - s[p]| <= 1e-6 * max(s[a], 1e-9), op by op in float32
    # (clamp_min propagates NaN as jnp.maximum does, and copies nothing
    # from the host)
    s_a, s_p = worker_speed[a_clip], worker_speed[p_clip]
    want = (
        (task_pref >= 0)
        & assigned
        & (task_pref != assignment)
        & ((s_a - s_p).abs() <= 1e-6 * s_a.clamp_min(1e-9))
    )
    # representative holder per worker (lowest assigned task index), and
    # the chosen wanter per preferred worker (a task wants one worker);
    # JAX scatters BIG for the other tasks, which changes nothing
    holder = _reduce_into(W, BIG, _I32, a_clip, assigned, tidx, "amin")
    wanter = _reduce_into(W, BIG, _I32, p_clip, want, tidx, "amin")
    h = holder.clamp(0, T - 1).long()
    t = wanter.clamp(0, T - 1).long()
    valid = (holder < BIG) & (wanter < BIG) & (holder != wanter)
    # the holder must not itself be a preferring task: every task's swap
    # membership is then unique
    valid = valid & ~want[h]
    w_ids = torch.arange(W, dtype=_I32, device=dev)
    old_of_t = assignment[t]
    out = scatter_set(assignment, torch.where(valid, t, T), w_ids)
    return scatter_set(out, torch.where(valid, h, T), old_of_t)


def parent_pref_impl(
    pref_child: torch.Tensor,  # i32[P] batch row per (child, holder) pair
    pref_row: torch.Tensor,  # i32[P] worker row holding parent-result bytes
    pref_bytes: torch.Tensor,  # f32[P] bytes that row holds for the child
    *,
    T: int,
) -> torch.Tensor:
    """i32[T] preferred worker row per batch row (-1 none): the row
    holding the MOST of the child's parent-result bytes, ties to the
    lowest row. A scatter-max of bytes into zeros, then a masked
    scatter-min of rows into a 2**30 sentinel; pad lanes (child = T,
    bytes = 0) drop."""
    # the max starts at 0 and never falls below it, so 0 is its no-op fill
    every = torch.ones_like(pref_child, dtype=torch.bool)
    best = _reduce_into(T, 0.0, torch.float32, pref_child, every, pref_bytes,
                        "amax")
    c = pref_child.clamp(0, T - 1).long()
    win = (pref_bytes > 0.0) & (pref_bytes >= best[c])
    BIG = 2**30
    row = _reduce_into(T, BIG, _I32, pref_child, win, pref_row, "amin")
    return torch.where(row < BIG, row, -1).to(_I32)


def pad_pref(
    child: list[int], row: list[int], nbytes: list[float], T: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pad the host (child, holder row, bytes) triplets to the next power
    of two (bounded jit signatures, same discipline as :func:`pad_edges`)
    with dropped lanes (child = T, row = 0, bytes = 0)."""
    P = max(len(child), 1)
    k = 1 << (P - 1).bit_length()
    c = np.full(k, T, dtype=np.int32)
    r = np.zeros(k, dtype=np.int32)
    b = np.zeros(k, dtype=np.float32)
    if child:
        c[: len(child)] = child
        r[: len(row)] = row
        b[: len(nbytes)] = nbytes
    return c, r, b


def pad_edges(
    edge_child: list[int], edge_undone: list[int], T: int
) -> tuple[np.ndarray, np.ndarray]:
    """Pad the host edge list to the next power of two (bounded jit
    signatures) with dropped lanes (child = T, undone = 0)."""
    E = max(len(edge_child), 1)
    k = 1 << (E - 1).bit_length()
    child = np.full(k, T, dtype=np.int32)
    undone = np.zeros(k, dtype=np.int32)
    if edge_child:
        child[: len(edge_child)] = edge_child
        undone[: len(edge_undone)] = edge_undone
    return child, undone


class GraphFrontier:
    """Host bookkeeping of the device frontier: WAITING nodes held beside
    the pending batch, parent confirmations, and per-node preferred rows.

    A parent becomes ``done`` here ONLY when the dispatcher's
    complete_dep_many round for it succeeded (note_parent), which is what
    makes the device mask's "ready" imply "record already QUEUED". Nodes
    leave through pop() — dispatch, promotion-announce adoption into
    pending, poison, or reconciliation."""

    def __init__(self, cap: int = 8192) -> None:
        self.cap = cap
        #: task_id -> PendingTask (the payload source at dispatch time)
        self.waiting: dict[str, object] = {}
        #: task_id -> parent ids (immutable edge list from FIELD_DEPS)
        self.parents: dict[str, list[str]] = {}
        #: parent id -> waiting child ids (reverse index)
        self._children: dict[str, set[str]] = {}
        #: parent id -> (ok, worker_row, result_digest, result_size) once
        #: CONFIRMED terminal; kept only while some waiting child still
        #: references the parent. digest/size are None/0 outside the
        #: result data plane (--result-blobs) — the pref triplet builder
        #: then has nothing to weigh and the byte-locality lane stays off.
        self._parent_state: dict[str, tuple[bool, int, str | None, int]] = {}
        self.n_frontier_dispatches = 0

    def __len__(self) -> int:
        return len(self.waiting)

    def add(self, task, parent_ids: list[str]) -> bool:
        """Hold a WAITING node; False when full or already held (the
        promotion-announce path covers skipped nodes)."""
        tid = task.task_id
        if tid in self.waiting or len(self.waiting) >= self.cap:
            return False
        self.waiting[tid] = task
        self.parents[tid] = list(parent_ids)
        for pid in parent_ids:
            self._children.setdefault(pid, set()).add(tid)
        return True

    def has_waiting_children(self, parent_id: str) -> bool:
        return bool(self._children.get(parent_id))

    def note_parent(
        self,
        parent_id: str,
        ok: bool,
        row: int = -1,
        digest: str | None = None,
        size: int = 0,
    ) -> None:
        """A parent's terminal write landed AND its complete_dep_many round
        succeeded: flip its edges. ``row`` is the worker row that returned
        the result (the locality preference for ok parents); ``digest``/
        ``size`` identify the result body in the content-addressed plane
        when the producer shipped digest-form (--result-blobs) — what the
        byte-weighted pref lane scores children toward."""
        if self._children.get(parent_id):
            self._parent_state[parent_id] = (
                bool(ok), int(row), digest, int(size),
            )

    def pop(self, task_id: str):
        """Remove and return a held node (None if not held). Parent states
        nothing references anymore are dropped with it."""
        task = self.waiting.pop(task_id, None)
        if task is None:
            return None
        for pid in self.parents.pop(task_id, ()):
            kids = self._children.get(pid)
            if kids is not None:
                kids.discard(task_id)
                if not kids:
                    del self._children[pid]
                    self._parent_state.pop(pid, None)
        return task

    def confirmed_parents(
        self, task_id: str
    ) -> list[tuple[str, str | None, int]]:
        """(parent_id, result_digest, result_size) for every confirmed-OK
        parent of a held node — the dispatch-time source of the child's
        dep delivery (digest = None means the body lives in the store
        record). Captured BEFORE pop(): popping drops the edge list."""
        out: list[tuple[str, str | None, int]] = []
        for pid in self.parents.get(task_id, ()):
            state = self._parent_state.get(pid)
            if state is not None and state[0]:
                out.append((pid, state[2], state[3]))
        return out

    def failed_parent_of(self, task_id: str) -> str | None:
        """A confirmed-failed parent of this node, if any — the host-side
        fast drop for poisoned nodes (the store record is already FAILED
        by the promotion plane; the frontier just forgets)."""
        for pid in self.parents.get(task_id, ()):
            state = self._parent_state.get(pid)
            if state is not None and not state[0]:
                return pid
        return None

    def edge_arrays(
        self, rows: dict[int, str], T: int
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray | None]:
        """(edge_child, edge_undone, task_pref) for this tick's batch:
        ``rows`` maps batch row -> held task_id. task_pref is None when no
        node has a confirmed-ok parent row (skips the exchange pass and
        its jit signature entirely)."""
        edge_child: list[int] = []
        edge_undone: list[int] = []
        pref = np.full(T, -1, dtype=np.int32)
        any_pref = False
        for row, tid in rows.items():
            best = -1
            for pid in self.parents.get(tid, ()):
                state = self._parent_state.get(pid)
                done = state is not None and state[0]
                edge_child.append(row)
                edge_undone.append(0 if done else 1)
                if done and state[1] >= 0:
                    best = state[1]
            if best >= 0:
                pref[row] = best
                any_pref = True
        child, undone = pad_edges(edge_child, edge_undone, T)
        return child, undone, (pref if any_pref else None)

    def pref_arrays(
        self,
        rows: dict[int, str],
        T: int,
        holder_rows: dict[str, set[int]],
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray] | None:
        """Deduped, padded (pref_child, pref_row, pref_bytes) triplets for
        :func:`parent_pref` — one lane per (batch row, candidate worker
        row) pair, weighted by how many of the child's confirmed parents'
        result bytes that worker's cache holds. ``holder_rows`` is the
        dispatcher's digest -> worker-row mirror. None when no waiting
        child has a digest-form parent held anywhere (the jitted tick
        keeps its pref-free signature)."""
        acc: dict[tuple[int, int], float] = {}
        for row, tid in rows.items():
            for pid in self.parents.get(tid, ()):
                state = self._parent_state.get(pid)
                if state is None or not state[0]:
                    continue
                digest, size = state[2], state[3]
                if not digest or size <= 0:
                    continue
                for hrow in holder_rows.get(digest, ()):
                    key = (row, int(hrow))
                    acc[key] = acc.get(key, 0.0) + float(size)
        if not acc:
            return None
        return pad_pref(
            [k[0] for k in acc],
            [k[1] for k in acc],
            list(acc.values()),
            T,
        )
