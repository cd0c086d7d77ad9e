"""Auction assignment (Bertsekas forward auction, Jacobi bidding).

Counterpart of ``tpu_faas/sched/auction.py``. Optimal (within n·ε)
min-cost placement of pending tasks onto worker process slots: all
unassigned tasks bid at once each round (value = -size/speed - price), the
per-slot winners come from one two-key sort, and prices rise until every
admitted task owns a slot. When tasks outnumber free slots, the earliest
arrivals are admitted (FCFS) and the rest stay queued.

Each round's top-2 bid is :func:`tpu_faas_torch.sched.bid.bid_top2`: kernel
B2 on the card, its plain version on the CPU. The rest of the round is
plain torch ops. JAX's ``while_loop`` becomes a host loop that evaluates
JAX's own condition before each round (an admitted task still unassigned,
and rounds under the budget), so the round counts match; that condition is
one small read back per round. This module is the batch tick's solver and
the plain version of the resident tick's auction; on the card the resident
tick runs the whole solve, rounds included, inside one launch of
``csrc/fused_tick.cu``.

The module-level helpers stay module-level: the mesh path reuses them.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tpu_faas_torch.sched.bid import bid_top2
from tpu_faas_torch.sched.scatter import scatter_set

_I32 = torch.int32
_INF = float("inf")
#: the solver's ε and warm-round budget where the caller gives none (the
#: resident tick never does); the auction kernel takes the same values
EPS = 1e-3
WARM_ROUNDS = 64


def bid_scalars(eps: float) -> tuple[float, float]:
    """(jitter scale, ε) as the f32 values the bids use: the hash jitter is
    bounded by ε/4."""
    return float(np.float32(eps * 0.25)), float(np.float32(eps))


class AuctionResult(NamedTuple):
    assignment: torch.Tensor  # i32[T] worker per task, -1 = stay queued
    n_rounds: int  # bidding rounds run (counted on the host)
    prices: torch.Tensor  # f32[S] final slot prices
    #: bool scalar: admitted tasks left unassigned AFTER the rank spill
    stranded: torch.Tensor | None = None
    #: bool scalar: the caller should drop its carried prices and re-solve
    #: cold next tick (a large spilled tail, or placement incomplete)
    refresh: torch.Tensor | None = None
    #: i32 scalar: tasks the rank spill placed after bidding stopped
    n_spilled: torch.Tensor | None = None
    #: rows that bid, summed over the rounds (counted on the host): the
    #: (bidder, slot) cells a solve needs are this times S
    n_bid_rows: int | None = None


def _expand_and_square(
    task_valid, worker_speed, worker_free, worker_live, max_slots: int
):
    """Slot expansion (rank placement's layout) plus squaring to
    n = min(#tasks, #slots): the forward auction with persistent prices is
    ε-optimal only on square problems, and the size/speed cost is monotone
    in slot speed, so the optimal matching uses the n fastest slots. Trims
    slots to n and admits the n earliest-arrival tasks."""
    W = worker_speed.shape[0]
    S = W * max_slots
    dev = worker_speed.device
    free = torch.where(worker_live, worker_free, 0)
    k = torch.arange(max_slots, dtype=_I32, device=dev)
    slot_valid = (k[None, :] < free[:, None]).reshape(S)
    slot_worker = torch.arange(W, dtype=_I32, device=dev).repeat_interleave(
        max_slots
    )
    slot_speed = worker_speed[:, None].expand(W, max_slots).reshape(S)
    n_slots_avail = slot_valid.sum(dtype=_I32)
    n_valid_tasks = task_valid.sum(dtype=_I32)
    n_match = torch.minimum(n_slots_avail, n_valid_tasks)
    speed_key = torch.where(slot_valid, slot_speed, -_INF)
    slot_order_by_speed = torch.argsort(-speed_key, stable=True)
    slot_rank = torch.empty(S, dtype=_I32, device=dev)
    slot_rank[slot_order_by_speed] = torch.arange(S, dtype=_I32, device=dev)
    slot_valid = slot_valid & (slot_rank < n_match)
    arrival_rank = torch.cumsum(task_valid.to(_I32), 0, dtype=_I32) - 1
    admitted = task_valid & (arrival_rank < n_match)
    return (
        slot_valid, slot_worker, slot_speed, speed_key,
        slot_order_by_speed, n_match, admitted,
    )


def _rank_dual_seed(
    task_size, admitted, speed_key, slot_order_by_speed, n_match
):
    """Analytic near-equilibrium prices from the rank matching. The cost is
    separable, so the optimal matching pairs the k-th largest admitted task
    with the k-th fastest slot, and stability pins each price step to
    [size_(k+1)·d_k, size_k·d_k], d_k = inv_(k+1) - inv_k. The seed takes
    the midpoint of each interval (one sort and one reversed cumsum), which
    gives both neighbours a strict preference for their own slot."""
    T = task_size.shape[0]
    S = speed_key.shape[0]
    dev = task_size.device
    inv_sorted = 1.0 / speed_key[slot_order_by_speed].clamp_min(1e-6)
    tkey = torch.where(admitted, task_size, -_INF)
    size_sorted = (torch.sort(-tkey).values * -1.0).clamp_min(0.0)
    j = torch.arange(S, dtype=_I32, device=dev)
    size_mid = torch.zeros(S, dtype=torch.float32, device=dev)
    # position j reads task j+1 and slot j+1: bounded by both lengths
    take = max(0, min(T - 1, S - 1))
    if take > 0:
        size_mid[:take] = 0.5 * (size_sorted[:take] + size_sorted[1 : take + 1])
    diff = torch.cat([inv_sorted[1:] - inv_sorted[:-1],
                      torch.zeros(1, dtype=torch.float32, device=dev)])
    contrib = torch.where(j + 1 < n_match, size_mid * diff.clamp_min(0.0), 0.0)
    # the reversed cumsum runs on the host: a float cumsum on CUDA sums in
    # an order that changes from run to run, and the seed must not (one
    # S-long copy each way, once per cold tick). torch's CPU cumsum of
    # float32 is ONE serial float64 running sum, each prefix rounded to
    # float32: here, from the last position to the first. The auction
    # kernel sums in exactly this order.
    p_sorted = torch.cumsum(contrib.flip(0).cpu(), 0).flip(0).to(dev)
    prices = torch.zeros(S, dtype=torch.float32, device=dev)
    prices[slot_order_by_speed] = p_sorted
    return prices


def _rebase(prices):
    """Shift by the smallest POSITIVE price, clamped at 0: bids compare
    price differences, so the translation is free, and the positive floor
    stays effective in padded fleets whose unused slots sit at 0."""
    pos_min = torch.where(prices > 0, prices, _INF).amin()
    shift = torch.where(torch.isfinite(pos_min), pos_min, 0.0)
    return (prices - shift).clamp_min(0.0)


def _rank_spill_close(
    assigned_slot, owner, admitted, task_size, slot_valid, slot_speed,
    slot_worker, n_match,
):
    """Close the leftover tail in-tick by the rank rule (largest leftover
    task to fastest leftover slot, Monge-optimal within the leftover set),
    and judge price staleness: ``refresh`` when the spilled tail exceeded
    5% of the matching (and 8 tasks) after an exhausted budget, or when
    placement is still incomplete.

    Returns (assignment, stranded, refresh, n_spill)."""
    T = assigned_slot.shape[0]
    S = slot_worker.shape[0]
    dev = assigned_slot.device
    leftover_task = admitted & (assigned_slot < 0)
    budget_exhausted = leftover_task.any()
    leftover_slot = slot_valid & (owner < 0)
    n_spill = torch.minimum(leftover_task.sum(dtype=_I32),
                            leftover_slot.sum(dtype=_I32))
    t_ord = torch.argsort(-torch.where(leftover_task, task_size, -_INF),
                          stable=True)
    s_ord = torch.argsort(-torch.where(leftover_slot, slot_speed, -_INF),
                          stable=True)
    Lsp = min(T, S)
    ok = torch.arange(Lsp, device=dev) < n_spill
    sp_tasks = torch.where(ok, t_ord[:Lsp], T)
    sp_slots = torch.where(ok, s_ord[:Lsp], S)
    assigned_slot = scatter_set(assigned_slot, sp_tasks, sp_slots.to(_I32))
    stranded = (admitted & (assigned_slot < 0)).any()
    refresh = stranded | (
        budget_exhausted
        & (n_spill * 20 > n_match.clamp_min(1))
        & (n_spill > 8)
    )
    assignment = torch.where(
        assigned_slot >= 0,
        slot_worker[assigned_slot.clamp(0, S - 1).long()],
        -1,
    ).to(_I32)
    return assignment, stranded, refresh, n_spill


def auction_placement_impl(
    task_size: torch.Tensor,  # f32[T]
    task_valid: torch.Tensor,  # bool[T]
    worker_speed: torch.Tensor,  # f32[W]
    worker_free: torch.Tensor,  # i32[W]
    worker_live: torch.Tensor,  # bool[W]
    max_slots: int = 8,
    eps: float = EPS,
    max_rounds: int = 2000,
    n_phases: int = 10,
    init_price: torch.Tensor | None = None,  # f32[W * max_slots]
    warm_rounds: int = WARM_ROUNDS,
    seed_from_rank: bool = True,
    carry_refresh: torch.Tensor | None = None,  # bool scalar (resident carry)
) -> AuctionResult:
    """Four ways to open the bidding, as in JAX:

    - ``carry_refresh`` given (the resident carry): open from the analytic
      rank-dual seed where it is set, else from the re-based carried
      ``init_price``; bid under ``warm_rounds``;
    - cold and ``seed_from_rank`` (the default): open from the seed, under
      ``warm_rounds``;
    - cold without the seed: the classic ε-ladder of ``n_phases`` phases
      from zero prices, each under ``max_rounds``;
    - warm ``init_price``: open from those prices re-based, at ε, under
      ``warm_rounds``.

    Every path ends in the rank spill, so placement is always complete and
    ``refresh`` tells the caller to re-solve cold next tick."""
    T = task_size.shape[0]
    W = worker_speed.shape[0]
    S = W * max_slots
    dev = task_size.device

    (
        slot_valid, slot_worker, slot_speed, speed_key,
        slot_order_by_speed, n_match, admitted,
    ) = _expand_and_square(
        task_valid, worker_speed, worker_free, worker_live, max_slots
    )

    # implicit benefit -size/speed + jitter, -inf on invalid slots; the
    # hash jitter (bounded by eps/4) breaks the ties of uniform costs
    inv_speed = 1.0 / slot_speed.clamp_min(1e-6)
    valid_f = slot_valid.to(torch.float32)
    jitter_scale, eps_final = bid_scalars(eps)
    task_ids = torch.arange(T, dtype=_I32, device=dev)

    def body(price, owner, assigned_slot, eps_i):
        bidder = admitted & (assigned_slot < 0)
        v1, best, v2 = bid_top2(task_size, inv_speed, valid_f, price,
                                jitter_scale)
        # single valid slot: v2 = -inf -> the bid caps at a large increment
        incr = torch.where(torch.isfinite(v2), v1 - v2, 1.0) + eps_i
        bid_price = price[best.long()] + incr
        bidder = bidder & torch.isfinite(v1)

        # per-slot winner: JAX's lexsort((-bid_price, slot_key)) as two
        # stable argsorts, the secondary key first
        slot_key = torch.where(bidder, best, S)  # non-bidders sink last
        by_price = torch.argsort(-bid_price, stable=True)
        order = by_price[torch.argsort(slot_key[by_price], stable=True)]
        s_sorted = slot_key[order]
        first = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                           s_sorted[1:] != s_sorted[:-1]])
        win = first & (s_sorted < S)
        win_task = torch.where(win, task_ids[order], -1)
        win_slot = torch.where(win, s_sorted, S)  # S = dropped write
        win_price = bid_price[order]

        # evict previous owners of won slots (sentinel T drops the write;
        # owners never bid, so evict and install index sets are disjoint)
        prev_owner = torch.where(
            win, owner[win_slot.clamp(0, S - 1).long()], -1
        )
        evict_idx = torch.where(prev_owner >= 0, prev_owner, T)
        assigned_slot = scatter_set(assigned_slot, evict_idx, -1)
        owner = scatter_set(owner, win_slot, win_task)
        price = scatter_set(price, win_slot, win_price)
        install_idx = torch.where(win_task >= 0, win_task, T)
        assigned_slot = scatter_set(assigned_slot, install_idx, win_slot)
        return price, owner, assigned_slot

    bid_rows = 0

    def bid_until(price, owner, assigned_slot, limit, eps_i):
        """JAX's while_loop on the host: the same condition before each
        round, so the same round count. Adds each round's bidders (admitted
        tasks still without a slot) to ``bid_rows``."""
        nonlocal bid_rows
        rounds = 0
        while rounds < limit:
            n_bid = int((admitted & (assigned_slot < 0)).sum())
            if n_bid == 0:
                break
            price, owner, assigned_slot = body(price, owner, assigned_slot,
                                               eps_i)
            bid_rows += n_bid
            rounds += 1
        return price, owner, assigned_slot, rounds

    owner0 = torch.full((S,), -1, dtype=_I32, device=dev)
    assigned0 = torch.full((T,), -1, dtype=_I32, device=dev)

    def rank_dual_seed():
        return _rank_dual_seed(
            task_size, admitted, speed_key, slot_order_by_speed, n_match
        )

    def ladder():
        """The classic ε-scaling ladder from zero prices: ``n_phases``
        phases from coarse to fine ε, each under ``max_rounds``. A phase
        resets the matching only when its ε is finer than the last
        (uniform costs keep one ε, and those phases exit at once)."""
        size_min = torch.where(admitted, task_size, _INF).amin()
        size_max = torch.where(admitted, task_size, -_INF).amax()
        inv_min = torch.where(slot_valid, inv_speed, _INF).amin()
        inv_max = torch.where(slot_valid, inv_speed, -_INF).amax()
        rng = size_max * inv_max - size_min * inv_min
        rng = torch.where(torch.isfinite(rng) & (rng > 0), rng, 0.0)
        eps_f = torch.tensor(eps, dtype=torch.float32, device=dev)
        eps0 = torch.maximum(rng / 2.0, eps_f)
        exponent = 1.0 / (n_phases - 1) if n_phases > 1 else 0.0
        ratio = (eps_f / eps0) ** exponent
        price = torch.zeros(S, dtype=torch.float32, device=dev)
        owner, assigned_slot = owner0, assigned0
        eps_prev = torch.tensor(_INF, dtype=torch.float32, device=dev)
        total = 0
        for i in range(n_phases):
            eps_i = eps0 * ratio ** torch.tensor(float(i), device=dev)
            finer = eps_i < eps_prev * float(np.float32(1.0 - 1e-6))
            owner = torch.where(finer, -1, owner)
            assigned_slot = torch.where(finer, -1, assigned_slot)
            price, owner, assigned_slot, rounds = bid_until(
                price, owner, assigned_slot, max_rounds, eps_i
            )
            total += rounds
            eps_prev = eps_i
        return price, owner, assigned_slot, total

    if carry_refresh is not None:
        # the resident carry: cold and warm differ only in the opening
        # prices, the seed when last tick flagged refresh
        price0 = torch.where(carry_refresh, rank_dual_seed(),
                             _rebase(init_price))
        price, owner, assigned_slot, rounds = bid_until(
            price0, owner0, assigned0, warm_rounds, eps_final
        )
    elif init_price is None and seed_from_rank:
        price, owner, assigned_slot, rounds = bid_until(
            rank_dual_seed(), owner0, assigned0, warm_rounds, eps_final
        )
    elif init_price is None:
        price, owner, assigned_slot, rounds = ladder()
    else:
        price, owner, assigned_slot, rounds = bid_until(
            _rebase(init_price), owner0, assigned0, warm_rounds, eps_final
        )

    assignment, stranded, refresh, n_spill = _rank_spill_close(
        assigned_slot, owner, admitted, task_size, slot_valid, slot_speed,
        slot_worker, n_match,
    )
    return AuctionResult(assignment, rounds, price, stranded, refresh, n_spill,
                         bid_rows)


#: the public name: PyTorch runs eagerly, so the solver is its own entry
auction_placement = auction_placement_impl
