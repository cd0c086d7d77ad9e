"""The resident auction tick's placement, in plain NumPy.

The rule is the scheduler's documented auction (Bertsekas's forward
auction with Jacobi bidding, ε = 1e-3, at most 64 warm rounds, a rank
spill to close): expand each live worker into ``min(free, max_slots)``
process slots, keep the ``n = min(#slots, #valid tasks)`` fastest slots
(ties by slot index) and admit the ``n`` valid tasks of lowest pending
index; open from the rank-dual seed when the carried prices are stale,
else from the carried prices shifted down by their smallest positive
entry; each round every admitted task without a slot bids on its best
slot by value ``-size/speed + jitter - price``, raising that slot's price
by the gap to its runner-up plus ε; the highest bid wins a slot (ties to
the lowest task index) and evicts its owner. ``jitter`` is the Wang hash
of the cell index ``task * n_slots + slot`` (mod 2**32), shifted right by
8, times 2**-24 and ε/4. Leftover tasks then take leftover slots largest
to fastest, and the prices are flagged stale when a large tail spilled.

Every float is float32 and every operation rounds on its own, in the
order written here, so the result is exact where the program is right.
Only the admitted tasks and the kept slots enter the bids: a bid over a
slot outside them is -inf and changes no maximum, so the work is
(admitted tasks x kept slots) a round, not (tasks x all slots).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

F32 = np.float32
EPS = 1e-3
WARM_ROUNDS = 64
_INF = F32(np.inf)


@dataclass
class AuctionTick:
    task_slots: np.ndarray  # i64 pending slots placed, ascending
    rows: np.ndarray  # i64 worker row of each
    price: np.ndarray  # f32[S] prices carried to the next tick
    refresh: bool  # carried staleness flag
    rounds: int  # bidding rounds run
    bid_rows: int  # bidders summed over the rounds
    n_match: int  # tasks admitted (= slots kept)
    n_spilled: int  # tasks the rank spill placed


def _wang_hash(x: np.ndarray) -> np.ndarray:
    """Wang's 32-bit integer hash on uint32 (products wrap mod 2**32)."""
    x = (x ^ np.uint32(61)) ^ (x >> np.uint32(16))
    x = x * np.uint32(9)
    x = x ^ (x >> np.uint32(4))
    x = x * np.uint32(0x27D4EB2D)
    return x ^ (x >> np.uint32(15))


def jitter(task_slots: np.ndarray, slots: np.ndarray, n_slots: int
           ) -> np.ndarray:
    """u(t, s) in [0, 1): f32[len(task_slots), len(slots)]."""
    idx = (task_slots.astype(np.uint32)[:, None] * np.uint32(n_slots)
           + slots.astype(np.uint32)[None, :])
    u = (_wang_hash(idx) >> np.uint32(8)).astype(np.int32).astype(F32)
    return u * F32(2.0**-24)


def rank_dual_seed(adm_sizes: np.ndarray, sorted_inv: np.ndarray,
                   n_match: int) -> np.ndarray:
    """The seed's prices of the slots in speed order (f32[len(sorted_inv)]):
    price k is the sum over j >= k (j + 1 < n) of the midpoint of the
    (j+1)-th and (j+2)-th largest admitted sizes times the growth of 1/speed
    from slot j to slot j+1, clamped at 0. The sum runs from the last
    position to the first in float64, each prefix rounded to float32."""
    p = np.zeros(len(sorted_inv), dtype=F32)
    m = n_match - 1
    if m <= 0:
        return p
    size_sorted = -np.sort(-adm_sizes)  # largest first, f32
    size_mid = F32(0.5) * (size_sorted[:m] + size_sorted[1:m + 1])
    diff = np.maximum(sorted_inv[1:m + 1] - sorted_inv[:m], F32(0.0))
    contrib = size_mid * diff
    p[:m] = np.cumsum(contrib[::-1].astype(np.float64))[::-1].astype(F32)
    return p


def rebase(price: np.ndarray) -> np.ndarray:
    """Shift by the smallest positive price, clamped at 0."""
    pos = price[price > 0]
    shift = pos.min() if len(pos) else F32(0.0)
    return np.maximum(price - shift, F32(0.0))


def auction_tick(
    size: np.ndarray,  # f32[T]
    valid: np.ndarray,  # bool[T]
    speed: np.ndarray,  # f32[W]
    free: np.ndarray,  # int[W]
    live: np.ndarray,  # bool[W]
    max_slots: int,
    price: np.ndarray,  # f32[W * max_slots] carried
    refresh: bool,  # carried
    n_free_pending: int,  # pending slots not valid
) -> AuctionTick:
    T, W, K = len(size), len(speed), max_slots
    S = W * K
    free_eff = np.where(live, np.minimum(free, K), 0)
    rows = np.flatnonzero(free_eff > 0)
    k = np.arange(K)
    slots = (rows[:, None] * K + k[None, :])[
        k[None, :] < free_eff[rows][:, None]]  # valid slots, index order
    n_match = min(len(slots), T - n_free_pending)
    slot_speed = speed[slots // K]
    by_speed = np.argsort(-slot_speed, kind="stable")
    kept = np.sort(slots[by_speed[:n_match]])
    # the admitted: the n_match valid tasks of lowest index, all of them
    # among the first n_match + n_free_pending slots
    adm = np.flatnonzero(valid[:n_match + n_free_pending])[:n_match]

    inv_sorted = F32(1.0) / np.maximum(slot_speed[by_speed], F32(1e-6))
    if refresh:
        p0 = np.zeros(S, dtype=F32)
        p0[slots[by_speed]] = rank_dual_seed(size[adm], inv_sorted, n_match)
    else:
        p0 = rebase(price)
    p = p0
    if n_match == 0:
        return AuctionTick(np.empty(0, np.int64), np.empty(0, np.int64), p,
                           False, 0, 0, 0, 0)

    jscale, eps = F32(EPS * 0.25), F32(EPS)
    inv_kept = F32(1.0) / np.maximum(speed[kept // K], F32(1e-6))
    base = ((-size[adm])[:, None] * inv_kept[None, :]
            + jitter(adm, kept, S) * jscale)
    pk = p[kept].copy()
    assigned = np.full(n_match, -1, dtype=np.int64)  # kept index per task
    owner = np.full(n_match, -1, dtype=np.int64)  # task index per slot
    rounds = bid_rows = 0
    while rounds < WARM_ROUNDS:
        bidders = np.flatnonzero(assigned < 0)
        if len(bidders) == 0:
            break
        val = np.take(base, bidders, axis=0)
        np.subtract(val, pk, out=val)
        r = np.arange(len(bidders))
        best = val.argmax(axis=1)  # the first maximum
        v1 = val[r, best]
        val[r, best] = -_INF
        v2 = val[r, val.argmax(axis=1)]
        incr = np.where(np.isfinite(v2), v1 - v2, F32(1.0)) + eps
        bid = pk[best] + incr
        ok = np.isfinite(v1)
        b, s, bp = bidders[ok], best[ok], bid[ok]
        # per slot the highest bid, ties to the lowest task index
        order = np.lexsort((-bp, s))
        s_sorted = s[order]
        first = np.ones(len(order), dtype=bool)
        first[1:] = s_sorted[1:] != s_sorted[:-1]
        win_task, win_slot = b[order][first], s_sorted[first]
        prev = owner[win_slot]
        assigned[prev[prev >= 0]] = -1
        owner[win_slot] = win_task
        pk[win_slot] = bp[order][first]
        assigned[win_task] = win_slot
        bid_rows += len(bidders)
        rounds += 1
    p = p.copy()
    p[kept] = pk

    # the rank spill: leftover tasks, largest first, to leftover slots,
    # fastest first (ties by index)
    left_t = np.flatnonzero(assigned < 0)
    left_s = np.flatnonzero(owner < 0)
    n_spill = min(len(left_t), len(left_s))
    t_ord = left_t[np.argsort(-size[adm[left_t]], kind="stable")]
    s_ord = left_s[np.argsort(-speed[kept[left_s] // K], kind="stable")]
    assigned[t_ord[:n_spill]] = s_ord[:n_spill]
    stranded = bool((assigned < 0).any())
    exhausted = len(left_t) > 0
    new_refresh = stranded or (exhausted and n_spill * 20 > max(n_match, 1)
                               and n_spill > 8)
    done = assigned >= 0
    return AuctionTick(adm[done], kept[assigned[done]] // K, p, new_refresh,
                       rounds, bid_rows, n_match, n_spill)
