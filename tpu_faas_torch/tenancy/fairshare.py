"""The in-tick weighted-fair admission and the deficit carry, as torch ops.

Counterpart of ``tpu_faas/tenancy/fairshare.py``, whose ``_impl`` forms the
JAX tick traces (inside the fused Pallas resident kernel too). Here they are
plain torch ops on the device of their inputs: the batch tick
(``sched/state.py``) runs them there, and the resident tick's plain version
(``sched/resident.py``) runs them on the CPU. On the card the resident tick
runs the same lane inside kernel B1 (``csrc/fused_tick.cu``), which equals
these ops exactly.

Policy (start-time fair queuing over the admission lane), as in the JAX
module: every pending task gets a virtual position
``v = (j + 1 - deficit[t]) / share[t]``, ``j`` its FCFS rank within its
tenant's backlog; admission follows (effective priority desc, ``v`` asc,
arrival asc); a tenant at its inflight cap has its surplus masked out of
the placement's valid set; after placement each backlogged tenant's deficit
moves by its share-weighted entitlement of what was placed minus what it
got, clamped to ``[0, deficit_cap]``, and past ``starve_deficit`` it boosts
the tenant's tasks by ``starve_boost`` priority classes.

Also here: :func:`tenant_admission_tiled`, a plain model of how the CUDA
kernel's rank branch computes the same admission over its grid (a tiled
within-tenant rank, and per task the key its admission select ranks), for
the tests.

Parity rules with the JAX twin: the sorts are stable ``argsort``s on
literally JAX's keys (``jnp.lexsort`` becomes one stable sort per key, the
last key first; ``-0.0`` ties ``0.0`` and NaN sorts last in both), and the
one float reduction whose order is free, the share sum of the deficit
update, is ONE float64 running sum in index order, rounded once to float32:
the order the CUDA kernel sums in. XLA sums it in its own order, so against
JAX the deficit agrees to a few ulps (exactly where the shares sum exactly).
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_faas_torch.sched.greedy import NO_KEY, float_key, int_key
from tpu_faas_torch.sched.scatter import scatter_add, scatter_set

_I32 = torch.int32

#: deficit clamp (tasks): bounds the catch-up burst a long-starved tenant
#: can claim at once, and with it the virtual-time shift
DEFAULT_DEFICIT_CAP = 4096.0
#: deficit at which the starvation guard engages
DEFAULT_STARVE_DEFICIT = 1024.0
#: priority classes a starving tenant's tasks are boosted by
DEFAULT_STARVE_BOOST = 1


def _f32(x: float) -> float:
    """A Python float holding ``x`` rounded to float32, as JAX's weakly
    typed constants are against a float32 array."""
    return float(np.float32(x))


def check_segment_key(n_tenants: int, T: int) -> None:
    """The within-tenant rank sorts the int32 key ``tenant * T + row``:
    ``(n_tenants + 1) * T`` must stay inside int32."""
    if (n_tenants + 1) * T > 2**31 - 1:
        raise ValueError(
            f"(max_tenants + 1) * max_pending = {(n_tenants + 1) * T} "
            f"overflows the int32 segment key"
        )


def tenant_fair_admission_impl(
    task_valid: torch.Tensor,  # bool[T]
    task_tenant: torch.Tensor,  # i32[T] dense tenant row per task
    task_priority: torch.Tensor | None,  # i32[T] client hints (None = all 0)
    tenant_share: torch.Tensor,  # f32[N] positive weights
    tenant_deficit: torch.Tensor,  # f32[N] carried under-service
    tenant_ahead: torch.Tensor,  # i32[N] dispatched-but-unreturned per row
    tenant_cap: torch.Tensor,  # i32[N] inflight ceilings (0 = uncapped)
    starve_deficit: float = DEFAULT_STARVE_DEFICIT,
    starve_boost: int = DEFAULT_STARVE_BOOST,
):
    """Returns ``(eligible bool[T], adm_rank i32[T], demand bool[N])``:
    ``task_valid`` minus the rows past their tenant's inflight-cap
    allowance; each task's position in the full admission order (eligible
    tasks occupy ranks ``0..n_eligible-1``); and the tenants with at least
    one eligible task this tick."""
    T = task_valid.shape[0]
    N = tenant_share.shape[0]
    check_segment_key(N, T)
    dev = task_valid.device
    t = task_tenant.to(_I32).clamp(0, N - 1)
    tl = t.long()
    idx = torch.arange(T, dtype=_I32, device=dev)

    # -- FCFS rank within each tenant's valid backlog: one stable sort
    # groups rows by tenant (invalid sink to segment N); within a segment
    # the rank is the position minus the segment start
    seg = torch.where(task_valid, t, N).to(_I32)
    order = torch.argsort(seg * T + idx, stable=True)
    seg_sorted = seg[order]
    is_start = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                          seg_sorted[1:] != seg_sorted[:-1]])
    start = torch.cummax(torch.where(is_start, idx, 0), 0).values
    j = torch.zeros(T, dtype=_I32, device=dev)
    j[order] = idx - start

    # -- hard eligibility: per-tenant inflight caps (int32 arithmetic, as
    # XLA's: the subtraction wraps)
    allowance = torch.where(
        tenant_cap > 0, (tenant_cap - tenant_ahead).clamp_min(0), T
    ).to(_I32)
    eligible = task_valid & (j < allowance[tl])
    demand = scatter_set(torch.zeros(N, dtype=torch.bool, device=dev),
                         torch.where(eligible, t, N), True)

    # -- the admission order -----------------------------------------------
    share = tenant_share.clamp_min(_f32(1e-6))
    v = (j.to(torch.float32) + 1.0 - tenant_deficit[tl]) / share[tl]
    prio = (torch.zeros(T, dtype=_I32, device=dev) if task_priority is None
            else task_priority.to(_I32))
    boost = torch.where(tenant_deficit[tl] >= _f32(starve_deficit),
                        int(starve_boost), 0).to(_I32)
    eff_prio = prio + boost
    # jnp.lexsort((idx, v, -eff_prio, ~eligible)): the LAST key is primary,
    # so stable sorts from the first key to the last; the index order is
    # the starting order
    adm_order = torch.argsort(v, stable=True)
    for key in (-eff_prio, (~eligible).to(_I32)):
        adm_order = adm_order[torch.argsort(key[adm_order], stable=True)]
    adm_rank = torch.zeros(T, dtype=_I32, device=dev)
    adm_rank[adm_order] = idx
    return eligible, adm_rank, demand


def tenant_admission_tiled(
    task_valid: np.ndarray,  # bool[T]
    task_tenant: np.ndarray,  # i32[T]
    task_priority: np.ndarray | None,  # i32[T] (None = all 0)
    tenant_share: np.ndarray,  # f32[N]
    tenant_deficit: np.ndarray,  # f32[N]
    tenant_ahead: np.ndarray,  # i32[N]
    tenant_cap: np.ndarray,  # i32[N]
    tile: int,
    starve_deficit: float = DEFAULT_STARVE_DEFICIT,
    starve_boost: int = DEFAULT_STARVE_BOOST,
):
    """:func:`tenant_fair_admission_impl` as the CUDA kernel's rank branch
    computes it: ``(eligible bool[T], keys u64[T], demand bool[N])``. The
    FCFS rank ``j`` within a tenant comes without a sort of all T: each
    tile of ``tile`` tasks is stably sorted by segment (the tenant row, N
    for an invalid task) on its own, each tenant's counts are scanned over
    the tiles, and ``j`` is the tenant's offset plus the position in the
    tile's run. Each eligible task's key is ``int_key(-eff_prio)`` in the
    high word and ``float_key(v)`` in the low one, with ``v`` rounded as
    the plain version rounds it; ``NO_KEY`` on the others. The admission
    order is those keys with the index as the stable tie, so the first
    ``n_slots`` of it are ``greedy.admit_select(keys, eligible, n_slots,
    ...)``."""
    T = task_valid.shape[0]
    N = tenant_share.shape[0]
    g = np.clip(task_tenant, 0, N - 1)
    seg = np.where(task_valid, g, N)
    j = np.zeros(T, np.int64)
    n_tiles = -(-T // tile)
    count = np.zeros((N + 1, n_tiles), np.int64)
    first = np.zeros((N + 1, n_tiles), np.int64)
    runs = []
    for b in range(n_tiles):
        lo = b * tile
        order = lo + np.argsort(seg[lo : lo + tile], kind="stable")
        s = seg[order]
        start = np.flatnonzero(np.r_[True, s[1:] != s[:-1]])
        count[s[start], b] = np.diff(np.r_[start, s.size])
        first[s[start], b] = start
        runs.append((order, s))
    offset = np.cumsum(count, axis=1) - count
    for b, (order, s) in enumerate(runs):
        pos = np.arange(s.size)
        j[order] = offset[s, b] + pos - first[s, b]
    ahead = tenant_ahead.astype(np.int64)
    cap = tenant_cap.astype(np.int64)
    wrapped = (cap - ahead + 2**31) % 2**32 - 2**31  # int32 arithmetic
    allowance = np.where(cap > 0, np.maximum(wrapped, 0), T)
    eligible = task_valid & (j < allowance[g])
    demand = np.zeros(N, bool)
    demand[g[eligible]] = True
    share = np.maximum(tenant_share, np.float32(1e-6))
    v = ((j.astype(np.float32) + np.float32(1.0)) - tenant_deficit[g]) / share[g]
    prio = (np.zeros(T, np.int64) if task_priority is None
            else task_priority.astype(np.int64))
    boost = np.where(tenant_deficit[g] >= np.float32(starve_deficit),
                     starve_boost, 0)
    neg = (-(prio + boost) + 2**31) % 2**32 - 2**31  # int32 arithmetic
    keys = ((int_key(neg.astype(np.int32)).astype(np.uint64) << np.uint64(32))
            | float_key(v.astype(np.float32)).astype(np.uint64))
    return eligible, np.where(eligible, keys, np.uint64(NO_KEY)), demand


def share_sum(w: torch.Tensor) -> torch.Tensor:
    """``w.sum()`` as ONE float64 running sum in index order, rounded once
    to float32: the order kernel B1 sums in. Summed on the host (a read back
    of N floats when ``w`` lies on the card)."""
    acc = 0.0
    for x in w.tolist():  # faas: allow(trace.host-sync) the deficit's share sum: one float64 sum on the host in index order (B1's order)
        acc += x
    return torch.tensor(np.float32(acc), device=w.device)  # faas: allow(trace.host-sync) the share sum copied back up, once a tick


def tenant_deficit_update_impl(
    assignment: torch.Tensor,  # i32[T] worker per task, -1 = stayed queued
    task_tenant: torch.Tensor,  # i32[T]
    demand: torch.Tensor,  # bool[N] from the admission pass
    tenant_share: torch.Tensor,  # f32[N]
    tenant_deficit: torch.Tensor,  # f32[N] carried in
    deficit_cap: float = DEFAULT_DEFICIT_CAP,
) -> torch.Tensor:
    """The post-placement deficit carry: each backlogged tenant is entitled
    to its share-weighted fraction (over backlogged tenants only) of the
    placements the tick made; under-service accumulates, service repays
    it, a tenant with no eligible work resets. Clamped to
    ``[0, deficit_cap]``."""
    N = tenant_share.shape[0]
    dev = tenant_share.device
    t = task_tenant.to(_I32).clamp(0, N - 1)
    placed = scatter_add(torch.zeros(N, dtype=torch.float32, device=dev),
                         torch.where(assignment >= 0, t, N).long(), 1.0)
    total = placed.sum()  # integer-valued: exact in any order
    w = torch.where(demand, tenant_share.clamp_min(_f32(1e-6)), 0.0)
    entitled = w / share_sum(w).clamp_min(_f32(1e-9)) * total
    new = (tenant_deficit + entitled - placed).clamp(0.0, _f32(deficit_cap))
    return torch.where(demand, new, 0.0)
