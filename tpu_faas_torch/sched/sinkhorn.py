"""Entropic optimal-transport placement (log-domain Sinkhorn), in PyTorch.

Counterpart of ``tpu_faas/sched/sinkhorn.py``, under its names. One tick's
placement is a transport problem: each valid pending task supplies one unit,
each live worker demands up to its free capacity, cost is size/speed. A
slack column absorbs tasks beyond total capacity and a slack row absorbs
unused capacity, so the problem is always balanced and of one static shape.
The soft plan is rounded to an integral assignment: per-task argmax, a
capacity repair (one lexsort plus a segment rank keeps each worker's top-c
tasks by plan mass) and a rank spill of the rest over the remaining
capacity.

Three solvers: dense (:func:`sinkhorn_placement_impl`, the [T+1, W+1]
problem), streamed (:func:`sinkhorn_placement_streamed`, task chunks with an
online column logsumexp) and bucketed (:func:`sinkhorn_placement_bucketed_impl`,
sizes quantized onto K log-spaced classes, so the iterations run on
[K+1, W+1]). The scheduler tick takes the bucketed one with bucket rounding
when ``T * W > 2**24`` and the dense one below; on the card the resident
tick runs either inside one launch of ``csrc/fused_tick.cu``, for which the
functions here are the plain version.

Parity rules: the logsumexp is spelled as JAX 0.9 spells it (max, a
non-finite max replaced by 0, ``log(sum(exp(x - m))) + m``), never
``torch.logsumexp``, so that the CUDA kernel can follow it op by op; the
lexsort is two stable argsorts, the secondary key first; ``associative_scan
(maximum)`` is ``cummax``. The dense and bucketed solvers take the final
potentials as a keyword (``potentials=(f, g)``, skipping the iterations)
and return them, so that a rounding can be replayed from the kernel's own
potentials.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tpu_faas_torch.sched.greedy import rank_match_placement_impl
from tpu_faas_torch.sched.scatter import f32_to_i32

_I32 = torch.int32
_INF = float("inf")
_LOG2E = 1.4426950408889634
_LN2 = 0.6931471805599453
#: the temperature the scheduler tick solves at, relative to the cost scale
TAU = 0.05


class SinkhornResult(NamedTuple):
    assignment: torch.Tensor  # i32[T] worker per task, -1 = stay queued
    plan: torch.Tensor  # f32[T+1, W+1] soft transport plan (incl. slack)
    marginal_err: torch.Tensor  # f32 scalar: max row-marginal violation
    #: f32[R] final row potentials of the iterated problem (dense and
    #: bucketed; None from the streamed solver)
    f: torch.Tensor | None = None
    #: f32[W+1] final column potentials, slack column last
    g: torch.Tensor | None = None
    #: f32 scalar: the effective temperature (tau times the cost scale)
    tau: torch.Tensor | None = None


def _logsumexp(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``jax.nn.logsumexp`` as JAX 0.9 computes it."""
    m = x.amax(dim=dim)
    m = torch.where(torch.isfinite(m), m, 0.0)
    return torch.log(torch.sum(torch.exp(x - m.unsqueeze(dim)), dim=dim)) + m


def _log_marginal(a: torch.Tensor) -> torch.Tensor:
    return torch.where(a > 0, torch.log(a.clamp_min(1e-30)), -_INF)


def _capacity(worker_free, worker_live, max_slots):
    """Per-worker capacity this tick (i32; negative free counts stay)."""
    return torch.where(worker_live, worker_free.clamp(max=max_slots), 0)


def sinkhorn_placement_impl(
    task_size: torch.Tensor,  # f32[T]
    task_valid: torch.Tensor,  # bool[T]
    worker_speed: torch.Tensor,  # f32[W]
    worker_free: torch.Tensor,  # i32[W]
    worker_live: torch.Tensor,  # bool[W]
    tau: float = TAU,
    n_iters: int = 60,
    max_slots: int = 8,
    *,
    potentials: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> SinkhornResult:
    T = task_size.shape[0]
    loga, logb, neg_c_over_tau, tau_eff = _dense_problem(
        task_size, task_valid, worker_speed, worker_free, worker_live, tau,
        max_slots,
    )
    if potentials is None:
        f, g = _sinkhorn_fg(loga, logb, neg_c_over_tau, tau_eff, n_iters)
    else:
        f, g = potentials

    logp = neg_c_over_tau + (f[:, None] + g[None, :]) / tau_eff
    plan = torch.exp(logp)
    row_sums = plan[:T, :].sum(dim=1)
    marginal_err = torch.where(task_valid, (row_sums - 1.0).abs(), 0.0).max()

    assignment = round_plan(
        plan[:T], task_size, task_valid, worker_speed, worker_free,
        worker_live, max_slots,
    )
    return SinkhornResult(assignment, plan, marginal_err, f, g, tau_eff)


def _dense_problem(task_size, task_valid, worker_speed, worker_free,
                   worker_live, tau, max_slots):
    """The dense solver's balanced [T+1, W+1] problem: (loga, logb,
    -cost/tau, tau_eff)."""
    T = task_size.shape[0]
    W = worker_speed.shape[0]
    dev = task_size.device

    cap = _capacity(worker_free, worker_live, max_slots).to(torch.float32)
    n_tasks = task_valid.sum().to(torch.float32)
    total_cap = cap.sum()

    # row T = slack supply (absorbs unused capacity), col W = slack demand
    # (absorbs unplaceable tasks)
    a = torch.cat([task_valid.to(torch.float32),
                   (total_cap - n_tasks).clamp_min(0.0)[None]])
    b = torch.cat([cap, (n_tasks - total_cap).clamp_min(0.0)[None]])

    speed_safe = worker_speed.clamp_min(1e-6)
    cost_real = task_size[:, None] / speed_safe[None, :]  # [T, W]
    finite_mask = task_valid[:, None] & (cap[None, :] > 0)
    cmax = torch.where(finite_mask, cost_real, 0.0).max()
    slack_cost = cmax + 1.0  # tasks go to slack only when no capacity remains
    # tau is RELATIVE to the cost scale: smoothing behaves alike across size
    # units
    tau_eff = tau * cmax.clamp_min(1e-30)

    cost = torch.zeros((T + 1, W + 1), dtype=torch.float32, device=dev)
    cost[:T, :W] = torch.where(finite_mask, cost_real, _INF)
    cost[:T, W] = torch.where(task_valid, slack_cost, _INF)
    cost[T, :W] = torch.where(cap > 0, 0.0, _INF)
    cost[T, W] = _INF  # slack-to-slack forbidden
    neg_c_over_tau = -cost / tau_eff  # -inf where forbidden
    return _log_marginal(a), _log_marginal(b), neg_c_over_tau, tau_eff


def _sinkhorn_fg(
    loga: torch.Tensor,  # f32[R] log row supplies (-inf = absent row)
    logb: torch.Tensor,  # f32[C] log col demands (-inf = absent col)
    neg_c_over_tau: torch.Tensor,  # f32[R, C], -inf where forbidden
    tau,
    n_iters: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Alternating log-domain Sinkhorn updates on a dense (small) problem.
    Shared by the exact kernel (rows = tasks) and the bucketed kernel
    (rows = quantized size classes with weighted supplies)."""
    f = torch.zeros(loga.shape[0], dtype=torch.float32, device=loga.device)
    g = torch.zeros(logb.shape[0], dtype=torch.float32, device=logb.device)
    row_ok = torch.isfinite(loga)
    col_ok = torch.isfinite(logb)
    for _ in range(n_iters):
        # f-update: rows hit their supply
        f = tau * (loga - _logsumexp(neg_c_over_tau + g[None, :] / tau, 1))
        f = torch.where(row_ok, f, -_INF)
        # g-update: cols hit their demand
        g = tau * (logb - _logsumexp(neg_c_over_tau + f[:, None] / tau, 0))
        g = torch.where(col_ok, g, -_INF)
    return f, g


def round_plan(
    plan: torch.Tensor,  # f32[T, W+1] soft plan incl. slack column
    task_size: torch.Tensor,
    task_valid: torch.Tensor,
    worker_speed: torch.Tensor,
    worker_free: torch.Tensor,
    worker_live: torch.Tensor,
    max_slots: int,
) -> torch.Tensor:
    """Round a soft transport plan to an integral assignment: per-task
    argmax over real workers (a task whose slack mass dominates stays
    queued), then :func:`_repair_candidates`."""
    W = worker_speed.shape[0]
    real_plan = plan[:, :W]
    best_p, best_w = real_plan.max(dim=1)  # first index on a tie
    to_slack = plan[:, W] >= best_p  # slack got more mass than any worker
    return _repair_candidates(
        best_w.to(_I32), best_p, to_slack, task_size, task_valid,
        worker_speed, worker_free, worker_live, max_slots,
    )


def _repair_candidates(
    best_w: torch.Tensor,  # i32[T] argmax worker per task
    best_p: torch.Tensor,  # f32[T] its plan mass
    to_slack: torch.Tensor,  # bool[T] slack outweighed every worker
    task_size: torch.Tensor,
    task_valid: torch.Tensor,
    worker_speed: torch.Tensor,
    worker_free: torch.Tensor,
    worker_live: torch.Tensor,
    max_slots: int,
) -> torch.Tensor:
    """Capacity repair + spill over per-task argmax candidates (the O(T)
    tail of plan rounding — everything after the T×W reduction)."""
    T = task_valid.shape[0]
    W = worker_speed.shape[0]
    dev = task_valid.device
    cand = torch.where(task_valid & ~to_slack, best_w, -1)

    key_worker = torch.where(cand >= 0, cand, W).to(_I32)
    # lexsort((-best_p, key_worker)): the secondary key first, then a stable
    # sort by the primary
    order = torch.argsort(-best_p, stable=True)
    order = order[torch.argsort(key_worker[order], stable=True)]
    sorted_w = key_worker[order]
    idx = torch.arange(T, dtype=_I32, device=dev)
    seg_start = torch.ones(T, dtype=torch.bool, device=dev)
    seg_start[1:] = sorted_w[1:] != sorted_w[:-1]
    start_idx = torch.where(seg_start, idx, 0)
    first = torch.cummax(start_idx, 0).values
    rank = idx - first
    cap_i = _capacity(worker_free, worker_live, max_slots).to(_I32)
    keep = (sorted_w < W) & (rank < cap_i[sorted_w.clamp(0, W - 1).long()])
    assignment = torch.full((T,), -1, dtype=_I32, device=dev)
    assignment[order] = torch.where(keep, sorted_w, -1).to(_I32)

    used = torch.zeros(W, dtype=_I32, device=dev).index_add_(
        0, assignment.clamp(min=0).long(), (assignment >= 0).to(_I32)
    )
    remaining = (cap_i - used).clamp_min(0)
    spilled = task_valid & (assignment < 0)
    spill_assignment = rank_match_placement_impl(
        task_size, spilled, worker_speed, remaining, worker_live,
        max_slots=max_slots,
    )
    return torch.where(assignment >= 0, assignment, spill_assignment)


def _lse_fold(x2: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One chunk's fold of base-2 cells along the last dim, as the CUDA
    kernel's lanes keep it: (m, s) with m the largest non-NaN cell (-inf
    when there is none) and s the sum of 2^(x - fin0(m)) (a NaN cell makes
    it NaN); fin0 is JAX's replacement of a non-finite max by 0."""
    m = torch.where(torch.isnan(x2), -_INF, x2).amax(dim=-1)
    mh = torch.where(torch.isfinite(m), m, 0.0)
    return m, torch.exp2(x2 - mh.unsqueeze(-1)).sum(dim=-1)


def _lse_merge(a, b):
    """The kernel's merge of two folds over disjoint cells
    (``csrc/fused_tick.cu::lse_merge``): both sums rescaled to the larger
    max; an empty sum stays 0, so 2^(-inf - -inf) never runs."""
    (ma, sa), (mb, sb) = a, b
    m = torch.maximum(ma, mb)
    mh = torch.where(torch.isfinite(m), m, 0.0)

    def scaled(mx, sx):
        mxh = torch.where(torch.isfinite(mx), mx, 0.0)
        return torch.where(sx == 0, 0.0, sx * torch.exp2(mxh - mh))

    return m, scaled(ma, sa) + scaled(mb, sb)


def split_logsumexp(x: torch.Tensor, bounds: list[int],
                    order: list[int]) -> torch.Tensor:
    """The plain form of the CUDA kernel's logsumexp over the last dim of
    ``x``: the cells in base 2 (x * log2 e), cut at ``bounds`` into chunks,
    each chunk folded (:func:`_lse_fold`) and the folds merged in ``order``
    (:func:`_lse_merge`), then ln(s) + fin0(m) ln 2. It equals
    :func:`_logsumexp` (JAX 0.9's) up to rounding in any cut and order,
    JAX's hazards included: an all -inf row gives -inf, a NaN cell NaN."""
    x2 = x * _LOG2E
    edges = [0, *bounds, x.shape[-1]]
    folds = [_lse_fold(x2[..., lo:hi]) for lo, hi in zip(edges, edges[1:])]
    acc = (torch.full(x.shape[:-1], -_INF, dtype=x.dtype, device=x.device),
           torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device))
    for k in order:
        acc = _lse_merge(acc, folds[k])
    m, ssum = acc
    return torch.log(ssum) + torch.where(torch.isfinite(m), m, 0.0) * _LN2


def repair_compacted(
    best_w: torch.Tensor,  # i32[T] argmax worker per task
    best_p: torch.Tensor,  # f32[T] its plan mass
    to_slack: torch.Tensor,  # bool[T] slack outweighed every worker
    task_size: torch.Tensor,
    task_valid: torch.Tensor,
    worker_speed: torch.Tensor,
    worker_free: torch.Tensor,
    worker_live: torch.Tensor,
    max_slots: int,
) -> torch.Tensor:
    """The CUDA kernel's close, in torch: :func:`_repair_candidates` over
    compacted lists, with the same result. The candidates (valid and not
    to_slack), taken in index order, are the only tasks sorted by (worker,
    -best_p); each worker keeps its first cap. The spill takes the first
    spilled tasks in index order, as many as there are valid slots left,
    sorts only them by -size and pairs them with the valid slots left,
    taken in index order and sorted by -speed. A valid slot whose speed or
    an admitted task whose size is -inf or NaN would sort among the invalid
    ones in rank placement's own sorts, so then the spill is rank placement
    itself."""
    T = task_valid.shape[0]
    W = worker_speed.shape[0]
    K = max_slots
    dev = task_valid.device
    cap_i = _capacity(worker_free, worker_live, max_slots).to(_I32)
    cand = torch.nonzero(task_valid & ~to_slack).flatten()  # index order
    order = cand[torch.argsort(-best_p[cand], stable=True)]
    order = order[torch.argsort(best_w[order].long(), stable=True)]
    sorted_w = best_w[order].long()
    seg_first = torch.zeros(W, dtype=torch.long, device=dev)
    pos = torch.arange(order.numel(), device=dev)
    start = torch.ones_like(pos, dtype=torch.bool)
    start[1:] = sorted_w[1:] != sorted_w[:-1]
    seg_first[sorted_w[start]] = pos[start]
    keep = (pos - seg_first[sorted_w]) < cap_i[sorted_w]
    assignment = torch.full((T,), -1, dtype=_I32, device=dev)
    assignment[order[keep]] = sorted_w[keep].to(_I32)
    used = torch.bincount(sorted_w[keep], minlength=W).to(_I32)
    remaining = (cap_i - used).clamp_min(0)
    spilled = task_valid & (assignment < 0)
    # the valid slots left, in index order: worker w's first remaining[w]
    k = torch.arange(K, dtype=_I32, device=dev)
    slot_ok = (k[None, :] < remaining[:, None]).reshape(W * K)
    slots = torch.nonzero(slot_ok).flatten()
    tasks = torch.nonzero(spilled).flatten()[: slots.numel()]
    speed_s = worker_speed[slots // K]
    size_t = task_size[tasks]
    if bool((~(speed_s > -_INF)).any()) or bool((~(size_t > -_INF)).any()):
        spill = rank_match_placement_impl(
            task_size, spilled, worker_speed, remaining, worker_live,
            max_slots=max_slots,
        )
        return torch.where(assignment >= 0, assignment, spill)
    slots = slots[torch.argsort(-speed_s, stable=True)]
    tasks = tasks[torch.argsort(-size_t, stable=True)]
    n_pairs = min(tasks.numel(), T, W * K)
    assignment[tasks[:n_pairs]] = (slots[:n_pairs] // K).to(_I32)
    return assignment


def _chunk_negc(size_c, valid_c, inv_speed, col_open, slack_cost, tau):
    """[-cost/tau] rows for one task chunk from the rank-one structure,
    forbidden cells -inf; last column is the slack demand. [C, W+1]."""
    negc_real = -(size_c[:, None] * inv_speed[None, :]) / tau
    negc_real = torch.where(valid_c[:, None] & col_open[None, :], negc_real,
                            -_INF)
    negc_slackcol = torch.where(valid_c, -slack_cost / tau, -_INF)
    return torch.cat([negc_real, negc_slackcol[:, None]], dim=1)


def _chunk_candidates(
    size_c, valid_c, inv_speed, col_open, slack_cost, tau, g, f_c=None
):
    """Per-chunk rounding inputs, shared by the streamed and bucketed
    kernels: rebuild this chunk's plan rows from (f, g), extract the
    argmax candidate per task (with the slack >= tie-break), the row
    residual, and the chunk's column-mass contribution. ``f_c=None``
    recovers the exact unit-supply row potential from g."""
    W = inv_speed.shape[0]
    negc = _chunk_negc(size_c, valid_c, inv_speed, col_open, slack_cost, tau)
    z = negc + g[None, :] / tau
    if f_c is None:
        f_c = -tau * _logsumexp(z, 1)
        f_c = torch.where(valid_c, f_c, -_INF)
    plan_c = torch.exp(z + f_c[:, None] / tau)  # [C, W+1]
    best_p, best_w = plan_c[:, :W].max(dim=1)
    to_slack = plan_c[:, W] >= best_p
    row_err = torch.where(valid_c, (plan_c.sum(dim=1) - 1.0).abs(),
                          0.0).max()
    col_sum = plan_c.sum(dim=0)  # invalid rows are exact zeros
    return f_c, (best_w.to(_I32), best_p, to_slack, row_err, col_sum)


def _pad_chunks(task_size, task_valid, chunk):
    """Sizes and valid flags padded with invalid tasks to whole chunks,
    as [n_chunks, chunk]."""
    T = task_size.shape[0]
    n_chunks = -(-T // chunk)
    Tp = n_chunks * chunk
    size_p = task_size.new_zeros(Tp)
    size_p[:T] = task_size
    valid_p = task_valid.new_zeros(Tp)
    valid_p[:T] = task_valid
    return size_p.reshape(n_chunks, chunk), valid_p.reshape(n_chunks, chunk)


def _rank_one_problem(task_size, task_valid, worker_speed, worker_free,
                      worker_live, tau, max_slots, size_max):
    """What the streamed and bucketed solvers share: capacities, inverse
    speeds, open columns, the slack cost (over ``size_max``, the largest
    valid size) and the effective temperature."""
    cap = _capacity(worker_free, worker_live, max_slots).to(torch.float32)
    n_tasks = task_valid.sum().to(torch.float32)
    total_cap = cap.sum()
    speed_safe = worker_speed.clamp_min(1e-6)
    inv_speed = 1.0 / speed_safe
    col_open = cap > 0.0
    # slack cost: strictly above every real cost, from the rank-one
    # structure in O(T + W)
    cmax = size_max * torch.where(col_open, inv_speed, 0.0).max()
    slack_cost = cmax + 1.0
    tau = tau * cmax.clamp_min(1e-30)
    return cap, n_tasks, total_cap, inv_speed, col_open, slack_cost, tau


def sinkhorn_placement_streamed(
    task_size: torch.Tensor,  # f32[T]
    task_valid: torch.Tensor,  # bool[T]
    worker_speed: torch.Tensor,  # f32[W]
    worker_free: torch.Tensor,  # i32[W]
    worker_live: torch.Tensor,  # bool[W]
    tau: float = TAU,
    n_iters: int = 60,
    max_slots: int = 8,
    chunk: int = 4096,
) -> SinkhornResult:
    """Sinkhorn placement that never materializes the [T, W] plan: each
    iteration streams over task chunks, doing the f-update per chunk and
    folding the column logsumexp for the g-update through an online
    (running max, running sum) accumulator; the rounding streams the same
    way, and only the O(T) repair tail sees whole-problem vectors. Its
    ``plan`` is a [0, W+1] placeholder; ``marginal_err`` comes from the
    streamed row sums of the final plan."""
    T = task_size.shape[0]
    W = worker_speed.shape[0]
    dev = task_size.device
    sizes_r, valids_r = _pad_chunks(task_size, task_valid, chunk)

    cap, n_tasks, total_cap, inv_speed, col_open, slack_cost, tau = (
        _rank_one_problem(
            task_size, task_valid, worker_speed, worker_free, worker_live,
            tau, max_slots, torch.where(task_valid, task_size, 0.0).max(),
        )
    )
    a_slack = (total_cap - n_tasks).clamp_min(0.0)  # slack-row supply
    b = torch.cat([cap, (n_tasks - total_cap).clamp_min(0.0)[None]])
    loga_slack = _log_marginal(a_slack)
    logb = _log_marginal(b)
    # slack-row costs: 0 to open workers, forbidden to the slack column
    negc_slackrow = torch.cat([
        torch.where(col_open, 0.0, -_INF),
        torch.full((1,), -_INF, device=dev),
    ])  # [W+1]

    def merge_lse(m, s, m_c, s_c):
        """Online logsumexp accumulator merge (all shapes [W+1])."""
        m_new = torch.maximum(m, m_c)
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        s_new = s * torch.exp(m - m_safe) + s_c * torch.exp(m_c - m_safe)
        return m_new, s_new

    f_r = torch.zeros(sizes_r.shape, dtype=torch.float32, device=dev)
    g = torch.zeros(W + 1, dtype=torch.float32, device=dev)
    for _ in range(n_iters):
        # slack-row f-update first (uses the current g, like every row)
        f_slack = tau * (loga_slack - _logsumexp(negc_slackrow + g / tau, 0))
        f_slack = torch.where(torch.isfinite(loga_slack), f_slack, -_INF)
        m = torch.full((W + 1,), -_INF, device=dev)
        s = torch.zeros(W + 1, device=dev)
        f_new = []
        for size_c, valid_c in zip(sizes_r, valids_r):
            negc = _chunk_negc(size_c, valid_c, inv_speed, col_open,
                               slack_cost, tau)  # [C, W+1]
            # f-update: rows hit their unit supply
            loga_c = torch.where(valid_c, 0.0, -_INF)
            f_c = tau * (loga_c - _logsumexp(negc + g[None, :] / tau, 1))
            f_c = torch.where(valid_c, f_c, -_INF)
            # fold this chunk into the column logsumexp (with NEW f)
            z = negc + f_c[:, None] / tau
            m_c = z.amax(dim=0)
            m_c_safe = torch.where(torch.isfinite(m_c), m_c, 0.0)
            s_c = torch.exp(z - m_c_safe[None, :]).sum(dim=0)
            m, s = merge_lse(m, s, m_c, s_c)
            f_new.append(f_c)
        f_r = torch.stack(f_new)
        # fold the slack row into the column reduction
        m, s = merge_lse(m, s, negc_slackrow + f_slack / tau,
                         torch.ones(W + 1, device=dev))
        lse = torch.where(
            s > 0,
            torch.where(torch.isfinite(m), m, 0.0)
            + torch.log(s.clamp_min(1e-30)),
            -_INF,
        )
        g = tau * (logb - lse)
        g = torch.where(torch.isfinite(logb), g, -_INF)

    # -- streamed rounding: per-task argmax candidates + exact row sums ----
    cands = [
        _chunk_candidates(size_c, valid_c, inv_speed, col_open, slack_cost,
                          tau, g, f_c=f_c)[1]
        for size_c, valid_c, f_c in zip(sizes_r, valids_r, f_r)
    ]
    best_w, best_p, to_slack = (torch.cat([c[i] for c in cands])[:T]
                                for i in range(3))
    assignment = _repair_candidates(
        best_w, best_p, to_slack, task_size, task_valid, worker_speed,
        worker_free, worker_live, max_slots,
    )
    row_err = torch.stack([c[3] for c in cands]).max()
    return SinkhornResult(
        assignment, torch.zeros((0, W + 1), device=dev), row_err
    )


def sinkhorn_placement_bucketed_impl(
    task_size: torch.Tensor,  # f32[T]
    task_valid: torch.Tensor,  # bool[T]
    worker_speed: torch.Tensor,  # f32[W]
    worker_free: torch.Tensor,  # i32[W]
    worker_live: torch.Tensor,  # bool[W]
    tau: float = TAU,
    n_iters: int = 60,
    max_slots: int = 8,
    n_buckets: int = 1024,
    chunk: int = 8192,
    rounding: str = "exact",
    *,
    potentials: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> SinkhornResult:
    """Sinkhorn placement that compresses the task axis before iterating.

    The cost is rank-one (size_t / speed_w), so tasks of equal size are
    identical rows. Sizes are quantized onto ``n_buckets`` log-spaced
    representatives, the iterations run on the [K+1, W+1] problem weighted
    by bucket population, and rounding either recovers exact per-task
    potentials in one streamed pass (``rounding="exact"``) or picks each
    bucket's candidate in one [K, W] pass and gathers it per task
    (``rounding="bucket"``, the live tick's), ranking within a worker by
    the per-task log-mass ``(g[w*] - size * inv[w*]) / tau``."""
    T = task_size.shape[0]
    W = worker_speed.shape[0]
    K = n_buckets
    dev = task_size.device

    # -- log-space size quantization ---------------------------------------
    size_safe = task_size.clamp_min(1e-30)
    logs = torch.log(size_safe)
    lo = torch.where(task_valid, logs, _INF).min()
    hi = torch.where(task_valid, logs, -_INF).max()
    # all-invalid tick: lo/hi stay +/-inf; every downstream quantity is
    # masked by task_valid, so any finite placeholder works
    lo = torch.where(torch.isfinite(lo), lo, 0.0)
    hi = torch.where(torch.isfinite(hi), hi, 1.0)
    span = (hi - lo).clamp_min(1e-9)
    bucket = f32_to_i32((logs - lo) / span * K).clamp(0, K - 1)  # i32[T]
    counts = torch.zeros(K, dtype=torch.float32, device=dev).index_add_(
        0, bucket.long(), task_valid.to(torch.float32)
    )
    rep = torch.exp(
        lo + (torch.arange(K, dtype=torch.float32, device=dev) + 0.5) / K
        * span
    )

    # -- bucketed balanced problem (rows = size classes weighted by
    # population) ----------------------------------------------------------
    cap, n_tasks, total_cap, inv_speed, col_open, slack_cost, tau = (
        _rank_one_problem(
            task_size, task_valid, worker_speed, worker_free, worker_live,
            tau, max_slots, torch.where(task_valid, size_safe, 0.0).max(),
        )
    )
    row_open = counts > 0.0
    cost_b = rep[:, None] * inv_speed[None, :]  # [K, W]
    negc = torch.full((K + 1, W + 1), -_INF, dtype=torch.float32, device=dev)
    negc[:K, :W] = torch.where(row_open[:, None] & col_open[None, :],
                               -cost_b / tau, -_INF)
    negc[:K, W] = torch.where(row_open, -slack_cost / tau, -_INF)
    negc[K, :W] = torch.where(col_open, 0.0, -_INF)

    a = torch.cat([counts, (total_cap - n_tasks).clamp_min(0.0)[None]])
    b = torch.cat([cap, (n_tasks - total_cap).clamp_min(0.0)[None]])
    loga = _log_marginal(a)
    logb = _log_marginal(b)

    if potentials is None:
        f_b, g = _sinkhorn_fg(loga, logb, negc, tau, n_iters)
    else:
        f_b, g = potentials

    if rounding == "bucket":
        # -- bucket-level rounding: no T x W pass at all -------------------
        z_b = negc[:K, :W] + g[None, :W] / tau  # negc already -cost/tau
        best_z_b, best_w_b = z_b.max(dim=1)  # first index on a tie
        to_slack_b = (negc[:K, W] + g[W] / tau) >= best_z_b
        bl = bucket.long()
        w_star = best_w_b[bl].to(_I32)  # [T]
        ws = w_star.long()
        best_p = (g[ws] - size_safe * inv_speed[ws.clamp(0, W - 1)]) / tau
        assignment = _repair_candidates(
            w_star, best_p, to_slack_b[bl] | ~task_valid, task_size,
            task_valid, worker_speed, worker_free, worker_live, max_slots,
        )
        # column residual from the bucket plan itself (rows weighted by
        # population through f_b, which solved against log(counts))
        plan_b = torch.exp(negc + (f_b[:, None] + g[None, :]) / tau)
        col_total = plan_b.sum(dim=0)
        col_err = torch.where(b > 0, (col_total - b).abs() / b.clamp_min(1.0),
                              0.0).max()
        return SinkhornResult(
            assignment, torch.zeros((0, W + 1), device=dev), col_err, f_b, g,
            tau,
        )

    # -- streamed per-task recovery + candidates ---------------------------
    sizes_r, valids_r = _pad_chunks(task_size, task_valid, chunk)
    cands = [
        _chunk_candidates(size_c, valid_c, inv_speed, col_open, slack_cost,
                          tau, g, f_c=None)[1]  # f recovered exactly from g
        for size_c, valid_c in zip(sizes_r, valids_r)
    ]
    best_w, best_p, to_slack = (torch.cat([c[i] for c in cands])[:T]
                                for i in range(3))
    assignment = _repair_candidates(
        best_w, best_p, to_slack, task_size, task_valid, worker_speed,
        worker_free, worker_live, max_slots,
    )
    # Convergence metric: the COLUMN residual, with the slack ROW's mass
    # folded in (it carries the leftover column mass under excess capacity)
    slack_row_mass = torch.exp(negc[K] + (f_b[K] + g) / tau)  # [W+1]
    col_total = torch.stack([c[4] for c in cands]).sum(dim=0) + slack_row_mass
    col_err = torch.where(b > 0, (col_total - b).abs() / b.clamp_min(1.0),
                          0.0).max()
    return SinkhornResult(
        assignment, torch.zeros((0, W + 1), device=dev), col_err, f_b, g, tau
    )
