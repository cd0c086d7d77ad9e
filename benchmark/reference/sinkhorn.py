"""The resident Sinkhorn tick's placement, in plain PyTorch (float32).

The rule is the scheduler's documented Sinkhorn placement for large
problems (``max_pending * max_workers > 2**24``): each valid pending task
supplies one unit, each live worker demands ``min(free, max_slots)``, the
cost is size/speed, and a slack row and column balance the problem. The
task sizes are quantized onto 1,024 log-spaced buckets (representative
``exp(lo + (b + 0.5)/1024 * (hi - lo))``), the log-domain iterations run 20
times on the [1,025, W+1] problem at temperature 0.05 times the largest
real cost, with logsumexp spelled as max, non-finite max replaced by 0,
``log(sum(exp(x - max))) + max``. Rounding: each bucket's best worker by
``-cost/tau + g/tau`` (slack if the slack column is at least as good),
each task takes its bucket's worker ranked by ``(g - size/speed)/tau``,
each worker keeps its first ``capacity`` tasks in that rank (ties by task
index), and the tasks left over are placed by rank matching (largest to
fastest slot) on the capacity left.

:func:`solve` runs the iterations; :func:`round_from` rounds from given
potentials, which is how a tick of the program is judged: its potentials
against this module's from the same state, and its placements against
this module's rounding of its own potentials.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

TAU = 0.05
N_ITERS = 20
N_BUCKETS = 1024
_INF = float("inf")
_I32 = torch.int32


def bucketed(T: int, W: int) -> bool:
    """Whether the scheduler takes the bucketed route at this shape."""
    return T * W > 2**24


class Problem(NamedTuple):
    bucket: torch.Tensor  # i32[T]
    size_safe: torch.Tensor  # f32[T]
    inv_speed: torch.Tensor  # f32[W]
    negc: torch.Tensor  # f32[K+1, W+1]
    loga: torch.Tensor  # f32[K+1]
    logb: torch.Tensor  # f32[W+1]
    tau: torch.Tensor  # f32 scalar


def _f32_to_i32(x: torch.Tensor) -> torch.Tensor:
    """Truncation toward zero, saturating, NaN to 0 (CUDA's rz)."""
    i = x.clamp(-(2.0**31), 2147483520.0).to(_I32)
    i = torch.where(x >= 2.0**31, 2**31 - 1, i)
    return torch.where(torch.isnan(x), 0, i).to(_I32)


def _logsumexp(x: torch.Tensor, dim: int) -> torch.Tensor:
    m = x.amax(dim=dim)
    m = torch.where(torch.isfinite(m), m, 0.0)
    return torch.log(torch.sum(torch.exp(x - m.unsqueeze(dim)), dim=dim)) + m


def _log_marginal(a: torch.Tensor) -> torch.Tensor:
    return torch.where(a > 0, torch.log(a.clamp_min(1e-30)), -_INF)


def capacity(free: torch.Tensor, live: torch.Tensor, max_slots: int
             ) -> torch.Tensor:
    return torch.where(live, free.clamp(max=max_slots), 0)


def problem(size, valid, speed, free, live, max_slots) -> Problem:
    """The bucketed balanced problem of one tick."""
    W, K = speed.shape[0], N_BUCKETS
    dev = size.device
    size_safe = size.clamp_min(1e-30)
    logs = torch.log(size_safe)
    lo = torch.where(valid, logs, _INF).min()
    hi = torch.where(valid, logs, -_INF).max()
    lo = torch.where(torch.isfinite(lo), lo, 0.0)
    hi = torch.where(torch.isfinite(hi), hi, 1.0)
    span = (hi - lo).clamp_min(1e-9)
    bucket = _f32_to_i32((logs - lo) / span * K).clamp(0, K - 1)
    counts = torch.zeros(K, dtype=torch.float32, device=dev).index_add_(
        0, bucket.long(), valid.to(torch.float32))
    rep = torch.exp(
        lo + (torch.arange(K, dtype=torch.float32, device=dev) + 0.5) / K
        * span)
    cap = capacity(free, live, max_slots).to(torch.float32)
    n_tasks = valid.sum().to(torch.float32)
    total_cap = cap.sum()
    inv_speed = 1.0 / speed.clamp_min(1e-6)
    col_open = cap > 0.0
    size_max = torch.where(valid, size_safe, 0.0).max()
    cmax = size_max * torch.where(col_open, inv_speed, 0.0).max()
    slack_cost = cmax + 1.0
    tau_eff = TAU * cmax.clamp_min(1e-30)
    row_open = counts > 0.0
    cost_b = rep[:, None] * inv_speed[None, :]
    negc = torch.full((K + 1, W + 1), -_INF, dtype=torch.float32,
                      device=dev)
    negc[:K, :W] = torch.where(row_open[:, None] & col_open[None, :],
                               -cost_b / tau_eff, -_INF)
    negc[:K, W] = torch.where(row_open, -slack_cost / tau_eff, -_INF)
    negc[K, :W] = torch.where(col_open, 0.0, -_INF)
    a = torch.cat([counts, (total_cap - n_tasks).clamp_min(0.0)[None]])
    b = torch.cat([cap, (n_tasks - total_cap).clamp_min(0.0)[None]])
    return Problem(bucket, size_safe, inv_speed, negc,
                   _log_marginal(a), _log_marginal(b), tau_eff)


def solve(pb: Problem):
    """The final potentials (f over buckets + slack, g over workers +
    slack)."""
    tau = pb.tau
    f = torch.zeros(pb.loga.shape[0], dtype=torch.float32,
                    device=pb.loga.device)
    g = torch.zeros(pb.logb.shape[0], dtype=torch.float32,
                    device=pb.logb.device)
    row_ok, col_ok = torch.isfinite(pb.loga), torch.isfinite(pb.logb)
    for _ in range(N_ITERS):
        f = tau * (pb.loga - _logsumexp(pb.negc + g[None, :] / tau, 1))
        f = torch.where(row_ok, f, -_INF)
        g = tau * (pb.logb - _logsumexp(pb.negc + f[:, None] / tau, 0))
        g = torch.where(col_ok, g, -_INF)
    return f, g


def rank_match(size, valid, speed, free, live, max_slots):
    """Rank matching: live workers' free slots fastest first (ties by
    slot index), the first valid tasks in index order admitted up to the
    slot count, largest first (ties by index), paired rank for rank."""
    T, W = size.shape[0], speed.shape[0]
    S = W * max_slots
    dev = size.device
    fr = torch.where(live, free.to(_I32), 0)
    k = torch.arange(max_slots, dtype=_I32, device=dev)
    slot_valid = (k[None, :] < fr[:, None]).reshape(S)
    slot_worker = torch.arange(W, dtype=_I32, device=dev
                               ).repeat_interleave(max_slots)
    slot_speed = torch.where(
        slot_valid, speed[:, None].expand(W, max_slots).reshape(S), -_INF)
    slot_worker_sorted = slot_worker[torch.argsort(-slot_speed, stable=True)]
    n_slots = slot_valid.sum(dtype=_I32)
    rank = torch.cumsum(valid.to(_I32), 0, dtype=_I32) - 1
    admitted = valid & (rank < n_slots)
    task_order = torch.argsort(-torch.where(admitted, size, -_INF),
                               stable=True)
    L = min(T, S)
    n_pairs = torch.minimum(n_slots, admitted.sum(dtype=_I32))
    ok = torch.arange(L, dtype=_I32, device=dev) < n_pairs
    out = torch.full((T,), -1, dtype=_I32, device=dev)
    out[task_order[:L]] = torch.where(ok, slot_worker_sorted[:L],
                                      -1).to(_I32)
    return out


def round_from(pb: Problem, g, size, valid, speed, free, live,
               max_slots) -> torch.Tensor:
    """The assignment (worker per pending slot, -1 queued) that final
    potentials round to (the bucket rounding reads the column potentials
    g alone)."""
    T, W = size.shape[0], speed.shape[0]
    K = pb.negc.shape[0] - 1
    tau = pb.tau
    dev = size.device
    z_b = pb.negc[:K, :W] + g[None, :W] / tau
    best_z_b, best_w_b = z_b.max(dim=1)  # the first on a tie
    to_slack_b = (pb.negc[:K, W] + g[W] / tau) >= best_z_b
    bl = pb.bucket.long()
    w_star = best_w_b[bl].to(_I32)
    ws = w_star.long()
    best_p = (g[ws] - pb.size_safe * pb.inv_speed[ws.clamp(0, W - 1)]) / tau
    to_slack = to_slack_b[bl] | ~valid
    # each worker keeps its first cap candidates by (worker, -mass, index)
    cand = torch.where(valid & ~to_slack, w_star, -1)
    key_w = torch.where(cand >= 0, cand, W).to(_I32)
    order = torch.argsort(-best_p, stable=True)
    order = order[torch.argsort(key_w[order], stable=True)]
    sorted_w = key_w[order]
    idx = torch.arange(T, dtype=_I32, device=dev)
    start = torch.ones(T, dtype=torch.bool, device=dev)
    start[1:] = sorted_w[1:] != sorted_w[:-1]
    first = torch.cummax(torch.where(start, idx, 0), 0).values
    cap_i = capacity(free, live, max_slots).to(_I32)
    keep = (sorted_w < W) & (idx - first < cap_i[sorted_w.clamp(0, W - 1)
                                                  .long()])
    assignment = torch.full((T,), -1, dtype=_I32, device=dev)
    assignment[order] = torch.where(keep, sorted_w, -1).to(_I32)
    used = torch.zeros(W, dtype=_I32, device=dev).index_add_(
        0, assignment.clamp(min=0).long(), (assignment >= 0).to(_I32))
    remaining = (cap_i - used).clamp_min(0)
    spill = rank_match(size, valid & (assignment < 0), speed, remaining,
                       live, max_slots)
    return torch.where(assignment >= 0, assignment, spill)
