"""Sharded scheduler functions over a mesh of positions.

Counterpart of ``tpu_faas/parallel/mesh.py``. The pending-task axis is
sharded over the mesh (the "tasks" axis); the worker-fleet arrays, a few KB,
are replicated.

A mesh is an ordered list of positions, each a (process rank, device) pair:
JAX's multi-controller model of processes x local devices. A process holds
its own positions' shards of a task-axis array as a list of tensors, one a
position, and the collectives are functions over such lists: :func:`psum`
and :func:`pmax` reduce in position order, :func:`ppermute` shifts the ring
by one hop, :func:`all_gather` concatenates in position order. In one
process they are list operations and need no process group; across
processes (``parallel/distributed.py``) they go through ``torch.distributed``
(through host memory under gloo). Every process then holds the same bits.

JAX writes these paths in two ways, and so does the port:

- the explicit ``shard_map`` bodies stay sharded: the Sinkhorn f/g
  iterations (:func:`sharded_sinkhorn_placement`; its column logsumexp is
  a ``pmax`` and a ``psum`` over positions) and the auction's bidding rounds
  (:func:`sharded_auction_placement`: each position bids its shard with
  kernel B2, ``bid_top2`` with the global ``row_offset``, and
  :func:`ring_winner_resolve` combines the per-slot winners around the
  ring). Each position computes on its own shard and talks to the others
  only through the collectives;
- what JAX leaves to GSPMD, whose partitioner gathers a sort along the
  sharded axis, is :func:`all_gather` and then the port's single-device
  function: the rank placement, the single-device auction
  (``winner_resolve="gspmd"``), the rounding after the sharded Sinkhorn and
  the auction's rank spill. Their results are the single-device function's.

Outputs come back whole, on the process's first position's device, and the
same in every process: what JAX's ``process_allgather`` of a sharded result
would give.
"""

from __future__ import annotations

from collections.abc import Sequence

import numpy as np
import torch
import torch.distributed as dist

from tpu_faas_torch.device import resolve_device
from tpu_faas_torch.parallel import distributed
from tpu_faas_torch.sched.auction import (
    AuctionResult,
    _expand_and_square,
    _rank_dual_seed,
    _rank_spill_close,
    _rebase,
    auction_placement_impl,
    bid_scalars,
)
from tpu_faas_torch.sched.bid import bid_top2
from tpu_faas_torch.sched.greedy import rank_match_placement_impl
from tpu_faas_torch.sched.sinkhorn import _logsumexp, round_plan
from tpu_faas_torch.sched.state import TickOutput

TASK_AXIS = "tasks"
_I32 = torch.int32
_INF = float("inf")
#: the ring's "no bidder" task id
BIG = 2**30


def have_shard_map() -> bool:
    """JAX's capability probe for its sharded kernels; the port's shard
    bodies need nothing of a compiler, so always True."""
    return True


class Mesh:
    """An ordered list of positions, each a (process rank, device) pair.
    ``devices`` are this process's positions, in mesh order; ``lead`` is the
    first of them, where whole results land."""

    def __init__(self, positions: Sequence[tuple[int, torch.device]],
                 rank: int = 0) -> None:
        self.positions = tuple((int(r), torch.device(d))
                               for r, d in positions)
        self.rank = rank
        self.local = [i for i, (r, _) in enumerate(self.positions)
                      if r == rank]
        self.devices = [self.positions[i][1] for i in self.local]
        self.lead = self.devices[0]
        self.n_procs = max(r for r, _ in self.positions) + 1
        self.backend = dist.get_backend() if self.n_procs > 1 else None

    @property
    def size(self) -> int:
        return len(self.positions)

    @property
    def shape(self) -> dict[str, int]:
        return {TASK_AXIS: self.size}

    def __repr__(self) -> str:
        return (f"Mesh({[f'{r}:{d}' for r, d in self.positions]}, "
                f"rank={self.rank})")


def make_mesh(n_devices: int | None = None,
              device: str | torch.device = "cuda",
              devices: Sequence[str | torch.device] | None = None) -> Mesh:
    """The mesh of ``n_devices`` positions.

    - In a multi-process run, every process's positions, in rank order
      (``n_devices``, when given, must be their count).
    - ``devices``: exactly these, in this order; several positions may name
      one card.
    - On ``cuda``: ``n_devices`` distinct cards, and fewer present is an
      error (a mesh silently on fewer chips than asked for is a
      misconfiguration, not a fallback).
    - On ``cpu``: ``n_devices`` positions on the host (by default, the
      ``cpu_devices_per_process`` this process was given, else 1)."""
    if distributed.is_multiprocess():
        mine = distributed.local_devices(device)
        everyone: list = [None] * distributed.process_count()
        dist.all_gather_object(everyone, [str(d) for d in mine])
        if len({len(d) for d in everyone}) != 1:
            raise ValueError(
                f"every process must hold as many positions: {everyone}")
        positions = [(r, d) for r, devs in enumerate(everyone) for d in devs]
        if n_devices is not None and n_devices != len(positions):
            raise ValueError(
                f"mesh_devices={n_devices} but the process group holds "
                f"{len(positions)} positions; a multi-process mesh spans "
                "all of them")
        return Mesh(positions, distributed.process_index())
    if devices is not None:
        devs = [torch.device(d) for d in devices]
        if n_devices is not None and n_devices != len(devs):
            raise ValueError(f"mesh_devices={n_devices} but {len(devs)} "
                             "devices were named")
        return Mesh([(0, d) for d in devs])
    dev = resolve_device(device)
    if dev.type == "cuda":
        count = torch.cuda.device_count()
        n = count if n_devices is None else n_devices
        if n > count:
            raise ValueError(
                f"mesh_devices={n} but only {count} CUDA devices are "
                "available")
        return Mesh([(0, torch.device("cuda", i)) for i in range(n)])
    # on the host: the positions initialize_multihost's
    # cpu_devices_per_process gave this process (1 by default)
    n = n_devices or len(distributed.local_devices(dev))
    return Mesh([(0, dev)] * n)


# -- collectives over a process's list of positions --------------------------
def _wire(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """What a collective sends: gloo takes CPU tensors only (the staging
    copy through host memory), and bool travels as uint8."""
    if t.dtype == torch.bool:
        t = t.to(torch.uint8)
    if mesh.backend == "gloo":
        return t.cpu()  # faas: allow(trace.host-sync) gloo takes CPU tensors: a collective on gloo stages through host memory
    return t.to(mesh.lead)


def _every_position(mesh: Mesh, xs: Sequence[torch.Tensor]
                    ) -> list[torch.Tensor]:
    """The values of all positions, in position order: this process's list
    as it is, or every process's gathered."""
    if mesh.n_procs == 1:
        return list(xs)
    dtype = xs[0].dtype
    mine = _wire(mesh, torch.stack([x.to(mesh.lead) for x in xs]))
    parts = [torch.empty_like(mine) for _ in range(mesh.n_procs)]
    dist.all_gather(parts, mine.contiguous())
    return [v.to(dtype) for p in parts for v in p.unbind(0)]


def _reduce(mesh: Mesh, xs, op) -> list[torch.Tensor]:
    vals = _every_position(mesh, xs)
    acc = vals[0].to(mesh.lead)
    for v in vals[1:]:
        acc = op(acc, v.to(mesh.lead))
    return [acc.to(d) for d in mesh.devices]


def psum(mesh: Mesh, xs: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """The sum over positions, added in position order; every position
    gets it."""
    return _reduce(mesh, xs, torch.add)


def pmax(mesh: Mesh, xs: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """The elementwise maximum over positions (a NaN propagates)."""
    return _reduce(mesh, xs, torch.maximum)


def ppermute(mesh: Mesh, xs: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """One hop right around the ring: position i receives position i-1's
    value (position 0 the last one's). Across processes each sends its
    last position's value to the next process and receives its first
    position's from the one before."""
    n_local = len(xs)
    if mesh.n_procs == 1:
        src = [xs[-1]] + list(xs[:-1])
    else:
        dtype = xs[-1].dtype
        out = _wire(mesh, xs[-1]).contiguous()
        into = torch.empty_like(out)
        nxt = (mesh.rank + 1) % mesh.n_procs
        prev = (mesh.rank - 1) % mesh.n_procs
        for work in dist.batch_isend_irecv([
            dist.P2POp(dist.isend, out, nxt),
            dist.P2POp(dist.irecv, into, prev),
        ]):
            work.wait()
        src = [into.to(dtype)] + list(xs[:-1])
    return [src[i].to(mesh.devices[i]) for i in range(n_local)]


def all_gather(mesh: Mesh, shards: Sequence[torch.Tensor]) -> torch.Tensor:
    """The whole array from its shards, in position order, on ``lead``."""
    return torch.cat([v.to(mesh.lead) for v in _every_position(mesh, shards)])


def _per_position(mesh: Mesh, x) -> list[torch.Tensor]:
    """A replicated argument as one copy per local position."""
    if isinstance(x, (list, tuple)):
        return [t.to(d) for t, d in zip(x, mesh.devices)]
    x = _host(x)
    return [x.to(d) for d in mesh.devices]


def _on_lead(mesh: Mesh, x) -> torch.Tensor:
    """A replicated argument on ``lead``."""
    if isinstance(x, (list, tuple)):
        x = x[0]
    return _host(x).to(mesh.lead)


def _host(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.detach()
    return torch.from_numpy(np.array(a))


def shard_task_arrays(mesh: Mesh, *arrays) -> tuple[list[torch.Tensor], ...]:
    """Split each whole task-axis array (numpy or tensor) into the mesh's
    equal shards: this process's, each a copy on its position's device."""
    out = []
    for a in arrays:
        t = _host(a)
        if t.shape[0] % mesh.size:
            raise ValueError(f"task axis of {t.shape[0]} does not split "
                             f"over {mesh.size} positions")
        n = t.shape[0] // mesh.size
        out.append([t[g * n:(g + 1) * n].to(d, copy=True)
                    for g, d in zip(mesh.local, mesh.devices)])
    return tuple(out)


def replicate(mesh: Mesh, *arrays) -> tuple[list[torch.Tensor], ...]:
    """One copy of each array per position of this process."""
    return tuple([_host(a).to(d, copy=True) for d in mesh.devices]
                 for a in arrays)


# -- the explicit shard bodies ------------------------------------------------
def ring_winner_resolve(mesh: Mesh, slot_bid: Sequence[torch.Tensor],
                        slot_tid: Sequence[torch.Tensor]):
    """Per-slot auction winner across the mesh by neighbour exchange.

    ``slot_bid`` f32[S] per position is its best local bid per slot (-inf =
    no local bidder), ``slot_tid`` i32[S] the global task id of that bidder
    (``BIG`` = none). Each of the n-1 steps shifts the running pair one hop
    right and folds it with (higher bid, then lower task id), compared in
    float32 (-0.0 ties with 0.0), the single-device lexsort's tie rule.
    Afterwards every position holds the same global winner pair."""
    p_acc, t_acc = list(slot_bid), list(slot_tid)
    p_in, t_in = list(slot_bid), list(slot_tid)
    for _ in range(mesh.size - 1):
        p_in = ppermute(mesh, p_in)
        t_in = ppermute(mesh, t_in)
        for i in range(len(p_acc)):
            take = (p_in[i] > p_acc[i]) | (
                (p_in[i] == p_acc[i]) & (t_in[i] < t_acc[i]))
            p_acc[i] = torch.where(take, p_in[i], p_acc[i])
            t_acc[i] = torch.where(take, t_in[i], t_acc[i])
    return p_acc, t_acc


def sharded_sinkhorn_plan(
    mesh: Mesh,
    task_size: Sequence[torch.Tensor],  # f32[Tl] per position
    task_valid: Sequence[torch.Tensor],  # bool[Tl] per position
    worker_speed,  # f32[W] replicated
    worker_free,  # i32[W]
    worker_live,  # bool[W]
    tau: float = 0.05,
    n_iters: int = 60,
    max_slots: int = 8,
) -> torch.Tensor:
    """The soft plan f32[T, W+1] (real workers, then the slack column) of
    the task-sharded Sinkhorn iterations, gathered on ``lead``.

    Each position iterates on its own rows; the slack row (unused
    capacity) is a replicated scalar potential, and the column update is
    the distributed logsumexp: a ``pmax`` for the shift and a ``psum`` of
    the mass."""
    speeds = _per_position(mesh, worker_speed)
    cap = [torch.where(lv, fr.clamp(max=max_slots), 0).to(torch.float32)
           for lv, fr in zip(_per_position(mesh, worker_live),
                             _per_position(mesh, worker_free))]
    L = range(len(mesh.devices))
    n_tasks = psum(mesh, [tv.sum().to(torch.float32) for tv in task_valid])
    total_cap = [c.sum() for c in cap]
    cost = [task_size[i][:, None] / speeds[i].clamp_min(1e-6)[None, :]
            for i in L]
    mask = [task_valid[i][:, None] & (cap[i][None, :] > 0) for i in L]
    cmax = pmax(mesh, [torch.where(mask[i], cost[i], 0.0).max() for i in L])
    loga, loga_slack, logb, negc, negc_slack, tau_eff = [], [], [], [], [], []
    for i in L:
        slack_cost = cmax[i] + 1.0
        # scale-free smoothing, relative to the global cost magnitude
        te = tau * cmax[i].clamp_min(1e-30)
        # columns: W real + 1 slack (absorbs tasks beyond capacity)
        cost_all = torch.cat([
            torch.where(mask[i], cost[i], _INF),
            torch.where(task_valid[i], slack_cost, _INF)[:, None],
        ], dim=1)
        b = torch.cat([cap[i], (n_tasks[i] - total_cap[i]).clamp_min(0.0)[None]])
        # the slack row (unused capacity): cost 0 to every real worker
        a_slack = (total_cap[i] - n_tasks[i]).clamp_min(0.0)
        loga.append(torch.where(task_valid[i], 0.0, -_INF))
        loga_slack.append(torch.where(
            a_slack > 0, torch.log(a_slack.clamp_min(1e-30)), -_INF))
        logb.append(torch.where(b > 0, torch.log(b.clamp_min(1e-30)), -_INF))
        negc.append(-cost_all / te)
        negc_slack.append(torch.cat([
            torch.where(cap[i] > 0, 0.0, -_INF),
            torch.full((1,), -_INF, device=cap[i].device),
        ]))
        tau_eff.append(te)
    W = cap[0].shape[0]
    f = [torch.zeros_like(ts) for ts in task_size]
    f_slack = [torch.zeros((), dtype=torch.float32, device=d)
               for d in mesh.devices]
    g = [torch.zeros(W + 1, dtype=torch.float32, device=d)
         for d in mesh.devices]
    for _ in range(n_iters):
        z, slack_z = [], []
        for i in L:
            te = tau_eff[i]
            # f-update (rows): local, no communication
            fi = te * (loga[i] - _logsumexp(negc[i] + g[i][None, :] / te, 1))
            f[i] = torch.where(torch.isfinite(loga[i]), fi, -_INF)
            fs = te * (loga_slack[i]
                       - _logsumexp(negc_slack[i] + g[i] / te, 0))
            f_slack[i] = torch.where(torch.isfinite(loga_slack[i]), fs, -_INF)
            z.append(negc[i] + f[i][:, None] / te)
            slack_z.append(negc_slack[i] + f_slack[i] / te)
        # g-update (columns): the distributed logsumexp over the task axis
        zmax = pmax(mesh, [zi.amax(dim=0) for zi in z])
        zmax_s = [torch.maximum(zmax[i], slack_z[i]) for i in L]
        zmax_safe = [torch.where(torch.isfinite(m), m, 0.0) for m in zmax_s]
        expsum = psum(mesh, [torch.exp(z[i] - zmax_safe[i][None, :]).sum(0)
                             for i in L])
        for i in L:
            es = expsum[i] + torch.exp(slack_z[i] - zmax_safe[i])
            lse = zmax_safe[i] + torch.log(es.clamp_min(1e-30))
            lse = torch.where(torch.isfinite(zmax_s[i]), lse, -_INF)
            gi = tau_eff[i] * (logb[i] - lse)
            g[i] = torch.where(torch.isfinite(logb[i]), gi, -_INF)
    # the local soft plan over real workers + the slack mass per task
    plan = [torch.exp(negc[i] + (f[i][:, None] + g[i][None, :]) / tau_eff[i])
            for i in L]
    return all_gather(mesh, plan)


def sharded_sinkhorn_placement(
    mesh: Mesh,
    task_size: Sequence[torch.Tensor],
    task_valid: Sequence[torch.Tensor],
    worker_speed,
    worker_free,
    worker_live,
    tau: float = 0.05,
    n_iters: int = 60,
    max_slots: int = 8,
) -> torch.Tensor:
    """Entropic placement with task-sharded Sinkhorn iterations; the
    rounding is the port's ``sched/sinkhorn.py::round_plan`` on the
    gathered plan. Returns the assignment i32[T] on ``lead``."""
    plan = sharded_sinkhorn_plan(mesh, task_size, task_valid, worker_speed,
                                 worker_free, worker_live, tau, n_iters,
                                 max_slots)
    return round_plan(
        plan, all_gather(mesh, task_size), all_gather(mesh, task_valid),
        _on_lead(mesh, worker_speed), _on_lead(mesh, worker_free),
        _on_lead(mesh, worker_live), max_slots,
    )


def sharded_auction_placement(
    mesh: Mesh,
    task_size: Sequence[torch.Tensor],  # f32[Tl] per position
    task_valid: Sequence[torch.Tensor],  # bool[Tl] per position
    worker_speed,  # f32[W] replicated
    worker_free,  # i32[W]
    worker_live,  # bool[W]
    max_slots: int = 8,
    eps: float = 1e-3,
    warm_rounds: int = 64,
    init_price: torch.Tensor | None = None,  # f32[W*max_slots]
    carry_refresh: torch.Tensor | None = None,  # bool scalar
) -> AuctionResult:
    """The auction's bidding rounds over the sharded task axis, with the
    per-slot winners combined by :func:`ring_winner_resolve`.

    Setup (slot expansion, squaring, the analytic dual seed) and the close
    (the rank spill) are global: :func:`all_gather` and the single-device
    helpers. Each round, each position bids its shard with ``bid_top2``
    (kernel B2 on the card) at its global ``row_offset``, reduces its
    bids to a per-slot (best bid, lowest task id) pair with two scatters,
    and the ring resolves the winners. The rounds run while any admitted
    task is unassigned (a ``psum`` of the positions' counts, read on the
    host) and fewer than ``warm_rounds`` have run. Round for round this is
    the single-device seeded or warm solver: the same bid values, exact
    maxima and the same tie rule, so its assignment and round count equal
    ``auction_placement_impl``'s."""
    ts_all = all_gather(mesh, task_size)
    tv_all = all_gather(mesh, task_valid)
    speed = _on_lead(mesh, worker_speed)
    T = ts_all.shape[0]
    W = speed.shape[0]
    S = W * max_slots
    Tl = task_size[0].shape[0]
    (
        slot_valid, slot_worker, slot_speed, speed_key,
        slot_order_by_speed, n_match, admitted,
    ) = _expand_and_square(tv_all, speed, _on_lead(mesh, worker_free),
                           _on_lead(mesh, worker_live), max_slots)
    seed = _rank_dual_seed(ts_all, admitted, speed_key, slot_order_by_speed,
                           n_match)
    if init_price is None:
        price0 = seed
    elif carry_refresh is not None:
        price0 = torch.where(carry_refresh.to(mesh.lead), seed,
                             _rebase(init_price.to(mesh.lead)))
    else:
        price0 = _rebase(init_price.to(mesh.lead))
    inv_speed = _per_position(mesh, 1.0 / slot_speed.clamp_min(1e-6))
    valid_f = _per_position(mesh, slot_valid.to(torch.float32))
    jitter_scale, eps_f = bid_scalars(eps)
    (adm,) = shard_task_arrays(mesh, admitted)
    L = range(len(mesh.devices))
    gid0 = [g * Tl for g in mesh.local]
    gids = [torch.arange(gid0[i], gid0[i] + Tl, dtype=_I32,
                         device=mesh.devices[i]) for i in L]
    price = _per_position(mesh, price0)
    owner = [torch.full((S,), -1, dtype=_I32, device=d) for d in mesh.devices]
    asg = [torch.full((Tl,), -1, dtype=_I32, device=d) for d in mesh.devices]
    slots = [torch.arange(S, dtype=_I32, device=d) for d in mesh.devices]

    def unassigned() -> int:
        """The admitted tasks still without a slot, over every position:
        both the loop's condition and the round's bidders."""
        return int(psum(mesh, [(adm[i] & (asg[i] < 0)).sum(dtype=_I32)  # faas: allow(trace.host-sync) the sharded auction's round loop on the host (JAX's while_loop): one bidder count a round
                               for i in L])[0])

    rounds, bid_rows = 0, 0
    un = unassigned()
    while un > 0 and rounds < warm_rounds:
        bid_rows += un
        slot_bid, slot_tid, bid, bidder = [], [], [], []
        for i in L:
            d = mesh.devices[i]
            b_i = adm[i] & (asg[i] < 0)
            v1, best, v2 = bid_top2(task_size[i], inv_speed[i], valid_f[i],
                                    price[i], jitter_scale,
                                    row_offset=gid0[i], n_slots_total=S)
            b_i = b_i & torch.isfinite(v1)
            incr = torch.where(torch.isfinite(v2), v1 - v2, 1.0) + eps_f
            bid_i = price[i][best.long()] + incr
            # the local per-slot best: one scatter-max, then the lowest
            # task id among the local bids that reached it (the compared
            # values are the same stored floats)
            sk = torch.where(b_i, best, S).long()
            sb = torch.full((S + 1,), -_INF, device=d).scatter_reduce(
                0, sk, torch.where(b_i, bid_i, -_INF), "amax")[:S]
            hit = b_i & (bid_i == sb[best.clamp(0, S - 1).long()])
            st = torch.full((S + 1,), BIG, dtype=_I32, device=d)
            st = st.scatter_reduce(0, torch.where(hit, best, S).long(),
                                   torch.where(hit, gids[i], BIG), "amin")
            slot_bid.append(sb)
            slot_tid.append(st[:S])
        win_p, win_t = ring_winner_resolve(mesh, slot_bid, slot_tid)
        for i in L:
            win = torch.isfinite(win_p[i]) & (win_t[i] < BIG)
            owner[i] = torch.where(win, win_t[i], owner[i])
            price[i] = torch.where(win, win_p[i], price[i])
            # eviction is derived: a task keeps its slot iff it still owns
            # it after the winners install (single-device scatter semantics)
            a = asg[i]
            a = torch.where(
                (a >= 0) & (owner[i][a.clamp(0, S - 1).long()] != gids[i]),
                -1, a)
            in_rng = win & (win_t[i] >= gid0[i]) & (win_t[i] < gid0[i] + Tl)
            idx = torch.where(in_rng, win_t[i] - gid0[i], Tl).long()
            buf = torch.cat([a, a.new_zeros(1)])
            buf[idx] = torch.where(in_rng, slots[i], -1)
            asg[i] = buf[:Tl]
        rounds += 1
        un = unassigned()
    assignment, stranded, refresh, n_spill = _rank_spill_close(
        all_gather(mesh, asg), owner[0].to(mesh.lead), admitted, ts_all,
        slot_valid, slot_speed, slot_worker, n_match,
    )
    return AuctionResult(assignment, rounds, price[0].to(mesh.lead), stranded,
                         refresh, n_spill, bid_rows)


def sharded_scheduler_tick(
    mesh: Mesh,
    task_size: Sequence[torch.Tensor],  # f32[Tl] per position
    task_valid: Sequence[torch.Tensor] | None,  # bool; None = first n_valid
    worker_speed,  # replicated: a tensor or one per position
    worker_free,
    worker_active,
    heartbeat_age,  # f32[W] seconds since the last heartbeat
    prev_live,
    inflight_worker,  # i32[I]
    time_to_expire,
    max_slots: int = 8,
    placement: str = "sinkhorn",  # rank | auction | sinkhorn
    task_priority: Sequence[torch.Tensor] | None = None,  # sharded like tasks
    n_valid: int | None = None,  # with task_valid=None
    auction_price: torch.Tensor | None = None,  # f32[W*max_slots] warm start
    winner_resolve: str = "gspmd",  # auction only: gspmd | permute
) -> TickOutput:
    """The full tick (liveness, purge, redispatch, placement) with the
    pending-task axis sharded over the mesh; the semantics of
    ``sched/state.py::scheduler_tick_impl``. Sinkhorn ignores
    ``task_priority`` (entropic admission is soft); the auction runs the
    single-device solver on the gathered tasks (``gspmd``) or the sharded
    rounds (``permute``), with warm prices through ``auction_price``."""
    if task_valid is None:
        # the valid mask from a scalar, built on each position
        Tl = task_size[0].shape[0]
        task_valid = [
            torch.arange(g * Tl, (g + 1) * Tl, device=d) < n_valid
            for g, d in zip(mesh.local, mesh.devices)
        ]
    speed = _on_lead(mesh, worker_speed)
    free = _on_lead(mesh, worker_free)
    if isinstance(time_to_expire, torch.Tensor):
        time_to_expire = time_to_expire.to(mesh.lead)
    else:  # a float or a 0-d array: the f32 value the ages compare with
        time_to_expire = float(np.float32(np.asarray(time_to_expire)))
    live = _on_lead(mesh, worker_active) & (
        _on_lead(mesh, heartbeat_age) <= time_to_expire)
    purged = _on_lead(mesh, prev_live) & ~live
    iw = _on_lead(mesh, inflight_worker)
    occupied = iw >= 0
    # the gather clamps like XLA's: a row past W reads the last worker
    redispatch = occupied & ~live[iw.clamp(0, live.shape[0] - 1).long()]
    if placement == "sinkhorn":
        assignment = sharded_sinkhorn_placement(
            mesh, task_size, task_valid, speed, free, live,
            max_slots=max_slots,
        )
    elif placement == "auction":
        if winner_resolve == "permute":
            res = sharded_auction_placement(
                mesh, task_size, task_valid, speed, free, live,
                max_slots=max_slots, init_price=auction_price,
            )
        else:
            res = auction_placement_impl(
                all_gather(mesh, task_size), all_gather(mesh, task_valid),
                speed, free, live, max_slots=max_slots,
                init_price=(None if auction_price is None
                            else auction_price.to(mesh.lead)),
            )
        return TickOutput(res.assignment, live, purged, redispatch,
                          res.prices, res.refresh, res.n_rounds,
                          res.n_spilled, res.n_bid_rows)
    else:
        assignment = rank_match_placement_impl(
            all_gather(mesh, task_size), all_gather(mesh, task_valid),
            speed, free, live, max_slots=max_slots,
            task_priority=(None if task_priority is None
                           else all_gather(mesh, task_priority)),
        )
    return TickOutput(assignment, live, purged, redispatch)
