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
from tpu_faas_torch.sched.sinkhorn import N_ITERS, TAU, _logsumexp, round_plan
from tpu_faas_torch.sched.scripted import call, scripted
from tpu_faas_torch.sched.state import TickOutput, fleet_state

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
def _wire(t: torch.Tensor) -> torch.Tensor:
    """What a collective across processes sends of ``t``, a tensor on the
    process's lead device: gloo takes CPU tensors only (the staging copy
    through host memory), and bool travels as uint8."""
    if t.dtype == torch.bool:
        t = t.to(torch.uint8)
    if dist.get_backend() == "gloo":
        return t.cpu()  # faas: allow(trace.host-sync) gloo takes CPU tensors: a collective on gloo stages through host memory
    return t


def _every_position(mesh: Mesh, xs: Sequence[torch.Tensor]
                    ) -> list[torch.Tensor]:
    """The values of all positions, in position order: this process's list
    as it is, or every process's gathered."""
    if mesh.n_procs == 1:
        return list(xs)
    return list(_positions(torch.stack([x.to(mesh.lead) for x in xs]),
                           mesh.lead, mesh.n_procs).unbind(0))


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
        out = _wire(xs[-1].to(mesh.lead)).contiguous()
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


def _device_runs(mesh: Mesh) -> list[tuple[int, int, torch.device]]:
    """This process's positions as maximal runs of neighbours (on the mesh
    and so on the task axis) on one device, ``(start, stop, device)`` in
    position order: one run when the process holds its positions on the
    host or on one card, one a position when each has a card of its
    own."""
    runs: list[tuple[int, int, torch.device]] = []
    for i, d in enumerate(mesh.devices):
        if (runs and runs[-1][2] == d
                and mesh.local[i] == mesh.local[i - 1] + 1):
            runs[-1] = (runs[-1][0], i + 1, d)
        else:
            runs.append((i, i + 1, d))
    return runs


# -- the Sinkhorn shard body: one scripted call a tick (ROADMAP C.11) --------
# The functions below are compiled by TorchScript and run unoptimised
# (``sched/scripted.py``): the interpreter lock is released once for the
# whole tick, not once an op, and the bits are the eager ops'
# (``tests/test_torch_parallel_mesh.py``). A run is a maximal set of
# neighbouring positions on one device (:func:`_device_runs`), given as
# ``starts`` (each run's first position, then the count) and ``devices``
# (each run's device). Across processes the collectives call back into
# Python (:func:`_gather_processes`), once a collective.
@torch.jit.ignore
def _gather_processes(stacked):
    # type: (Tensor) -> Tensor
    """Every process's ``stacked`` values (on its lead device) concatenated
    in rank order, on the wire's device (:func:`_wire`) in ``stacked``'s
    dtype. Its types are a comment: TorchScript reads an ignored
    function's annotations as values, and this module's are strings."""
    dtype = stacked.dtype
    mine = _wire(stacked)
    parts = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, mine.contiguous())
    return torch.cat(parts).to(dtype)


def _positions(stacked: torch.Tensor, lead: torch.device,
               n_procs: int) -> torch.Tensor:
    """This process's positions' values stacked on a leading axis, as
    every position's, in position order."""
    if n_procs == 1:
        return stacked
    return _gather_processes(stacked.to(lead))


def _gather_runs(shards: list[torch.Tensor], lead: torch.device,
                 n_procs: int) -> torch.Tensor:
    """:func:`all_gather` of this process's shards, one a position."""
    if n_procs == 1:
        return torch.cat([v.to(lead) for v in shards])
    every = _positions(torch.stack([x.to(lead) for x in shards]), lead,
                       n_procs)
    return torch.cat([v.to(lead) for v in every.unbind(0)])


def _fold_runs(parts: list[torch.Tensor], devices: list[torch.device],
               lead: torch.device, n_procs: int,
               take_max: bool) -> list[torch.Tensor]:
    """A collective over stacked partials, one tensor a run whose leading
    axis is the run's positions: every position's partial, gathered across
    processes, folded on ``lead`` in position order as :func:`psum` (or,
    with ``take_max``, :func:`pmax`) folds a list; the result on every
    run's device."""
    if len(parts) == 1:
        local = parts[0].to(lead)
    else:
        local = torch.cat([p.to(lead) for p in parts])
    vals = _positions(local, lead, n_procs).to(lead).unbind(0)
    acc = vals[0]
    for i in range(1, len(vals)):
        if take_max:
            acc = torch.maximum(acc, vals[i])
        else:
            acc = torch.add(acc, vals[i])
    return [acc.to(d) for d in devices]


def _per_run(xs: list[torch.Tensor], starts: list[int],
             devices: list[torch.device]) -> list[torch.Tensor]:
    """A replicated argument (one tensor, or one a local position) as one
    copy per run."""
    out: list[torch.Tensor] = []
    for r in range(len(devices)):
        src = xs[starts[r]] if len(xs) > 1 else xs[0]
        out.append(src.to(devices[r]))
    return out


def _sinkhorn_plan_runs(
    starts: list[int],
    devices: list[torch.device],
    lead: torch.device,
    n_procs: int,
    task_size: list[torch.Tensor],  # f32[Tl] per local position
    task_valid: list[torch.Tensor],  # bool[Tl] per local position
    worker_speed: list[torch.Tensor],  # f32[W]: one, or one a position
    worker_free: list[torch.Tensor],  # i32[W]
    worker_live: list[torch.Tensor],  # bool[W]
    tau: float,
    n_iters: int,
    max_slots: int,
) -> torch.Tensor:
    """The body of :func:`sharded_sinkhorn_plan`, each run's positions
    stacked on a leading axis and iterated at once."""
    R = len(devices)
    ts = [torch.stack(task_size[starts[r]:starts[r + 1]]) for r in range(R)]
    tv = [torch.stack(task_valid[starts[r]:starts[r + 1]])
          for r in range(R)]
    speed = _per_run(worker_speed, starts, devices)
    free = _per_run(worker_free, starts, devices)
    live = _per_run(worker_live, starts, devices)
    cap = [torch.where(live[r], free[r].clamp(max=max_slots), 0)
           .to(torch.float32) for r in range(R)]
    n_tasks = _fold_runs([v.sum(1).to(torch.float32) for v in tv], devices,
                         lead, n_procs, False)
    total_cap = [c.sum() for c in cap]
    cost = [ts[r][:, :, None] / speed[r].clamp_min(1e-6)[None, None, :]
            for r in range(R)]
    mask = [tv[r][:, :, None] & (cap[r][None, None, :] > 0)
            for r in range(R)]
    cmax = _fold_runs([torch.where(mask[r], cost[r], 0.0).amax(dim=[1, 2])
                       for r in range(R)], devices, lead, n_procs, True)
    loga: list[torch.Tensor] = []
    loga_slack: list[torch.Tensor] = []
    logb: list[torch.Tensor] = []
    negc: list[torch.Tensor] = []
    negc_slack: list[torch.Tensor] = []
    tau_eff: list[torch.Tensor] = []
    for r in range(R):
        slack_cost = cmax[r] + 1.0
        # scale-free smoothing, relative to the global cost magnitude
        te = tau * cmax[r].clamp_min(1e-30)
        # columns: W real + 1 slack (absorbs tasks beyond capacity)
        cost_all = torch.cat([
            torch.where(mask[r], cost[r], torch.inf),
            torch.where(tv[r], slack_cost, torch.inf)[:, :, None],
        ], dim=2)
        b = torch.cat([cap[r],
                       (n_tasks[r] - total_cap[r]).clamp_min(0.0)[None]])
        # the slack row (unused capacity): cost 0 to every real worker
        a_slack = (total_cap[r] - n_tasks[r]).clamp_min(0.0)
        loga.append(torch.where(tv[r], 0.0, -torch.inf))
        loga_slack.append(torch.where(
            a_slack > 0, torch.log(a_slack.clamp_min(1e-30)), -torch.inf))
        logb.append(torch.where(b > 0, torch.log(b.clamp_min(1e-30)),
                                -torch.inf))
        negc.append(-cost_all / te)
        negc_slack.append(torch.cat([
            torch.where(cap[r] > 0, 0.0, -torch.inf),
            torch.full([1], -torch.inf, device=cap[r].device),
        ]))
        tau_eff.append(te)
    W = cap[0].shape[0]
    f = [torch.zeros_like(t) for t in ts]
    g = [torch.zeros(W + 1, dtype=torch.float32, device=d) for d in devices]
    # the loop's invariant masks, computed once
    rows_in = [torch.isfinite(x) for x in loga]
    slack_in = [torch.isfinite(x) for x in loga_slack]
    cols_in = [torch.isfinite(x) for x in logb]
    for _ in range(n_iters):
        z: list[torch.Tensor] = []
        slack_z: list[torch.Tensor] = []
        for r in range(R):
            te = tau_eff[r]
            # f-update (rows): local, no communication
            g_te = g[r] / te
            fi = te * (loga[r] - _logsumexp(negc[r] + g_te, 2))
            f[r] = torch.where(rows_in[r], fi, -torch.inf)
            fs = te * (loga_slack[r] - _logsumexp(negc_slack[r] + g_te, 0))
            f_slack = torch.where(slack_in[r], fs, -torch.inf)
            z.append(negc[r] + f[r][:, :, None] / te)
            slack_z.append(negc_slack[r] + f_slack / te)
        # g-update (columns): the distributed logsumexp over the task axis
        zmax = _fold_runs([zr.amax(dim=1) for zr in z], devices, lead,
                          n_procs, True)
        zmax_s = [torch.maximum(zmax[r], slack_z[r]) for r in range(R)]
        zmax_safe = [torch.where(torch.isfinite(m), m, 0.0) for m in zmax_s]
        expsum = _fold_runs([torch.exp(z[r] - zmax_safe[r]).sum(1)
                             for r in range(R)], devices, lead, n_procs,
                            False)
        for r in range(R):
            es = expsum[r] + torch.exp(slack_z[r] - zmax_safe[r])
            lse = zmax_safe[r] + torch.log(es.clamp_min(1e-30))
            lse = torch.where(torch.isfinite(zmax_s[r]), lse, -torch.inf)
            gi = tau_eff[r] * (logb[r] - lse)
            g[r] = torch.where(cols_in[r], gi, -torch.inf)
    # the local soft plan over real workers + the slack mass per task
    rows: list[torch.Tensor] = []
    for r in range(R):
        plan = torch.exp(negc[r] + (f[r][:, :, None] + g[r]) / tau_eff[r])
        rows.extend(plan.unbind(0))
    return _gather_runs(rows, lead, n_procs)


def _sinkhorn_placement_runs(
    starts: list[int],
    devices: list[torch.device],
    lead: torch.device,
    n_procs: int,
    task_size: list[torch.Tensor],
    task_valid: list[torch.Tensor],
    worker_speed: list[torch.Tensor],
    worker_free: list[torch.Tensor],
    worker_live: list[torch.Tensor],
    tau: float,
    n_iters: int,
    max_slots: int,
) -> torch.Tensor:
    """The body of :func:`sharded_sinkhorn_placement`: the plan, then the
    rounding on the gathered plan."""
    plan = _sinkhorn_plan_runs(starts, devices, lead, n_procs, task_size,
                               task_valid, worker_speed, worker_free,
                               worker_live, tau, n_iters, max_slots)
    return round_plan(
        plan, _gather_runs(task_size, lead, n_procs),
        _gather_runs(task_valid, lead, n_procs), worker_speed[0].to(lead),
        worker_free[0].to(lead), worker_live[0].to(lead), max_slots,
    )


def _valid_shards(task_size: list[torch.Tensor], positions: list[int],
                  n_valid: int) -> list[torch.Tensor]:
    """The valid mask of each local shard from a scalar, built on the
    shard's device: the first ``n_valid`` rows of the whole task axis."""
    Tl = task_size[0].shape[0]
    return [torch.arange(g * Tl, (g + 1) * Tl, device=ts.device) < n_valid
            for g, ts in zip(positions, task_size)]


def _sinkhorn_tick_runs(
    starts: list[int],
    devices: list[torch.device],
    lead: torch.device,
    n_procs: int,
    positions: list[int],  # each local position's index in the mesh
    task_size: list[torch.Tensor],
    task_valid: list[torch.Tensor],  # empty: from n_valid
    n_valid: int,
    fleet: list[list[torch.Tensor]],  # speed, free, active, ages, prev, iw
    time_to_expire: torch.Tensor | float,
    tau: float,
    n_iters: int,
    max_slots: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The body of :func:`sharded_scheduler_tick` with Sinkhorn placement:
    (assignment, live, purged, redispatch)."""
    if len(task_valid) == 0:
        task_valid = _valid_shards(task_size, positions, n_valid)
    speed, free, active, ages, prev, iw = [x[0].to(lead) for x in fleet]
    expiry = time_to_expire
    if isinstance(expiry, torch.Tensor):
        expiry = expiry.to(lead)
    live, purged, redispatch = fleet_state(active, ages, prev, iw, expiry)
    assignment = _sinkhorn_placement_runs(
        starts, devices, lead, n_procs, task_size, task_valid, [speed],
        [free], [live], tau, n_iters, max_slots)
    return assignment, live, purged, redispatch


def prepare_sinkhorn() -> None:
    """Compile the Sinkhorn tick body (:func:`sharded_scheduler_tick`'s,
    which the dispatcher's mesh arrays and the multihost tick call) now,
    where a caller sets up, not inside its first tick. It runs
    unoptimised, so its first call costs no more than the next; the plan
    and placement entry points compile on their first call."""
    scripted(_sinkhorn_tick_runs)


def _replicas(x) -> list[torch.Tensor]:
    """A replicated argument as the scripted bodies take it: one tensor a
    local position, or one for all."""
    if isinstance(x, (list, tuple)):
        return list(x)
    return [x if isinstance(x, torch.Tensor) else _host(x)]


def _run_scripted(body, mesh: Mesh, *args):
    """One call of a scripted Sinkhorn body over this process's runs."""
    runs = _device_runs(mesh)
    return call(body, [a for a, _, _ in runs] + [len(mesh.devices)],
                [d for _, _, d in runs], mesh.lead, mesh.n_procs, *args)


def sharded_sinkhorn_plan(
    mesh: Mesh,
    task_size: Sequence[torch.Tensor],  # f32[Tl] per position
    task_valid: Sequence[torch.Tensor],  # bool[Tl] per position
    worker_speed,  # f32[W] replicated
    worker_free,  # i32[W]
    worker_live,  # bool[W]
    tau: float = TAU,
    n_iters: int = N_ITERS,
    max_slots: int = 8,
) -> torch.Tensor:
    """The soft plan f32[T, W+1] (real workers, then the slack column) of
    the task-sharded Sinkhorn iterations, gathered on ``lead``.

    Each position iterates on its own rows; the slack row (unused
    capacity) is a replicated scalar potential, and the column update is
    the distributed logsumexp: a ``pmax`` for the shift and a ``psum`` of
    the mass (:func:`_fold_runs`). The positions of a run on one device
    (:func:`_device_runs`: all of a process's on the host, or several named
    on one card) are stacked on a leading axis and iterated at once, and
    the whole solve is one scripted call (``sched/scripted.py``): a process
    ticking a 4-position mesh on the host takes the interpreter lock back
    a few times a tick, not once an op (ROADMAP C.11)."""
    return _run_scripted(
        _sinkhorn_plan_runs, mesh, list(task_size), list(task_valid),
        *(_replicas(x) for x in (worker_speed, worker_free, worker_live)),
        float(tau), int(n_iters), int(max_slots))


def sharded_sinkhorn_placement(
    mesh: Mesh,
    task_size: Sequence[torch.Tensor],
    task_valid: Sequence[torch.Tensor],
    worker_speed,
    worker_free,
    worker_live,
    tau: float = TAU,
    n_iters: int = N_ITERS,
    max_slots: int = 8,
) -> torch.Tensor:
    """Entropic placement with task-sharded Sinkhorn iterations; the
    rounding is the port's ``sched/sinkhorn.py::round_plan`` on the
    gathered plan, in the same scripted call. Returns the assignment i32[T]
    on ``lead``."""
    return _run_scripted(
        _sinkhorn_placement_runs, mesh, list(task_size), list(task_valid),
        *(_replicas(x) for x in (worker_speed, worker_free, worker_live)),
        float(tau), int(n_iters), int(max_slots))


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
    helpers. Each round, each run of positions on one device
    (:func:`_device_runs`, whose rows are neighbours on the task axis) bids
    its rows as one block with ``bid_top2`` (kernel B2 on the card: one
    launch a run a round) at its global ``row_offset``, reduces its bids to
    a per-slot (best bid, lowest task id) pair with two scatters, and the
    ring resolves the winners across runs and processes (one run in one
    process holds every position, and its pair is the winner). A bid is
    finite and never -0.0 (a finite price plus a positive increment), so
    the pair of a block is the ring's fold of its positions' pairs. The
    rounds run while any admitted task is unassigned (a ``psum`` of the
    runs' counts, read on the host) and fewer than ``warm_rounds`` have
    run. Round for round this is the single-device seeded or warm solver:
    the same bid values, exact maxima and the same tie rule, so its
    assignment and round count equal ``auction_placement_impl``'s."""
    ts_all = all_gather(mesh, task_size)
    tv_all = all_gather(mesh, task_valid)
    speed = _on_lead(mesh, worker_speed)
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
    jitter_scale, eps_f = bid_scalars(eps)
    runs = _device_runs(mesh)
    R = range(len(runs))
    devs = [d for _, _, d in runs]
    # each run's rows: [gid0, gid0 + n) of the task axis
    gid0 = [mesh.local[a] * Tl for a, _, _ in runs]
    n = [(b - a) * Tl for a, b, _ in runs]
    sizes = [torch.cat([x.to(d) for x in task_size[a:b]])
             for a, b, d in runs]
    adm = [admitted[g:g + k].to(d) for g, k, d in zip(gid0, n, devs)]
    gids = [torch.arange(g, g + k, dtype=_I32, device=d)
            for g, k, d in zip(gid0, n, devs)]
    inv_speed, valid_f, price = (
        [x.to(d) for d in devs]
        for x in (1.0 / slot_speed.clamp_min(1e-6),
                  slot_valid.to(torch.float32), price0))
    owner = [torch.full((S,), -1, dtype=_I32, device=d) for d in devs]
    asg = [torch.full((k,), -1, dtype=_I32, device=d)
           for k, d in zip(n, devs)]
    slots = [torch.arange(S, dtype=_I32, device=d) for d in devs]
    one_block = len(runs) == 1 and mesh.n_procs == 1
    zero = torch.zeros((), dtype=_I32, device=mesh.lead)

    def unassigned() -> int:
        """The admitted tasks still without a slot, over every position
        (a run's count at its first position): both the loop's condition
        and the round's bidders."""
        counts = [zero] * len(mesh.devices)
        for r in R:
            counts[runs[r][0]] = (adm[r] & (asg[r] < 0)).sum(dtype=_I32)
        return int(psum(mesh, counts)[0])  # faas: allow(trace.host-sync) the sharded auction's round loop on the host (JAX's while_loop): one bidder count a round

    rounds, bid_rows = 0, 0
    un = unassigned()
    while un > 0 and rounds < warm_rounds:
        bid_rows += un
        slot_bid, slot_tid = [], []
        for r in R:
            b_r = adm[r] & (asg[r] < 0)
            v1, best, v2 = bid_top2(sizes[r], inv_speed[r], valid_f[r],
                                    price[r], jitter_scale,
                                    row_offset=gid0[r], n_slots_total=S)
            b_r = b_r & torch.isfinite(v1)
            incr = torch.where(torch.isfinite(v2), v1 - v2, 1.0) + eps_f
            bid_r = price[r][best.long()] + incr
            # the block's per-slot best: one scatter-max, then the lowest
            # task id among the block's bids that reached it (the compared
            # values are the same stored floats)
            sk = torch.where(b_r, best, S).long()
            sb = torch.full((S + 1,), -_INF, device=devs[r]).scatter_reduce(
                0, sk, torch.where(b_r, bid_r, -_INF), "amax")[:S]
            hit = b_r & (bid_r == sb[best.clamp(0, S - 1).long()])
            st = torch.full((S + 1,), BIG, dtype=_I32, device=devs[r])
            st = st.scatter_reduce(0, torch.where(hit, best, S).long(),
                                   torch.where(hit, gids[r], BIG), "amin")
            slot_bid.append(sb)
            slot_tid.append(st[:S])
        if one_block:
            win_p, win_t = slot_bid, slot_tid
        else:
            # every position of a run holds the run's pair; the fold is
            # idempotent, so each ends with the global winner
            at = [r for r, (a, b, _) in enumerate(runs) for _ in range(a, b)]
            wp, wt = ring_winner_resolve(mesh, [slot_bid[r] for r in at],
                                         [slot_tid[r] for r in at])
            win_p = [wp[a] for a, _, _ in runs]
            win_t = [wt[a] for a, _, _ in runs]
        for r in R:
            win = torch.isfinite(win_p[r]) & (win_t[r] < BIG)
            owner[r] = torch.where(win, win_t[r], owner[r])
            price[r] = torch.where(win, win_p[r], price[r])
            # eviction is derived: a task keeps its slot iff it still owns
            # it after the winners install (single-device scatter semantics)
            a = asg[r]
            a = torch.where(
                (a >= 0) & (owner[r][a.clamp(0, S - 1).long()] != gids[r]),
                -1, a)
            in_rng = win & (win_t[r] >= gid0[r]) & (win_t[r] < gid0[r] + n[r])
            idx = torch.where(in_rng, win_t[r] - gid0[r], n[r]).long()
            buf = torch.cat([a, a.new_zeros(1)])
            buf[idx] = torch.where(in_rng, slots[r], -1)
            asg[r] = buf[:n[r]]
        rounds += 1
        un = unassigned()
    assignment, stranded, refresh, n_spill = _rank_spill_close(
        all_gather(mesh, [p for a in asg for p in a.split(Tl)]),
        owner[0].to(mesh.lead), admitted, ts_all, slot_valid, slot_speed,
        slot_worker, n_match,
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
    rounds (``permute``), with warm prices through ``auction_price``.
    The Sinkhorn tick is one scripted call (:func:`_sinkhorn_tick_runs`)."""
    if not isinstance(time_to_expire, torch.Tensor):
        # a float or a 0-d array: the f32 value the ages compare with
        time_to_expire = float(np.float32(np.asarray(time_to_expire)))
    fleet = [_replicas(x) for x in (worker_speed, worker_free, worker_active,
                                    heartbeat_age, prev_live,
                                    inflight_worker)]
    if placement == "sinkhorn":
        return TickOutput(*_run_scripted(
            _sinkhorn_tick_runs, mesh, list(mesh.local), list(task_size),
            [] if task_valid is None else list(task_valid),
            -1 if n_valid is None else int(n_valid), fleet, time_to_expire,
            TAU, N_ITERS, int(max_slots)))
    if task_valid is None:
        task_valid = _valid_shards(list(task_size), mesh.local, n_valid)
    speed, free, active, ages, prev, iw = (x[0].to(mesh.lead)
                                           for x in fleet)
    if isinstance(time_to_expire, torch.Tensor):
        time_to_expire = time_to_expire.to(mesh.lead)
    live, purged, redispatch = fleet_state(active, ages, prev, iw,
                                           time_to_expire)
    if placement == "auction":
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
    assignment = rank_match_placement_impl(
        all_gather(mesh, task_size), all_gather(mesh, task_valid),
        speed, free, live, max_slots=max_slots,
        task_priority=(None if task_priority is None
                       else all_gather(mesh, task_priority)),
    )
    return TickOutput(assignment, live, purged, redispatch)
