"""The one traffic generator: a fleet and a closed loop of calls, from a
configuration, a traffic mix and a seed.

Everything random is drawn here, in set-up: the fleet (speeds, processes,
which rows are purged), each worker's heartbeat phase, the task ids, the
sizes of the backlog, of the calls in flight and of every later arrival,
and the ticks the Sinkhorn check samples. The window then draws nothing:
a tick takes the calls that finish on it from a bucket, and each finished
call's caller submits the next call under the same id (a closed loop, so
the backlog stays level), with the next size from a pre-drawn ring.

A task of size ``s`` (seconds of work at speed 1.0, lognormal) runs
``s / speed`` seconds on its worker, never less than one tick. The fleet
starts saturated, in its steady state: every process of every live worker
holds a call whose remaining time is drawn from the residual life of its
runtime (a length-biased size, a uniform share of it left).

A configuration with a ``churn`` block (``fail_per_s``, ``down_s``) also
draws a failure schedule, after every other draw, so that a configuration
without one draws the same fleet, calls and sizes bit for bit: each worker
alternates between up, failing in each tick with the probability that
makes a share ``fail_per_s`` of the live workers fail in a second, and
down for ``down_s`` virtual seconds, after which it registers again under
its own id with its own processes and speed. The fleet starts in that
schedule's steady state (:func:`draw_churn`).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

#: arrival sizes drawn in set-up; arrival n takes entry n mod this
ARRIVAL_RING = 1 << 20
#: the Sinkhorn check samples one tick of every CHECK_EVERY (which one is
#: drawn from the seed), over the first CHECK_HORIZON ticks
CHECK_EVERY = 48
CHECK_HORIZON = 1 << 17


def rng_for(seed: int) -> np.random.Generator:
    """The run's generator; any whole number is a seed (it is taken mod
    2**64, so negative and large seeds both work)."""
    return np.random.default_rng(int(seed) % (1 << 64))


def _uuid_strings(rng: np.random.Generator, n: int) -> list[str]:
    raw = rng.bytes(16 * n).hex()
    return [
        f"{h[0:8]}-{h[8:12]}-4{h[13:16]}-a{h[17:20]}-{h[20:32]}"
        for h in (raw[32 * i:32 * i + 32] for i in range(n))
    ]


def lognormal(rng: np.random.Generator, mean: float, sigma: float,
              n: int, length_biased: bool = False) -> np.ndarray:
    """Lognormal draws of the given mean and shape, float32. Length-biased
    draws (a size seen in proportion to its length) shift mu by sigma^2."""
    mu = math.log(mean) - 0.5 * sigma * sigma
    if length_biased:
        mu += sigma * sigma
    return rng.lognormal(mu, sigma, n).astype(np.float32)


@dataclass
class Fleet:
    speed: np.ndarray  # f32[W]
    procs: np.ndarray  # i32[W]
    active: np.ndarray  # bool[W]
    ids: list  # bytes worker id per row (None for a purged row)


def draw_fleet(rng: np.random.Generator, config: dict) -> Fleet:
    W = int(config["max_workers"])
    lo, hi = config["worker_speed_range"]
    speed = rng.uniform(lo, hi, W).astype(np.float32)
    plo, phi = config["worker_procs_range"]
    procs = rng.integers(plo, phi + 1, W).astype(np.int32)
    # exactly the stated share of purged rows, at rows drawn from the seed
    n_off = int(round(config["inactive_share"] * W))
    active = np.ones(W, dtype=bool)
    active[rng.permutation(W)[:n_off]] = False
    ids = [b"w-%05d" % r if active[r] else None for r in range(W)]
    return Fleet(speed, procs, active, ids)


class Traffic:
    """A cell's traffic, drawn once from the seed."""

    def __init__(self, config: dict, traffic: dict, seed: int) -> None:
        rng = rng_for(seed)
        self.config, self.traffic = config, traffic
        self.dt = float(config["tick_period_s"])
        self.hb_period = max(1, int(round(config["heartbeat_period_s"]
                                          / self.dt)))
        self.fleet = fleet = draw_fleet(rng, config)
        self.inv_speed = (1.0 / fleet.speed.astype(np.float64)).tolist()
        mean, sigma = float(traffic["work_mean_s"]), float(
            traffic["work_sigma"])

        # heartbeat phases: each live worker once a period
        rows = np.flatnonzero(fleet.active)
        phase = rng.integers(0, self.hb_period, len(rows))
        self.hb_bucket = [[] for _ in range(self.hb_period)]
        for r, p in zip(rows.tolist(), phase.tolist()):
            self.hb_bucket[p].append(fleet.ids[r])

        # the saturated start: every process of every live worker busy
        busy_rows = np.repeat(rows, fleet.procs[rows])
        n_busy = len(busy_rows)
        T = int(config["max_pending"])
        n_backlog = T - int(config["pending_headroom"])
        ids = _uuid_strings(rng, n_busy + n_backlog)
        self.inflight_ids = ids[:n_busy]
        self.inflight_rows = busy_rows.astype(np.int64)
        size_lb = lognormal(rng, mean, sigma, n_busy, length_biased=True)
        left = rng.random(n_busy) * size_lb / fleet.speed[busy_rows]
        self.inflight_sizes = size_lb
        self.inflight_due = np.maximum(
            1, np.ceil(left / self.dt)).astype(np.int64)
        self.backlog_ids = ids[n_busy:]
        self.backlog_sizes = lognormal(rng, mean, sigma, n_backlog)
        self.arrival_sizes = lognormal(rng, mean, sigma,
                                       ARRIVAL_RING).tolist()
        blocks = CHECK_HORIZON // CHECK_EVERY
        self.check_ticks = set(
            (np.arange(blocks) * CHECK_EVERY
             + rng.integers(0, CHECK_EVERY, blocks)).tolist())
        self.churn = None
        if "churn" in config:  # every draw of the schedule comes last
            self.churn = ch = draw_churn(rng, config, fleet, rows, phase,
                                         self.hb_period)
            # workers purged before the start hold no row and no call
            gone = ch.purged0
            fleet.active = fleet.active & ~gone
            fleet.ids = [None if gone[r] else wid
                         for r, wid in enumerate(fleet.ids)]
            keep = ~gone[self.inflight_rows]
            self.inflight_ids = [t for t, k in zip(self.inflight_ids,
                                                   keep.tolist()) if k]
            self.inflight_rows = self.inflight_rows[keep]
            self.inflight_sizes = self.inflight_sizes[keep]
            self.inflight_due = self.inflight_due[keep]

    def due_tick(self, tick: int, size: float, row: int) -> int:
        """The tick on which a call of ``size`` placed on ``row`` at
        ``tick`` reports its result: its runtime in ticks, at least one."""
        return tick + max(1, math.ceil(size * self.inv_speed[row] / self.dt))


@dataclass
class Churn:
    """A configuration's failure schedule, drawn in set-up.

    Workers are numbered by the row they hold at the start (their id is
    ``wid[w]``, their published processes and speed ``procs[w]`` and
    ``speed[w]``). Failures and rejoins are events on ticks 1 to
    ``horizon``; what happened before tick 0 is the start state."""

    wid: list  # bytes id per worker (None: the row holds no worker)
    procs: list  # int published processes per worker
    speed: list  # float published speed per worker
    down_ticks: int  # ticks a failed worker stays away
    horizon: int
    #: bool[W] down at tick 0; of them, those purged before it (no row)
    down0: np.ndarray
    purged0: np.ndarray
    #: f64[W] each worker's heartbeat stamp at the start: its last beat
    #: before tick 0, or before its failure where it is down
    start_hb: np.ndarray
    first_fail: np.ndarray  # i64[W] each worker's first failure tick >= 1
    fail_w: np.ndarray  # i64 failing worker per event, by tick
    fail_next: np.ndarray  # i64 that worker's next failure tick
    fail_off: np.ndarray  # events of tick k: fail_off[k]:fail_off[k + 1]
    rejoin_w: np.ndarray  # i64 rejoining worker per event, by tick
    rejoin_off: np.ndarray
    hb_workers: list  # per heartbeat phase the workers beating then


def draw_churn(rng: np.random.Generator, config: dict, fleet: Fleet,
               rows: np.ndarray, phase: np.ndarray, hb_period: int) -> Churn:
    """The failure schedule of ``config["churn"]``, and the fleet's state
    at tick 0 under it.

    Each worker fails in each tick with probability ``q = 1 - (1 -
    fail_per_s) ** tick_period_s`` while up (so a share ``fail_per_s`` of
    the live workers fails in a virtual second) and stays down for
    ``down_ticks = ceil(down_s / tick_period_s)`` ticks. The start is the
    steady state of that alternation: a worker is down with probability
    ``down_ticks / (down_ticks + 1 / q)``, for a number of ticks uniform
    below ``down_ticks``; an up worker's first failure is a geometric
    draw (the time to it has no memory). A down worker sent its last
    heartbeat on the last tick of its phase before its failure; where that
    stamp has expired by tick 0 the dispatcher has purged it already (no
    row, no call), else it holds its row and calls that never report. An
    up worker's last beat is the last tick of its phase before tick 0, so
    the workers that fail before their first beat do not all expire on one
    tick."""
    c = config["churn"]
    dt = float(config["tick_period_s"])
    tte = float(config["time_to_expire_s"])
    fail, down = float(c["fail_per_s"]), float(c["down_s"])
    if not 0.0 < fail < 1.0:
        raise ValueError(f"churn.fail_per_s must lie in (0, 1): {fail}")
    if not down > tte:
        raise ValueError(
            f"churn.down_s ({down}) must be above time_to_expire_s ({tte}):"
            " a worker back before it expires is never purged, and its "
            "lost calls would hang (the reconnect protocol, another "
            "deployment)")
    W = len(fleet.speed)
    horizon = CHECK_HORIZON
    q = -math.expm1(dt * math.log1p(-fail))
    dk = math.ceil(round(down / dt, 9))
    n = len(rows)
    down0 = rng.random(n) < dk / (dk + 1.0 / q)
    elapsed = rng.integers(0, dk, n)
    nxt = np.where(down0, -elapsed, rng.geometric(q, n)).astype(np.int64)
    first0 = nxt.copy()
    ticks, who = [], []
    while True:
        on = nxt <= horizon
        if not on.any():
            break
        ticks.append(nxt[on])
        who.append(rows[on])
        nxt = np.where(on, nxt + dk + rng.geometric(q, n), horizon + 1)
    f_tick = np.concatenate(ticks).astype(np.int64)
    f_w = np.concatenate(who).astype(np.int64)

    big = np.iinfo(np.int64).max
    # each failure's next one of the same worker
    o = np.lexsort((f_tick, f_w))
    f_next = np.full(len(f_tick), big, dtype=np.int64)
    same = f_w[o][1:] == f_w[o][:-1]
    f_next[o[:-1][same]] = f_tick[o][1:][same]
    later = f_tick >= 1
    first_fail = np.full(W, big, dtype=np.int64)
    np.minimum.at(first_fail, f_w[later], f_tick[later])
    o = np.lexsort((f_w[later], f_tick[later]))
    fail_tick = f_tick[later][o]
    all_ticks = np.arange(horizon + 2)
    r_tick = f_tick + dk
    r_on = r_tick <= horizon
    o_r = np.lexsort((f_w[r_on], r_tick[r_on]))

    # the start: each worker's last beat before tick 0 (a down one's before
    # its failure), the down ones, whether already purged
    d0 = np.zeros(W, dtype=bool)
    d0[rows[down0]] = True
    start_hb = np.zeros(W, dtype=np.float64)
    before = np.where(down0, first0, 0)
    last = before - 1 - np.mod(before - 1 - phase, hb_period)
    start_hb[rows] = last * dt
    stamp = start_hb.astype(np.float32)
    purged0 = d0 & (np.float32(0.0) - stamp > np.float32(tte))
    hb_workers = [[] for _ in range(hb_period)]
    for r, p in zip(rows.tolist(), phase.tolist()):
        hb_workers[p].append(r)
    return Churn(
        wid=list(fleet.ids), procs=fleet.procs.tolist(),
        speed=fleet.speed.tolist(), down_ticks=dk, horizon=horizon,
        down0=d0, purged0=purged0, start_hb=start_hb, first_fail=first_fail,
        fail_w=f_w[later][o], fail_next=f_next[later][o],
        fail_off=np.searchsorted(fail_tick, all_ticks),
        rejoin_w=f_w[r_on][o_r],
        rejoin_off=np.searchsorted(r_tick[r_on][o_r], all_ticks),
        hb_workers=hb_workers,
    )


class ChurnView:
    """Who is down, tick by tick, as the inputs see it (the loop, the
    reference and the control each keep one): :meth:`step` applies a
    tick's failures and returns its rejoining workers."""

    def __init__(self, ch: Churn) -> None:
        self.ch = ch
        self.down = ch.down0.tolist()
        self.next_fail = ch.first_fail.tolist()

    def step(self, k: int) -> list[int]:
        ch = self.ch
        if k > ch.horizon:
            return []
        a, b = ch.fail_off[k], ch.fail_off[k + 1]
        for w, nf in zip(ch.fail_w[a:b].tolist(),
                         ch.fail_next[a:b].tolist()):
            self.down[w] = True
            self.next_fail[w] = nf
        back = ch.rejoin_w[ch.rejoin_off[k]:ch.rejoin_off[k + 1]].tolist()
        for w in back:
            self.down[w] = False
        return back

    def beating(self, k: int, hb_period: int) -> list:
        """The ids of the workers whose heartbeat falls on tick ``k``."""
        down, wid = self.down, self.ch.wid
        return [wid[w] for w in self.ch.hb_workers[k % hb_period]
                if not down[w]]

    def lost(self, w: int, due: int) -> bool:
        """Whether a call on worker ``w`` (-1: none) due on tick ``due``
        never reports: the worker is down, or fails by then."""
        return w < 0 or self.down[w] or self.next_fail[w] <= due


def due_after(tick: int, size: float, inv_speed: float, dt: float) -> int:
    """:meth:`Traffic.due_tick` for a worker of the given 1/speed."""
    return tick + max(1, math.ceil(size * inv_speed / dt))
