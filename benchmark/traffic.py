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

    def due_tick(self, tick: int, size: float, row: int) -> int:
        """The tick on which a call of ``size`` placed on ``row`` at
        ``tick`` reports its result: its runtime in ticks, at least one."""
        return tick + max(1, math.ceil(size * self.inv_speed[row] / self.dt))
