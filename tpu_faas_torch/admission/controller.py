"""Gateway-side admission controller: quotas, bounded inflight, brownout.

Every decision is pure CPU over cached state — the reject path must cost
microseconds precisely when the system can least afford more work. The
store is touched only by the periodic health refresh (one HGETALL, rate-
limited by ``health_ttl`` and funneled through the gateway's circuit
breaker), which the HANDLERS drive: the controller itself never blocks.

Decision order — stateless checks before stateful charges:

1. **Bounded system inflight + priority brownout** (pure reads): the
   in-system task estimate is compared against the bound. Below
   ``brownout_start`` everything is admitted; in the brownout band the
   lowest-priority tasks are shed first — honoring the documented hint
   ("priority: higher admitted first under overload"): first
   below-default (< 0) priorities, then default (<= 0), and at or past
   the bound everything. ``Retry-After`` is computed from the fleet's
   measured drain rate: how long until the backlog is back under the
   brownout threshold, not a magic constant.
2. **Per-client quota** (token bucket on the ``X-Client-Id`` header, off
   unless configured): one abusive client is clipped even when the fleet
   is healthy. Checked second so an overload reject consumes NO tokens —
   a client backing off through a saturated window must not emerge from
   it quota-broke for work it never got in.

The in-system estimate is the max of two views, each covering the other's
blind spot: the fleet snapshot (dispatcher-published; blind to tasks
still buffered in announce subscriptions when dispatcher queues are full)
and the store's live-task index count (``LIVE_INDEX_KEY`` — maintained by
every create/terminal write, so it counts bus-buffered and
foreign-producer tasks too). Both are RE-READ every ``health_ttl``, so
neither can drift over time — a running ledger of submits minus finish
announces was rejected here precisely because the announce channel is
lossy by design and a max() over a drifting ledger ratchets upward
forever. ``admitted_since_refresh`` bridges the staleness window so a
burst cannot blow past the bound between two refreshes.

Fail-open on a missing signal: with no snapshot AND no configured bound
there is nothing to compare against, and only quotas apply — the store
circuit breaker (admission's sibling) still protects against the one
failure mode that needs no signal to detect.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass


@dataclass(frozen=True)
class AdmissionDecision:
    admitted: bool
    #: reject taxonomy: "quota" | "brownout" | "saturated" — retryable,
    #: carry Retry-After — plus "quota_exceeds_burst", a PERMANENT
    #: condition (batch larger than the bucket can ever hold) the gateway
    #: maps to a non-retryable 400 (store_unavailable is the breaker's
    #: reason, not the controller's)
    reason: str = ""
    #: seconds a client should wait before retrying (whole seconds; the
    #: gateway copies it into the 429's Retry-After header)
    retry_after: float = 1.0
    #: in-system load over the bound at decision time (observability)
    load: float = 0.0


class TokenBucket:
    """Classic token bucket: ``rate`` tokens/s refill up to ``burst``."""

    __slots__ = ("rate", "burst", "tokens", "stamp")

    def __init__(self, rate: float, burst: float, now: float) -> None:
        self.rate = float(rate)
        self.burst = float(burst)
        self.tokens = float(burst)
        self.stamp = now

    def take(self, n: float, now: float) -> bool:
        elapsed = max(0.0, now - self.stamp)
        self.stamp = now
        self.tokens = min(self.burst, self.tokens + elapsed * self.rate)
        if self.tokens >= n:
            self.tokens -= n
            return True
        return False

    def wait_for(self, n: float) -> float:
        """Seconds until ``n`` tokens will be available at the current
        fill level (the quota reject's honest Retry-After)."""
        if self.rate <= 0:
            return 60.0
        return max(0.0, (n - self.tokens) / self.rate)


@dataclass
class AdmissionConfig:
    #: hard bound on tasks in the system; None derives one from the fleet
    #: snapshot (capacity * queue_factor) and, with no snapshot either,
    #: disables the bound (fail open)
    max_system_inflight: int | None = None
    #: derived bound = live process slots * this (how many queued seconds
    #: of work the operator tolerates, roughly, in units of "one task per
    #: slot"); floored at min_derived_bound so a tiny dev fleet isn't
    #: strangled
    queue_factor: float = 16.0
    min_derived_bound: int = 256
    #: brownout band: [start, hard) sheds priority < 0, [hard, 1.0) sheds
    #: priority <= 0, >= 1.0 sheds everything
    brownout_start: float = 0.75
    brownout_hard: float = 0.90
    #: per-client token bucket (X-Client-Id); None disables quotas
    quota_rate: float | None = None
    quota_burst: float | None = None  # default: 2 * quota_rate
    #: how long a fleet-health snapshot stays fresh before handlers
    #: re-read it from the store
    health_ttl: float = 1.0
    #: Retry-After fallback when no drain rate is known, and its cap
    default_retry_after: float = 2.0
    max_retry_after: float = 30.0
    #: bucket table bound (evict-oldest): client ids are caller-controlled
    max_clients: int = 10_000


class AdmissionController:
    """One per gateway app. Handlers call :meth:`admit` before any store
    work; the event loop owns all mutation (no internal locking — the
    aiohttp handlers all run on one loop; ``update_health`` may also be
    called from tests directly)."""

    def __init__(
        self,
        config: AdmissionConfig | None = None,
        clock=time.monotonic,
    ) -> None:
        self.config = config or AdmissionConfig()
        self.clock = clock
        self._health = None  # FleetHealth | None
        self._live: int | None = None  # live-task index count at refresh
        self._health_at: float | None = None  # clock() of last refresh
        self._refreshing = False
        self._admitted_since_refresh = 0
        self._buckets: dict[str, TokenBucket] = {}
        self.last_load = 0.0
        self.n_admitted = 0
        self.n_rejected = 0

    # -- health refresh plumbing (driven by the gateway handlers) ----------
    def needs_refresh(self) -> bool:
        """True when the cached snapshot is stale AND nobody is already
        refreshing — exactly one handler pays the store read per TTL; the
        rest decide on the cached value."""
        if self._refreshing:
            return False
        if self._health_at is None:
            return True
        return self.clock() - self._health_at >= self.config.health_ttl

    def begin_refresh(self) -> None:
        self._refreshing = True

    def update_health(self, health, live_in_system: int | None = None) -> None:
        """Install a fresh FleetHealth (or None when no dispatcher
        publishes) plus the store's live-task index count. Resets the
        since-refresh admit counter — the fresh reads now reflect (most
        of) those tasks. Finishes inside the next TTL window are ignored
        (conservative by at most one window of drain)."""
        self._health = health
        self._live = live_in_system
        self._health_at = self.clock()
        self._refreshing = False
        self._admitted_since_refresh = 0

    def refresh_failed(self) -> None:
        """Store read failed: keep deciding on the stale snapshot (and the
        local estimate); re-arm the TTL so the next handler retries after
        a full period rather than hammering a dead store."""
        self._health_at = self.clock()
        self._refreshing = False

    # -- the decision ------------------------------------------------------
    def _bound(self) -> int | None:
        cfg = self.config
        if cfg.max_system_inflight is not None:
            return cfg.max_system_inflight
        if self._health is not None and self._health.capacity > 0:
            return max(
                cfg.min_derived_bound,
                int(self._health.capacity * cfg.queue_factor),
            )
        return None

    def _in_system(self) -> int:
        est = 0
        if self._health is not None:
            est = self._health.in_system
        if self._live is not None:
            est = max(est, self._live)
        return est + self._admitted_since_refresh

    def _retry_after(self, in_system: int, bound: int) -> float:
        """Seconds until the backlog is back under the brownout threshold
        at the measured drain rate — honest backpressure, not a constant."""
        cfg = self.config
        excess = in_system - cfg.brownout_start * bound
        drain = self._health.drain_rate if self._health is not None else 0.0
        if drain > 1e-3:
            ra = excess / drain
        else:
            ra = cfg.default_retry_after
        return float(
            min(cfg.max_retry_after, max(1.0, math.ceil(ra)))
        )

    def admit(
        self,
        n: int = 1,
        priority: int = 0,
        client_id: str | None = None,
    ) -> AdmissionDecision:
        """Decide on ``n`` tasks at ``priority`` from ``client_id``.
        Batches decide atomically — callers pass the batch's LOWEST
        priority, so a batch is only admitted where its weakest member
        would be (shed-lowest-first stays monotonic).

        Order: saturation/brownout FIRST (pure reads — they mutate
        nothing), quota second (token consumption — the one stateful
        charge), commit last. An overload reject therefore costs a
        client NO quota tokens: a well-behaved retrier backing off
        through a saturated window must not emerge from it already
        quota-broke for work it never got in."""
        cfg = self.config
        now = self.clock()

        bound = self._bound()
        if bound is not None and bound > 0:
            in_system = self._in_system()
            load = in_system / bound
            self.last_load = load
            if load >= 1.0:
                self.n_rejected += n
                return AdmissionDecision(
                    False,
                    reason="saturated",
                    retry_after=self._retry_after(in_system, bound),
                    load=load,
                )
            if (load >= cfg.brownout_hard and priority <= 0) or (
                load >= cfg.brownout_start and priority < 0
            ):
                self.n_rejected += n
                return AdmissionDecision(
                    False,
                    reason="brownout",
                    retry_after=self._retry_after(in_system, bound),
                    load=load,
                )
        else:
            self.last_load = 0.0

        if cfg.quota_rate is not None and client_id is not None:
            bucket = self._buckets.get(client_id)
            if bucket is None:
                burst = (
                    cfg.quota_burst
                    if cfg.quota_burst is not None
                    else 2.0 * cfg.quota_rate
                )
                bucket = TokenBucket(cfg.quota_rate, burst, now)
                self._buckets[client_id] = bucket
                while len(self._buckets) > cfg.max_clients:
                    # evict-oldest (dict insertion order): ids are caller-
                    # controlled and must never grow gateway memory
                    self._buckets.pop(next(iter(self._buckets)))
            if n > bucket.burst:
                # larger than the bucket can EVER hold: no amount of
                # waiting helps, and a finite Retry-After would send the
                # client into a retry loop against a permanent condition
                # — distinct reason, mapped to a non-retryable reply
                self.n_rejected += n
                return AdmissionDecision(
                    False,
                    reason="quota_exceeds_burst",
                    retry_after=0.0,
                    load=self.last_load,
                )
            if not bucket.take(n, now):
                self.n_rejected += n
                return AdmissionDecision(
                    False,
                    reason="quota",
                    retry_after=float(
                        min(
                            cfg.max_retry_after,
                            max(1.0, math.ceil(bucket.wait_for(n))),
                        )
                    ),
                    load=self.last_load,
                )

        self._admitted_since_refresh += n
        self.n_admitted += n
        return AdmissionDecision(True, load=self.last_load)

    def snapshot(self) -> dict:
        """JSON-able state for the gateway's /stats."""
        bound = self._bound()
        health = self._health
        return {
            "bound": bound,
            "live_in_system": self._live,
            "load": round(self.last_load, 4),
            "admitted": self.n_admitted,
            "rejected": self.n_rejected,
            "clients_tracked": len(self._buckets),
            "fleet": None
            if health is None
            else {
                "pending": health.pending,
                "inflight": health.inflight,
                "capacity": health.capacity,
                "drain_rate": round(health.drain_rate, 3),
                "dispatchers": health.dispatchers,
            },
        }
