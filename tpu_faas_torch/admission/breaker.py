"""Store circuit breaker: fast-fail instead of hanging on a dead store.

Without it, every request against a dead store pays a connect timeout
(seconds) inside a gateway executor thread — the thread pool saturates,
healthy requests queue behind doomed ones, and the client sees a hang
followed by a 5xx. The breaker converts that into the classic three-state
machine:

- **closed** — normal operation; consecutive outage-family failures are
  counted, successes reset the count.
- **open** — after ``failure_threshold`` consecutive failures: every store
  call is refused IMMEDIATELY (``StoreUnavailable``, which the gateway
  maps to 503 + ``Retry-After``) for ``reset_timeout`` seconds. This is
  the <100 ms fast-fail path: no socket is touched.
- **half-open** — after the timeout, exactly ONE probe call is allowed
  through; its outcome closes or re-opens the breaker. One probe, not a
  thundering herd, so a store struggling back up isn't knocked over by
  the backlog.

Only the outage family (connection/timeout errors — the same set the
dispatchers treat as a transient outage) trips it; a store ERROR reply is
an application bug, not an availability signal.

Failover awareness (store HA, tpu_faas/store/replication.py): with an
endpoint-rotation hook installed (``set_rotate_hook`` — the gateway wires
it to the multi-endpoint store's ``rotate_endpoint``), a FAILED half-open
probe rotates the store client to the next endpoint and stays half-open,
so the very next caller probes the replica immediately instead of
waiting out another full open window against the dead primary. The
rotation budget (endpoints - 1 per window) bounds it: once every other
endpoint has had its immediate probe, the breaker re-opens a fresh
window as before.
"""

from __future__ import annotations

import math
import threading
import time

#: Exceptions that count as "the store is unreachable" — mirrors
#: dispatch.base.STORE_OUTAGE_ERRORS (kept separate so the admission
#: package never imports the dispatcher tree into the gateway process).
OUTAGE_ERRORS = (ConnectionError, TimeoutError)


class StoreUnavailable(Exception):
    """Raised instead of touching a store behind an open breaker (or when
    the call just failed with an outage error). ``retry_after`` is the
    seconds a client should wait before retrying — the gateway copies it
    into the 503's ``Retry-After`` header."""

    def __init__(self, retry_after: float = 1.0) -> None:
        super().__init__(
            f"store unavailable; retry in {retry_after:.0f}s"
        )
        self.retry_after = max(1.0, float(retry_after))


class CircuitBreaker:
    """Thread-safe three-state breaker. ``allow()`` before the call,
    ``record_success()``/``record_failure()`` after — or use the gateway's
    ``GatewayContext.store_call`` wrapper, which does all three."""

    def __init__(
        self,
        failure_threshold: int = 3,
        reset_timeout: float = 5.0,
        clock=time.monotonic,
    ) -> None:
        self.failure_threshold = int(failure_threshold)
        self.reset_timeout = float(reset_timeout)
        self.clock = clock
        self._lock = threading.Lock()
        self._failures = 0
        self._opened_at: float | None = None
        self._probe_in_flight = False
        #: endpoint-rotation hook (set_rotate_hook): called — outside the
        #: lock — when a half-open probe fails with rotation budget left
        self._rotate_hook = None
        self._rotation_budget = 0
        self._rotations_left = 0
        #: monotonic counters for /stats and tests
        self.n_opened = 0
        self.n_fast_failed = 0
        self.n_rotations = 0

    def set_rotate_hook(self, hook, budget: int) -> None:
        """Install the store client's endpoint rotation as the failed-probe
        reaction. ``budget`` is how many immediate endpoint probes one
        open window may spend (endpoints - 1: each OTHER endpoint gets
        one) before the breaker falls back to a fresh open window."""
        with self._lock:
            self._rotate_hook = hook
            self._rotation_budget = max(0, int(budget))
            self._rotations_left = self._rotation_budget

    @property
    def state(self) -> str:
        with self._lock:
            return self._state_locked()

    def _state_locked(self) -> str:
        if self._opened_at is None:
            return "closed"
        if self.clock() - self._opened_at >= self.reset_timeout:
            return "half_open"
        return "open"

    @property
    def is_open(self) -> bool:
        return self.state != "closed"

    def allow(self) -> bool:
        """True when the caller may touch the store now. In half-open,
        exactly one caller at a time gets True (the probe); everyone else
        keeps fast-failing until its outcome lands."""
        with self._lock:
            state = self._state_locked()
            if state == "closed":
                return True
            if state == "half_open" and not self._probe_in_flight:
                self._probe_in_flight = True
                return True
            self.n_fast_failed += 1
            return False

    def record_success(self) -> None:
        with self._lock:
            self._failures = 0
            self._opened_at = None
            self._probe_in_flight = False
            self._rotations_left = self._rotation_budget

    def record_aborted(self) -> None:
        """The call ended without a store verdict (cancelled request, a
        non-outage exception mid-flight): release the half-open probe
        slot WITHOUT counting success or failure. Without this, a probe
        aborted by anything outside the outage family would leave
        ``_probe_in_flight`` set forever — and since every other caller
        fast-fails while it is set, nothing could ever reset it: the
        breaker would be wedged open past the store's recovery."""
        with self._lock:
            self._probe_in_flight = False

    def record_failure(self) -> None:
        rotate = None
        with self._lock:
            was_probe = self._probe_in_flight
            self._probe_in_flight = False
            self._failures += 1
            if self._opened_at is None:
                if self._failures >= self.failure_threshold:
                    self._opened_at = self.clock()
                    self.n_opened += 1
            elif was_probe:
                if self._rotate_hook is not None and self._rotations_left > 0:
                    # failover awareness: the probe may have died against
                    # the dead PRIMARY — rotate the client to the next
                    # endpoint and STAY half-open (``_opened_at`` is
                    # untouched, already past the window), so the next
                    # caller probes the replica immediately instead of
                    # waiting out another full open window
                    self._rotations_left -= 1
                    self.n_rotations += 1
                    rotate = self._rotate_hook
                else:
                    # the half-open probe failed with no endpoint left to
                    # try this window: re-open with a fresh window (and a
                    # fresh rotation budget for the next one)
                    self._opened_at = self.clock()
                    self.n_opened += 1
                    self._rotations_left = self._rotation_budget
            # else: a STRAGGLER — a call already in flight when the
            # breaker opened, landing late. It proves nothing the open
            # state doesn't already assume, and restarting the window on
            # each one (slow connect timeouts can land seconds apart)
            # would push the recovery probe out indefinitely
        if rotate is not None:
            # outside the lock: the hook takes the store client's own lock
            # (socket teardown), and nesting the two here would impose a
            # cross-module lock order nothing else needs
            rotate()

    def retry_after(self) -> float:
        """Client-facing wait: the remaining open window (at least 1 s,
        whole seconds — HTTP Retry-After is delay-seconds)."""
        with self._lock:
            if self._opened_at is None:
                return 1.0
            remaining = self.reset_timeout - (self.clock() - self._opened_at)
            return float(max(1, math.ceil(remaining)))

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "state": self._state_locked(),
                "consecutive_failures": self._failures,
                "times_opened": self.n_opened,
                "fast_failed": self.n_fast_failed,
                "endpoint_rotations": self.n_rotations,
            }
