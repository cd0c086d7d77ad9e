"""One jittered-exponential retry policy for every backoff loop.

Three hand-rolled copies grew in the tree — the SDK's overload retries
(sync and async), the pull worker's blob-fetch poll, and the replica
link's reconnect loop. They agreed on shape (multiplicative growth, a
cap, jitter so a rejected burst doesn't re-arrive as the same
synchronized burst) but not on numbers or code. This module is the
single policy they all share; call sites keep their own constants by
instantiating :class:`BackoffPolicy` with site-specific knobs.

Two layers:

- :class:`BackoffPolicy` — frozen, stateless math: attempt number in,
  delay out. Safe to share across threads and to hoist to module level.
- :class:`Backoff` — a tiny stateful counter over a policy for loops
  that can't carry their own attempt index (e.g. the replica link,
  which must *reset* after a successful sync so a fresh outage retries
  fast instead of inheriting a stale long delay).

Jitter uses the module-level ``random`` by default; pass ``rng`` for a
seeded stream in tests.
"""
from __future__ import annotations

import random as _random
from dataclasses import dataclass

__all__ = ["BackoffPolicy", "Backoff"]


@dataclass(frozen=True)
class BackoffPolicy:
    """Jittered exponential backoff: ``floor_s * factor**attempt``,
    capped at ``cap_s``, scaled by ``uniform(jitter_lo, jitter_hi)``.

    ``jitter_lo == jitter_hi == 1.0`` disables jitter (deterministic
    delays, e.g. the async connect loop whose retries are budget-clamped
    by the caller's deadline rather than spread by jitter).
    """

    floor_s: float = 0.25
    factor: float = 2.0
    cap_s: float = 30.0
    jitter_lo: float = 0.8
    jitter_hi: float = 1.3

    def base(self, attempt: int, hint: float | None = None) -> float:
        """Un-jittered delay for 0-based ``attempt``. ``hint`` is a
        server-provided lower bound (Retry-After): the schedule never
        sleeps less than the server asked for, but still grows past it
        once the local exponential overtakes the hint."""
        b = min(self.floor_s * self.factor**attempt, self.cap_s)
        if hint is not None:
            b = max(b, hint)
        return b

    def jitter(self, delay_s: float, rng=_random) -> float:
        """Multiplicative jitter on an already-computed delay. Exposed
        separately so callers that clamp to a deadline budget can clamp
        the base and jitter the clamped value (the async SDK)."""
        if self.jitter_lo == 1.0 and self.jitter_hi == 1.0:
            return delay_s
        return delay_s * rng.uniform(self.jitter_lo, self.jitter_hi)

    def delay(
        self,
        attempt: int,
        hint: float | None = None,
        clamp: float | None = None,
        rng=_random,
    ) -> float:
        """Full pipeline: base(attempt, hint) → clamp → jitter.

        ``clamp`` bounds the *base* delay (deadline budget); jitter is
        applied after, matching the pre-existing call-site semantics
        where a deadline-clamped sleep could still jitter slightly past
        the budget rather than silently under-sleeping the server hint.
        """
        b = self.base(attempt, hint)
        if clamp is not None:
            b = min(b, max(0.0, clamp))
        return self.jitter(b, rng)


class Backoff:
    """Stateful attempt counter over a :class:`BackoffPolicy`."""

    def __init__(self, policy: BackoffPolicy | None = None, rng=_random):
        self.policy = policy if policy is not None else BackoffPolicy()
        self.rng = rng
        self.attempt = 0

    def peek(self) -> float:
        """Un-jittered delay the next :meth:`next` call will start from
        (useful as the default when parsing a server Retry-After)."""
        return self.policy.base(self.attempt)

    def next(
        self, hint: float | None = None, clamp: float | None = None
    ) -> float:
        """Return the next delay and advance the attempt counter."""
        d = self.policy.delay(self.attempt, hint, clamp, rng=self.rng)
        self.attempt += 1
        return d

    def reset(self) -> None:
        self.attempt = 0
