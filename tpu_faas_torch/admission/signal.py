"""The saturation signal: dispatcher capacity snapshots through the store.

Each dispatcher already computes everything an admission controller needs
for its ``/stats`` endpoint — pending depth, inflight count, fleet
capacity, results per second. This module gives those numbers one tiny
wire format and one store hash (``FLEET_HEALTH_KEY``: field =
dispatcher_id, value = encoded snapshot) so any number of gateways can
read the fleet's aggregate load with ONE ``HGETALL`` — no new service, no
new port, and the snapshot survives gateway restarts because it lives
where all durable state lives.

Publishing rides the dispatcher's serve loop (~1 Hz,
``TaskDispatcher.maybe_publish_capacity``); one small hash write per
second is noise next to the data plane. Readers skip entries whose stamp
has gone stale (a dead dispatcher must not pin its last backlog forever)
and garbage-collect entries that are ancient, mirroring the liveness
registry's policy (``read_live_dispatchers``).
"""

from __future__ import annotations

import time
from dataclasses import dataclass

#: Store hash: field = dispatcher_id, value = CapacitySnapshot.encode().
FLEET_HEALTH_KEY = "fleet:health"

#: Entries older than this are ignored by readers — a crashed dispatcher's
#: final snapshot must stop counting once anything else could have
#: re-adopted (or drained) its queue. Several publish periods long, so one
#: missed publish (store blip) doesn't flap the signal.
STALE_AFTER_S = 10.0

#: Readers HDEL entries older than this in passing (same pattern as the
#: dispatcher liveness registry): the hash is read whole on every refresh
#: and must stay bounded by the live fleet, not by restarts-ever.
_ANCIENT_AFTER_S = 20 * STALE_AFTER_S

_VERSION = "v1"


@dataclass(frozen=True)
class CapacitySnapshot:
    """One dispatcher's load picture at ``published_at`` (epoch seconds).

    ``capacity`` is the fleet's total live process slots (busy + free);
    ``drain_rate`` is the dispatcher's measured results/second (EWMA), the
    denominator for honest ``Retry-After`` arithmetic."""

    pending: int
    inflight: int
    capacity: int
    drain_rate: float
    published_at: float

    def encode(self) -> str:
        return (
            f"{_VERSION}:{int(self.pending)}:{int(self.inflight)}:"
            f"{int(self.capacity)}:{self.drain_rate:.6g}:"
            f"{self.published_at!r}"
        )

    @classmethod
    def decode(cls, raw: str) -> "CapacitySnapshot | None":
        """None on any malformed value (foreign producer, version skew) —
        a garbled snapshot must degrade the signal, never crash a reader."""
        parts = raw.split(":")
        if len(parts) != 6 or parts[0] != _VERSION:
            return None
        try:
            return cls(
                pending=int(parts[1]),
                inflight=int(parts[2]),
                capacity=int(parts[3]),
                drain_rate=float(parts[4]),
                published_at=float(parts[5]),
            )
        except ValueError:
            return None


@dataclass(frozen=True)
class FleetHealth:
    """Aggregate over every fresh dispatcher snapshot."""

    pending: int
    inflight: int
    capacity: int
    drain_rate: float
    dispatchers: int
    freshest_at: float

    @property
    def in_system(self) -> int:
        """Tasks the fleet knows about that have not finished: queued at
        dispatchers + on workers. (Tasks still buffered in announce
        subscriptions are invisible here — the gateway folds in its own
        local estimate for exactly that gap; see AdmissionController.)"""
        return self.pending + self.inflight


def publish_snapshot(store, dispatcher_id: str, snap: CapacitySnapshot) -> None:
    """One small hash write; raises on a store outage (callers treat it
    like any other store write and retry next period)."""
    store.hset(FLEET_HEALTH_KEY, {dispatcher_id: snap.encode()})


def read_fleet_health(
    store,
    now: float | None = None,
    stale_after: float = STALE_AFTER_S,
) -> FleetHealth | None:
    """Aggregate the fresh snapshots; None when none exist (no publishing
    dispatcher yet — admission fails open on the missing signal). Ancient
    entries are HDEL'd in passing so the hash stays bounded."""
    entries = store.hgetall(FLEET_HEALTH_KEY)
    now_f = now if now is not None else time.time()
    pending = inflight = capacity = n = 0
    drain = 0.0
    freshest = 0.0
    ancient: list[str] = []
    for did, raw in entries.items():
        snap = CapacitySnapshot.decode(raw)
        if snap is None:
            # undecodable is NOT deletable: during a rolling upgrade a
            # newer-format dispatcher publishes entries this reader can't
            # parse, and GC'ing them would have every old gateway fight
            # the new fleet's signal (ignore-but-keep degrades to
            # fail-open for this reader only). The hash stays bounded by
            # live publishers; true garbage is the operator's to clean.
            continue
        age = now_f - snap.published_at
        if age > _ANCIENT_AFTER_S:
            ancient.append(did)
            continue
        if age > stale_after:
            continue
        pending += snap.pending
        inflight += snap.inflight
        capacity += snap.capacity
        drain += snap.drain_rate
        freshest = max(freshest, snap.published_at)
        n += 1
    if ancient:
        store.hdel(FLEET_HEALTH_KEY, *ancient)
    if n == 0:
        return None
    return FleetHealth(
        pending=pending,
        inflight=inflight,
        capacity=capacity,
        drain_rate=drain,
        dispatchers=n,
        freshest_at=freshest,
    )
