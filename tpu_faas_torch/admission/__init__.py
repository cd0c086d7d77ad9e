"""Overload robustness: admission control, backpressure, and fast-fail.

The reference system has no defense against load at all — every submit is
written to the store unconditionally, a saturated scheduler tells no one,
and a dead store turns each request into a hung 5xx. This package is the
admission path the gateway docstring always promised ("priority: higher
admitted first under overload"), in three pieces:

- :mod:`tpu_faas.admission.signal` — the saturation signal: each
  dispatcher publishes a cheap capacity snapshot (pending depth, inflight,
  fleet capacity, measured drain rate) to one store hash every ~second;
  the gateway reads the aggregate, cached.
- :mod:`tpu_faas.admission.controller` — the gateway-side admission
  controller: bounded system inflight with 429 + ``Retry-After`` computed
  from the measured drain rate, priority-aware brownout (lowest priority
  shed first), and per-client token-bucket quotas.
- :mod:`tpu_faas.admission.breaker` — a store circuit breaker: after a
  few consecutive store failures the gateway fast-fails submits with
  503 + ``Retry-After`` instead of hanging every request on a dead store,
  probing half-open until it recovers.

The fourth piece — queue-deadline shedding into the terminal ``EXPIRED``
status — lives with the lifecycle it extends: ``core/task.py``
(``FIELD_DEADLINE``), ``store/base.py expire_task``, and the dispatcher
shed sites in ``dispatch/``.

Design stance: **fail open on missing signal, fail closed on missing
store.** A gateway that cannot read the saturation snapshot admits (the
store writes behind it still backpressure through the breaker); a gateway
whose store is down rejects fast. Admission must never add a store round
trip to the reject path — rejects are pure CPU.
"""

from tpu_faas_torch.admission.breaker import CircuitBreaker, StoreUnavailable
from tpu_faas_torch.admission.controller import (
    AdmissionController,
    AdmissionDecision,
    TokenBucket,
)
from tpu_faas_torch.admission.signal import (
    FLEET_HEALTH_KEY,
    CapacitySnapshot,
    FleetHealth,
    publish_snapshot,
    read_fleet_health,
)

__all__ = [
    "AdmissionController",
    "AdmissionDecision",
    "CapacitySnapshot",
    "CircuitBreaker",
    "FLEET_HEALTH_KEY",
    "FleetHealth",
    "StoreUnavailable",
    "TokenBucket",
    "publish_snapshot",
    "read_fleet_health",
]
