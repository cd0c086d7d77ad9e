"""Twins of tests/test_admission.py against ``tpu_faas_torch/admission``
and the port's dispatcher on the CPU (``test_torch_host_copies.
load_twins``, with ``dispatcher_on_cpu``); the cases that start a gateway
or drive the SDKs are left out: both stay the JAX package's."""

import pytest

from test_torch_host_copies import dispatcher_on_cpu, load_twins

_GATEWAY = "starts a gateway"
globals().update(load_twins("test_admission.py", {
    "test_gateway_admission_429_with_retry_after_and_priority_override":
        _GATEWAY,
    "test_gateway_oversized_batch_is_400_not_retry_loop": _GATEWAY,
    "test_gateway_brownout_honors_priority_hint": _GATEWAY,
    "test_gateway_deadline_hint_validated_and_stored": _GATEWAY,
    "test_gateway_store_breaker_fast_fails_under_100ms": _GATEWAY,
    "test_sdk_retries_429_honoring_retry_after_and_dedupes": _GATEWAY,
    "test_sdk_raises_after_retry_budget_exhausted": _GATEWAY,
    "test_expired_surfaces_as_task_expired_error": _GATEWAY,
    "test_async_client_retries_and_deadline": _GATEWAY,
}))
pytestmark = pytest.mark.usefixtures("dispatcher_on_cpu")
