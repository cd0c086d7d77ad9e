"""Twins of the unit part of tests/test_admission.py against
``tpu_faas_torch/admission`` (``test_torch_host_copies.load_twins``); the
cases that drive a dispatcher, a gateway or the SDKs come with the
dispatcher."""

from test_torch_host_copies import load_twins

_DISPATCHER = "drives a dispatcher"
_GATEWAY = "starts a gateway"
globals().update(load_twins("test_admission.py", {
    "test_dispatcher_sheds_lapsed_deadline_and_spares_fresh": _DISPATCHER,
    "test_tpu_push_tick_sheds_expired_before_dispatch": _DISPATCHER,
    "test_dispatcher_publishes_capacity_snapshot": _DISPATCHER,
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
