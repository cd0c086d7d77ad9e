"""Twins of tests/test_obs.py against ``tpu_faas_torch/obs`` and the copies
it reads (``test_torch_host_copies.load_twins``); the cases that drive a
dispatcher, a gateway or workers come with the dispatcher."""

from test_torch_host_copies import load_twins

_DISPATCHER = "drives a dispatcher"
_GATEWAY = "starts a gateway"
globals().update(load_twins("test_obs.py", {
    "test_dispatcher_metrics_and_trace_http_endpoints": _DISPATCHER,
    "test_tick_profiler_steady_state_stays_flat": _DISPATCHER,
    "test_trace_endpoint_full_stack_e2e": "starts a stack with workers",
    "test_cross_process_trace_assembly_e2e": "starts worker processes",
    "test_gateway_trace_off_runs_unchanged": _GATEWAY,
    "test_gateway_readyz_liveness_vs_readiness": _GATEWAY,
    "test_dispatcher_readyz_and_slo_endpoints": _DISPATCHER,
}))
