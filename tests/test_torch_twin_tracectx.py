"""Twins of tests/test_tracectx.py against ``tpu_faas_torch/obs``
(``test_torch_host_copies.load_twins``); the cases that drive a dispatcher
or a gateway come with the dispatcher."""

from test_torch_host_copies import load_twins

_DISPATCHER = "drives a dispatcher"
globals().update(load_twins("test_tracectx.py", {
    "test_note_dispatch_attaches_trace_for_rescan_adopted_task": _DISPATCHER,
    "test_gateway_e2e_slo_source_filters_to_completed": "starts a gateway",
    "test_skipped_timeline_close_normalizes_expired_label": _DISPATCHER,
    "test_dispatcher_scrape_carries_slo_and_trace_families": _DISPATCHER,
}))
