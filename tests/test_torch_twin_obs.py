"""Twins of tests/test_obs.py against ``tpu_faas_torch/obs``, the copies it
reads and the port's dispatcher on the CPU (``test_torch_host_copies.
load_twins``, with ``dispatcher_on_cpu`` on every case); the cases that
start a gateway or worker processes are left out."""

import pytest

from test_torch_host_copies import dispatcher_on_cpu, load_twins

_GATEWAY = "starts a gateway"
globals().update(load_twins("test_obs.py", {
    "test_trace_endpoint_full_stack_e2e": "starts a stack with workers",
    "test_cross_process_trace_assembly_e2e": "starts worker processes",
    "test_gateway_trace_off_runs_unchanged": _GATEWAY,
    "test_gateway_readyz_liveness_vs_readiness": _GATEWAY,
}))
pytestmark = pytest.mark.usefixtures("dispatcher_on_cpu")
