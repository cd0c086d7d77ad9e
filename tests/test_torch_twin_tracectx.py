"""Twins of tests/test_tracectx.py against ``tpu_faas_torch/obs``
(``test_torch_host_copies.load_twins``), the dispatcher cases on the port's
dispatcher on the CPU (``dispatcher_on_cpu``); the gateway case is left
out."""

import pytest

from test_torch_host_copies import dispatcher_on_cpu, load_twins

globals().update(load_twins("test_tracectx.py", {
    "test_gateway_e2e_slo_source_filters_to_completed": "starts a gateway",
}))
pytestmark = pytest.mark.usefixtures("dispatcher_on_cpu")
