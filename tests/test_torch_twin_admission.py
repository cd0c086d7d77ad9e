"""Twins of tests/test_admission.py against ``tpu_faas_torch/admission``,
the port's gateway, its client SDKs (sync and asyncio) and the port's
dispatcher on the CPU (``test_torch_host_copies.load_twins``, with
``dispatcher_on_cpu``)."""

import pytest

from test_torch_host_copies import (  # noqa: F401
    dispatcher_on_cpu,
    frozen_heap,
    load_twins,
)

globals().update(load_twins("test_admission.py", {}))
pytestmark = pytest.mark.usefixtures("dispatcher_on_cpu")
# the one case that times a single request against a bound (100 ms) runs
# with the worker's heap frozen: a full collection of what earlier test
# files left in the process stalls every thread for longer (ROADMAP C.9)
test_gateway_store_breaker_fast_fails_under_100ms = pytest.mark.usefixtures(
    "frozen_heap")(test_gateway_store_breaker_fast_fails_under_100ms)


def test_twin_gateway_is_the_ports():
    assert start_gateway_thread.__module__ == "tpu_faas_torch.gateway.app"
    assert MemoryStore.__module__ == "tpu_faas_torch.store.memory"
