"""Twins of tests/test_admission.py against ``tpu_faas_torch/admission``,
the port's gateway, its client SDKs (sync and asyncio) and the port's
dispatcher on the CPU (``test_torch_host_copies.load_twins``, with
``dispatcher_on_cpu``)."""

import pytest

from test_torch_host_copies import dispatcher_on_cpu, load_twins  # noqa: F401

globals().update(load_twins("test_admission.py", {}))
pytestmark = pytest.mark.usefixtures("dispatcher_on_cpu")


def test_twin_gateway_is_the_ports():
    assert start_gateway_thread.__module__ == "tpu_faas_torch.gateway.app"
    assert MemoryStore.__module__ == "tpu_faas_torch.store.memory"
