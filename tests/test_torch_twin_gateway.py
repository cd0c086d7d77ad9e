"""Twins of tests/test_gateway.py: the REST contract held by the port's
gateway (``tpu_faas_torch/gateway/app.py``) over the port's stores
(``test_torch_host_copies.load_twins``)."""

from test_torch_host_copies import load_twins

globals().update(load_twins("test_gateway.py", {}))


def test_twin_builds_the_ports_gateway():
    assert start_gateway_thread.__module__ == "tpu_faas_torch.gateway.app"
    assert MemoryStore.__module__ == "tpu_faas_torch.store.memory"
