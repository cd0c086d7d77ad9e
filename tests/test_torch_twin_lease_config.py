"""Twins of tests/test_lease_config.py: the published lease cadence read
by the port's base, local and tpu-push (``device="cpu"``) dispatchers
(``test_torch_host_copies.load_twins`` with ``dispatcher_on_cpu``)."""

import pytest

from test_torch_host_copies import (  # noqa: F401
    check_ports_dispatcher,
    dispatcher_on_cpu,
    load_twins,
)

globals().update(load_twins("test_lease_config.py", {}))
pytestmark = pytest.mark.usefixtures("dispatcher_on_cpu")


def test_twin_builds_the_ports_dispatcher():
    from tpu_faas_torch.dispatch.tpu_push import TpuPushDispatcher

    assert LocalDispatcher.__module__ == "tpu_faas_torch.dispatch.local"
    check_ports_dispatcher(TpuPushDispatcher(ip="127.0.0.1", port=0,
                                             store=MemoryStore()))
