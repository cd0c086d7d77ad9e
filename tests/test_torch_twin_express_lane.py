"""Twins of tests/test_express_lane.py: the inline result announce, the
gateway's long-poll, ``/results/wait`` and SSE contracts, and the SDK's
``wait_many`` against the port's store, gateway and client SDKs (sync and
asyncio), and the port's tpu-push dispatcher (``device="cpu"``) in express
mode serving the port's push worker process
(``test_torch_host_copies.load_twins`` with ``dispatcher_on_cpu``)."""

import pytest

from test_torch_host_copies import (  # noqa: F401
    check_ports_dispatcher,
    cpu_dispatcher,
    dispatcher_on_cpu,
    load_twins,
)

globals().update(load_twins("test_express_lane.py", {},
                            twins=("test_workers_e2e",)))
pytestmark = pytest.mark.usefixtures("dispatcher_on_cpu")


def test_twin_builds_the_ports_dispatcher():
    from tpu_faas_torch.dispatch.tpu_push import TpuPushDispatcher

    assert start_gateway_thread.__module__ == "tpu_faas_torch.gateway.app"
    assert AsyncFaaSClient.__module__ == "tpu_faas_torch.client.aio"
    check_ports_dispatcher(TpuPushDispatcher(
        ip="127.0.0.1", port=0, store=MemoryStore(), express=True))
