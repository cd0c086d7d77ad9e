"""Twin of tests/test_overload_chaos.py: admission under a burst past its
bound with a worker SIGKILLed, through the port's gateway, admission
controller, client SDK, tpu-push dispatcher (``device="cpu"``) and push
worker processes (``test_torch_host_copies.load_twins``)."""

from test_torch_host_copies import (
    check_ports_dispatcher,
    cpu_dispatcher,
    load_twins,
)

globals().update(load_twins(
    "test_overload_chaos.py", {},
    overrides={"TpuPushDispatcher": cpu_dispatcher()},
    twins=("test_workers_e2e",),
))


def test_twin_builds_the_ports_dispatcher():
    from tpu_faas_torch.store.memory import MemoryStore

    assert FaaSClient.__module__ == "tpu_faas_torch.client.sdk"
    check_ports_dispatcher(TpuPushDispatcher(ip="127.0.0.1", port=0,
                                             store=MemoryStore()))
