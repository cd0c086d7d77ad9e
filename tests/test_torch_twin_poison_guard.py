"""Twins of tests/test_poison_guard.py: the retry cap and the zombie-result
freeze in the port's push and tpu-push (``device="cpu"``) dispatchers
(``test_torch_host_copies.load_twins``)."""

from test_torch_host_copies import (
    check_ports_dispatcher,
    cpu_dispatcher,
    load_twins,
)

globals().update(load_twins(
    "test_poison_guard.py", {},
    overrides={"TpuPushDispatcher": cpu_dispatcher()},
))


def test_twin_builds_the_ports_dispatcher():
    assert PushDispatcher.__module__ == "tpu_faas_torch.dispatch.push"
    check_ports_dispatcher(TpuPushDispatcher(ip="127.0.0.1", port=0,
                                             store=MemoryStore()))
