"""Twins of tests/test_data_plane_batching.py: the port's tpu-push
dispatcher (``device="cpu"``) batching its store round trips per tick, and
losing nothing and doubling nothing across store outages mid-flush
(``test_torch_host_copies.load_twins``)."""

from test_torch_host_copies import (
    check_ports_dispatcher,
    cpu_dispatcher,
    load_twins,
)

globals().update(load_twins(
    "test_data_plane_batching.py", {},
    overrides={"TpuPushDispatcher": cpu_dispatcher()},
))


def test_twin_builds_the_ports_dispatcher():
    assert TaskDispatcher.__module__ == "tpu_faas_torch.dispatch.base"
    check_ports_dispatcher(_tpu_dispatcher(MemoryStore()))
