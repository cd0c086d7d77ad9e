"""Twins of tests/test_shared_dispatchers.py: claims and adoption between
the port's shared dispatchers, two ``shared=True`` tpu-push dispatchers of
the port (``device="cpu"``) on one store serving the port's push worker
processes, and one dispatcher's death migrating its tasks to its sibling
(``test_torch_host_copies.load_twins``)."""

from test_torch_host_copies import (
    check_ports_dispatcher,
    cpu_dispatcher,
    load_twins,
)

globals().update(load_twins(
    "test_shared_dispatchers.py", {},
    overrides={"TpuPushDispatcher": cpu_dispatcher()},
    twins=("test_workers_e2e",),
))


def test_twin_builds_the_ports_dispatcher():
    d = TpuPushDispatcher(ip="127.0.0.1", port=0, store=MemoryStore(),
                          shared=True)
    assert d.shared
    check_ports_dispatcher(d)
