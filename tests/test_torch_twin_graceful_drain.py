"""Twins of tests/test_graceful_drain.py: SIGTERM drains the port's pull
and push worker processes behind the port's pull, push and tpu-push (CPU)
dispatchers (``test_torch_host_copies.load_twins``). The JAX file imports
its stack and dispatcher factory from other test modules; the twin gets
the port's: ``stack`` and ``_spawn_worker`` from
tests/test_torch_twin_workers_e2e.py, ``_make_dispatcher`` from
tests/test_torch_twin_tpu_push_e2e.py."""

from test_torch_host_copies import load_twins
from test_torch_twin_tpu_push_e2e import _make_dispatcher as _port_make
from test_torch_twin_workers_e2e import _spawn_worker as _port_spawn
from test_torch_twin_workers_e2e import stack as _port_stack

globals().update(load_twins("test_graceful_drain.py", {}, overrides={
    "_make_dispatcher": _port_make,
    "_spawn_worker": _port_spawn,
    "stack": _port_stack,
}))


def test_twin_drives_the_ports_stack():
    assert _spawn_worker is _port_spawn and stack is _port_stack
    assert _make_dispatcher is _port_make
    assert FaaSClient.__module__ == "tpu_faas_torch.client.sdk"
