"""Twins of tests/test_cancel.py: queued-only and forced cancellation
through the port's store, race monitor, gateway and client SDK, and the
port's local, pull, push and tpu-push (``device="cpu"``, batch and
resident) dispatchers serving the port's worker processes
(``test_torch_host_copies.load_twins``; the file's dispatcher factory,
worker launcher and ``stack`` come from the twins of
tests/test_tpu_push_e2e.py and tests/test_workers_e2e.py)."""

import pytest

from test_torch_host_copies import (  # noqa: F401
    check_ports_dispatcher,
    cpu_dispatcher,
    dispatcher_on_cpu,
    load_twins,
)

globals().update(load_twins(
    "test_cancel.py", {},
    overrides={"TpuPushDispatcher": cpu_dispatcher()},
    twins=("test_tpu_push_e2e", "test_workers_e2e"),
))
pytestmark = pytest.mark.usefixtures("dispatcher_on_cpu")


def test_twin_builds_the_ports_dispatcher():
    import test_torch_twin_workers_e2e as port_workers

    assert _spawn_worker is port_workers._spawn_worker
    assert FaaSClient.__module__ == "tpu_faas_torch.client.sdk"
    check_ports_dispatcher(_make_dispatcher("memory://",
                                            recover_queued=False))
