"""Twins of tests/test_payload_plane.py: content-addressed function bodies
through the port's store, gateway, executor cache, client SDK, its local,
pull and push dispatchers and in-process workers, and the full stack with
the port's tpu-push dispatcher (``device="cpu"``) serving the port's push
worker processes (``test_torch_host_copies.load_twins``)."""

import pytest

from test_torch_host_copies import (  # noqa: F401
    check_ports_dispatcher,
    cpu_dispatcher,
    dispatcher_on_cpu,
    load_twins,
)

globals().update(load_twins(
    "test_payload_plane.py", {},
    twins=("test_tpu_push_e2e", "test_workers_e2e"),
))
pytestmark = pytest.mark.usefixtures("dispatcher_on_cpu")


def test_twin_builds_the_ports_dispatcher():
    from test_torch_twin_tpu_push_e2e import _make_dispatcher

    assert PushWorker.__module__ == "tpu_faas_torch.worker.push_worker"
    assert LocalDispatcher.__module__ == "tpu_faas_torch.dispatch.local"
    check_ports_dispatcher(_make_dispatcher("memory://",
                                            recover_queued=False))
