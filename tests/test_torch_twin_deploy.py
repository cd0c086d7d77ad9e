"""Twins of tests/test_deploy.py: the port's ``WorkerFleet`` and
``AutoScaler`` (``tpu_faas_torch/worker/deploy.py``) supervising the port's
push workers, served by the port's ``TpuPushDispatcher`` on the CPU
(``test_torch_host_copies.load_twins``; the JAX file imports its
dispatcher factory from tests/test_tpu_push_e2e.py, so the twin gets the
port's; the case that builds the dispatcher in its body gets it on the CPU
through the fixture ``dispatcher_on_cpu``)."""

import pytest

from test_torch_host_copies import (
    check_ports_dispatcher,
    dispatcher_on_cpu,  # noqa: F401 (the fixture)
    load_twins,
)
from test_torch_twin_tpu_push_e2e import _make_dispatcher as _port_make

globals().update(load_twins("test_deploy.py", {},
                            overrides={"_make_dispatcher": _port_make}))
test_dispatcher_backlog_estimate = pytest.mark.usefixtures(
    "dispatcher_on_cpu")(test_dispatcher_backlog_estimate)


def test_twin_builds_the_ports_fleet_and_dispatcher():
    cmd = WorkerFleet(1, 2, "tcp://127.0.0.1:5555", heartbeat=True)._command(0)
    assert cmd[1:3] == ["-m", "tpu_faas_torch.worker.push_worker"], cmd
    check_ports_dispatcher(_make_dispatcher("memory://",
                                            recover_queued=False))
