"""Twins of tests/test_batch_plane.py: the TASK_BATCH and RESULT_BATCH
frames, the port's pool bundles, the port's tpu-push dispatcher
(``device="cpu"``) grouping frames per worker and its express gate, the
port's push worker, and the batched stack end to end with the port's push
worker processes (``test_torch_host_copies.load_twins``)."""

from test_torch_host_copies import (
    check_ports_dispatcher,
    cpu_dispatcher,
    load_twins,
)

globals().update(load_twins(
    "test_batch_plane.py", {},
    overrides={"TpuPushDispatcher": cpu_dispatcher()},
    twins=("test_workers_e2e",),
))


def test_twin_builds_the_ports_dispatcher():
    disp, _sock = _grouping_dispatcher(4)
    assert TaskPool.__module__ == "tpu_faas_torch.worker.pool"
    check_ports_dispatcher(disp)
