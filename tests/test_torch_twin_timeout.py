"""Twins of tests/test_timeout.py: the port's executor's time budget, its
pool, and the timeout hint end to end through the port's gateway, client,
tpu-push dispatcher (``device="cpu"``) and push worker process
(``test_torch_host_copies.load_twins``)."""

from test_torch_host_copies import check_ports_dispatcher, load_twins

globals().update(load_twins(
    "test_timeout.py", {},
    twins=("test_tpu_push_e2e", "test_workers_e2e"),
))


def test_twin_builds_the_ports_dispatcher():
    assert execute_fn.__module__ == "tpu_faas_torch.core.executor"
    check_ports_dispatcher(_make_dispatcher("memory://",
                                            recover_queued=False))
