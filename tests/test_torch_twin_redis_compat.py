"""Twins of tests/test_redis_compat.py against the port's store client and
its copy of the redis shim (``tpu_faas_torch/compat/redis_shim``), through
``test_torch_host_copies.load_twins``: the task-store contract against the
Redis-semantics responder (and a real redis-server where one is
installed), the wire pins, the local dispatcher's end-to-end run, and the
shim's non-blocking pub/sub read."""

from test_torch_host_copies import load_twins

globals().update(load_twins("test_redis_compat.py", {}))


def test_twin_runs_the_ports_client_and_shim():
    assert resp.__name__ == "tpu_faas_torch.store.resp"
    assert make_store.__module__ == "tpu_faas_torch.store.launch"
    names = test_shim_pubsub_nonblocking_on_partial_reply.__code__.co_names
    assert "tpu_faas_torch.compat.redis_shim.redis" in names
