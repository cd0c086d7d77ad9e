"""Twins of tests/test_local_dispatcher.py: the port's ``LocalDispatcher``
(``tpu_faas_torch/dispatch/local.py``) on its ``TaskPool``
(``worker/pool.py``), against the port's ``MemoryStore``
(``test_torch_host_copies.load_twins``)."""

from test_torch_host_copies import load_twins

globals().update(load_twins("test_local_dispatcher.py", {}))


def test_twin_builds_the_ports_dispatcher():
    d = LocalDispatcher(num_workers=1, store=MemoryStore())
    assert type(d).__module__ == "tpu_faas_torch.dispatch.local"
    assert type(d.store).__module__ == "tpu_faas_torch.store.memory"
