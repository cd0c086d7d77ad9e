"""Twins of tests/test_store_fuzz.py: the seeded differential fuzz against
the port's ``MemoryStore``, its asyncio RESP server through its
``RespStore``, and the native server where its binary is built (skipped
otherwise, as the JAX case skips) (``test_torch_host_copies.load_twins``)."""

from test_torch_host_copies import load_twins

globals().update(load_twins("test_store_fuzz.py", {}))


def test_twin_fuzzes_the_ports_stores():
    assert MemoryStore.__module__ == "tpu_faas_torch.store.memory"
    assert start_store_thread.__module__ == "tpu_faas_torch.store.launch"
