"""Twins of tests/test_local_e2e.py: the port's client SDK (sync and
asyncio), gateway, store server and ``LocalDispatcher`` over real TCP
(``test_torch_host_copies.load_twins``)."""

from test_torch_host_copies import load_twins

globals().update(load_twins("test_local_e2e.py", {}))


def test_twin_stack_is_the_ports():
    for obj, module in ((FaaSClient, "tpu_faas_torch.client.sdk"),
                        (LocalDispatcher, "tpu_faas_torch.dispatch.local"),
                        (start_gateway_thread, "tpu_faas_torch.gateway.app"),
                        (start_store_thread, "tpu_faas_torch.store.launch")):
        assert obj.__module__ == module, obj
