"""Twins of tests/test_store_ha.py: replication, failover and the HA
client through the port's store server (``python -m
tpu_faas_torch.store.server`` as the SIGKILL-able primary), store client,
gateway, breaker and admission, the port's local and tpu-push
(``device="cpu"``) dispatchers and the port's push worker processes
(``test_torch_host_copies.load_twins``)."""

from test_torch_host_copies import (
    check_ports_dispatcher,
    cpu_dispatcher,
    load_twins,
    reserved_port,
)

# a server's port lies below the ephemeral range (reserved_port): a
# bind(0) port could be taken before the primary binds it again
globals().update(load_twins(
    "test_store_ha.py", {},
    overrides={"TpuPushDispatcher": cpu_dispatcher(),
               "_free_port": reserved_port},
    processes=("tpu_faas.store.server",),
    twins=("test_workers_e2e",),
))


def test_twin_builds_the_ports_dispatcher():
    proc = _spawn_primary(reserved_port())
    try:
        with open(f"/proc/{proc.pid}/cmdline", "rb") as fh:
            argv = fh.read().decode().split("\0")
        assert argv[argv.index("-m") + 1] == "tpu_faas_torch.store.server"
    finally:
        proc.kill()
        proc.wait()
    check_ports_dispatcher(TpuPushDispatcher(ip="127.0.0.1", port=0,
                                             store=MemoryStore()))
