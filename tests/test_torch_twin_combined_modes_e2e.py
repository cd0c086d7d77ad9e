"""Twin of tests/test_combined_modes_e2e.py: two --shared tpu-push
dispatchers of the port, each ticking over a 4-position mesh (Sinkhorn
placement, ``mesh_devices=4`` on the CPU), over one store, behind the
port's gateway, with the JAX package's push workers (``test_torch_host_copies.
load_twins``): atomic claims, lease renewal, dead-sibling adoption and the
sharded tick together, race-clean under the protocol monitor."""

from test_torch_host_copies import (
    check_ports_dispatcher,
    cpu_dispatcher,
    load_twins,
)
from tpu_faas_torch.store import MemoryStore

globals().update(load_twins("test_combined_modes_e2e.py", {}, overrides={
    "TpuPushDispatcher": cpu_dispatcher()}))


def test_twin_builds_the_ports_mesh_dispatcher():
    d = TpuPushDispatcher(ip="127.0.0.1", port=0, store=MemoryStore(),
                          shared=True, placement="sinkhorn", mesh_devices=4,
                          max_pending=8, recover_queued=False)
    assert d.arrays.mesh.size == 4
    check_ports_dispatcher(d)
