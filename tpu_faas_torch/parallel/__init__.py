"""Multi-device scheduling on ``torch.distributed``: meshes of positions,
the sharded scheduler functions, and the multi-process runtime glue
(counterpart of ``tpu_faas/parallel``)."""

from tpu_faas_torch.parallel.distributed import initialize_multihost
from tpu_faas_torch.parallel.mesh import (
    make_mesh,
    sharded_scheduler_tick,
    sharded_sinkhorn_placement,
)

__all__ = [
    "initialize_multihost",
    "make_mesh",
    "sharded_scheduler_tick",
    "sharded_sinkhorn_placement",
    # imported by name, as in JAX: MultihostTick (multihost_tick) and
    # MultihostResidentScheduler (multihost_resident)
]
