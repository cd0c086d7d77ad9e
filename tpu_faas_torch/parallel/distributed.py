"""Multi-process mesh formation on ``torch.distributed``.

Counterpart of ``tpu_faas/parallel/distributed.py``. One process per host
(or per card); :func:`initialize_multihost` joins them into one process
group, and the mesh of ``parallel/mesh.py`` then spans every process's
positions: the same sharded functions run their collectives through
``torch.distributed`` instead of over a local list.

The backend is chosen here, once, and never switched: NCCL on ``cuda``
(one card per process), gloo on ``cpu``, and gloo on ``cuda`` when the
caller asks for it (``backend="gloo"``): each collective is then staged
through host memory, which is the only route when two processes share one
card. NCCL's errors (a card shared by two ranks included) propagate;
nothing retries on gloo.

Idempotent: a second call is a no-op instead of an error, so libraries can
call it defensively. ``num_processes=1`` is an explicit single-process
run. When the operator named a cluster (any argument given), an init error
raises and nothing is latched, so a boot-race retry can succeed; when
discovery (``env://``) finds no cluster, the process runs alone.
"""

from __future__ import annotations

import os
from datetime import timedelta

import torch
import torch.distributed as dist

from tpu_faas_torch.utils.logging import get_logger

log = get_logger("parallel.distributed")

#: what this process joined with; one process holds one runtime
_state: dict = {"initialized": False, "cpu_positions": None,
                "local_rank": 0}


def initialize_multihost(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    cpu_devices_per_process: int | None = None,
    backend: str | None = None,
    timeout: float | None = None,
) -> bool:
    """Join this process into the global process group.

    ``coordinator_address`` (``HOST:PORT``) becomes ``tcp://HOST:PORT``;
    without it, discovery reads ``env://`` (``MASTER_ADDR``,
    ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``). Returns True if the group
    was formed, False if it already was or this run is single-process.

    ``cpu_devices_per_process`` gives this process that many CPU positions
    (the CPU simulation of a pod: gloo collectives between processes, as
    the JAX package simulates one with virtual CPU devices); otherwise the
    process holds one position, ``cuda:{local rank % device count}``, or
    the CPU when no card is present. ``timeout`` (seconds) bounds every
    collective of the group: a follower blocked in one for longer fails
    instead of waiting forever."""
    if _state["initialized"]:
        return False
    if cpu_devices_per_process is not None:
        _state["cpu_positions"] = int(cpu_devices_per_process)
    if num_processes == 1:
        # explicit single-process: nothing to join
        _state["initialized"] = True
        return False
    explicit = (
        coordinator_address is not None
        or num_processes is not None
        or process_id is not None
    )
    on_cpu = (cpu_devices_per_process is not None
              or not torch.cuda.is_available())
    if backend is None:
        backend = "gloo" if on_cpu else "nccl"
    if backend == "nccl" and on_cpu:
        raise ValueError("the nccl backend needs a card in every process")
    rank = process_id if process_id is not None else int(
        os.environ.get("RANK", "0"))
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    if not on_cpu:
        # pin this process's card before any CUDA call makes a context on
        # card 0
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
    kw: dict = dict(backend=backend)
    if coordinator_address is not None:
        kw["init_method"] = f"tcp://{coordinator_address}"
    else:
        kw["init_method"] = "env://"
    if num_processes is not None:
        kw["world_size"] = num_processes
    if process_id is not None:
        kw["rank"] = process_id
    if timeout:
        kw["timeout"] = timedelta(seconds=timeout)
    try:
        dist.init_process_group(**kw)
    except (RuntimeError, ValueError) as exc:
        if explicit:
            # the operator named a cluster: running on a local mesh would
            # compute placement over the wrong position set; do not latch
            # either, so a boot-race retry can succeed
            raise
        log.info("single-process mode (no cluster discovered: %s)", exc)
        _state["initialized"] = True
        return False
    _state["initialized"] = True
    _state["local_rank"] = local_rank
    log.info(
        "distributed runtime up: process %d/%d, backend %s, positions %s",
        dist.get_rank(), dist.get_world_size(), dist.get_backend(),
        [str(d) for d in local_devices("cpu" if on_cpu else "cuda")],
    )
    return True


def is_multiprocess() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    return dist.get_rank() if is_multiprocess() else 0


def process_count() -> int:
    return dist.get_world_size() if is_multiprocess() else 1


def process_device(device: str | torch.device = "cuda") -> torch.device:
    """The device this process computes on: the CPU when it simulates a pod
    or asks for the CPU, else its card, ``cuda:{local rank % count}``."""
    dev = torch.device(device)
    if _state["cpu_positions"] is not None or dev.type == "cpu":
        return torch.device("cpu")
    if dev.index is not None:
        return dev
    return torch.device("cuda", _state["local_rank"]
                        % max(torch.cuda.device_count(), 1))


def local_devices(device: str | torch.device = "cuda") -> list[torch.device]:
    """This process's positions: ``cpu_devices_per_process`` CPU positions,
    or its one device."""
    n = _state["cpu_positions"]
    if n is not None:
        return [torch.device("cpu")] * n
    return [process_device(device)]


def shutdown() -> None:
    """Leave the process group before the process exits.

    Destroys the group while the interpreter is whole, so its transport
    threads (gloo's run loops, the store's) are joined here rather than
    torn down at interpreter exit, where a process that finished its work
    could still abort (SIGABRT: "terminate called without an active
    exception"). Every process of a group calls it after its last
    collective; a process that never joined one returns at once."""
    if is_multiprocess():
        dist.destroy_process_group()
    _state.update(initialized=False, cpu_positions=None, local_rank=0)
