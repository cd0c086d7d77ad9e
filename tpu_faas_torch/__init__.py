"""tpu-faas scheduling core on PyTorch and CUDA (NVIDIA Hopper).

The counterpart of the JAX package ``tpu_faas``, laid out the same way so a
reader can find each module's twin:

- :mod:`tpu_faas_torch.sched.greedy`     rank-match placement + host greedy
- :mod:`tpu_faas_torch.sched.auction`    auction placement (forward auction)
- :mod:`tpu_faas_torch.sched.bid`        the auction's top-2 bid: ONE
  hand-written CUDA kernel (``csrc/bid_top2.cu``) with its plain version
- :mod:`tpu_faas_torch.sched.sinkhorn`   entropic-OT placement (log-domain
  Sinkhorn: dense, streamed and bucketed solvers)
- :mod:`tpu_faas_torch.sched.oracle`     host oracles: exact assignment and
  the LP makespan bound
- :mod:`tpu_faas_torch.sched.state`      the batch tick and ``SchedulerArrays``
- :mod:`tpu_faas_torch.sched.resident`   the device-resident delta tick and
  ``ResidentScheduler``
- :mod:`tpu_faas_torch.sched.fused_tick` the resident tick as ONE hand-written
  CUDA launch (``csrc/fused_tick.cu``; rank placement on one block, the
  auction and Sinkhorn cooperative over the card), with its plain-PyTorch
  version
- :mod:`tpu_faas_torch.tenancy`          the tenancy plane: ``TenantTable``
  and the spec parsers (``config``), the weighted-fair admission and the
  deficit carry as torch ops (``fairshare``); the resident tick runs the
  same lane inside ``csrc/fused_tick.cu``
- :mod:`tpu_faas_torch.spec`             the speculation plane: straggler
  flags, the anti-affinity veto and the hedge fixup as torch ops, and the
  host's hedge book (``policy``)
- :mod:`tpu_faas_torch.graph`            task graphs: the ready frontier's
  device ops (the dependency mask, the byte preference, the locality
  exchange) as torch ops on the batch tick, the host ``GraphFrontier``,
  and DAG validation
- :mod:`tpu_faas_torch.sim.fleet`        the simulated churn fleet
- :mod:`tpu_faas_torch.parallel`         multi-device scheduling on
  ``torch.distributed``: meshes of (process, device) positions, the
  sharded tick, and the multi-process lead/follower ticks

The host layer is a copy of the JAX package's modules at the same paths,
changed only in their imports: :mod:`~tpu_faas_torch.core` (tasks,
payloads, serialization, the columnar arena), :mod:`~tpu_faas_torch.store`
(the store client, the in-process, asyncio and standalone servers,
sharding, replication, snapshots, the native store's launcher),
:mod:`~tpu_faas_torch.obs` (metrics, traces, SLOs, the flight recorder;
``obs.profile`` captures ticks with ``torch.profiler``),
:mod:`~tpu_faas_torch.admission`, :mod:`~tpu_faas_torch.chaos`,
:mod:`~tpu_faas_torch.utils`, :mod:`~tpu_faas_torch.gateway` (the REST
API), :mod:`~tpu_faas_torch.client` (the SDK, sync and asyncio),
:mod:`~tpu_faas_torch.worker` (the pull and push worker processes, their
pool, the supervisor and the wire), the dispatcher modes ``local``,
``pull`` and ``push`` (:mod:`~tpu_faas_torch.dispatch`),
:mod:`tpu_faas_torch.sched.estimator` and :mod:`tpu_faas_torch.sched.health`.
None of them touches a device, and importing them loads no
torch: the package's one export, :func:`resolve_device`, is imported on
first use.

Entry points take ``device=`` and default to ``"cuda"``; without a GPU they
raise unless the caller asks for ``"cpu"``. Nothing here imports ``jax`` or
the ``tpu_faas`` package.
"""

__all__ = ["resolve_device"]


def __getattr__(name: str):
    # PEP 562: torch loads only where a device is resolved, never in the
    # host processes (gateway, workers and their pool children, client)
    if name == "resolve_device":
        from tpu_faas_torch.device import resolve_device

        return resolve_device
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
