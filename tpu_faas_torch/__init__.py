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
- :mod:`tpu_faas_torch.sim.fleet`        the simulated churn fleet

Entry points take ``device=`` and default to ``"cuda"``; without a GPU they
raise unless the caller asks for ``"cpu"``. Nothing here imports ``jax`` or
the ``tpu_faas`` package.
"""

from tpu_faas_torch.device import resolve_device

__all__ = ["resolve_device"]
