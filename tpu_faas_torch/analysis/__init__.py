"""Static analysis for the PyTorch/CUDA port: prove at rest what
``store/racecheck.py`` checks at runtime, and what no CPU test reaches.

The counterpart of ``tpu_faas/analysis`` over the port's own source. The
host checkers are the JAX package's, copied; three are rewritten for
torch and CUDA, and they ride the same small framework
(:mod:`tpu_faas_torch.analysis.core`):

- :mod:`tpu_faas_torch.analysis.protocol` — every store write site that
  sets a literal :class:`~tpu_faas_torch.core.task.TaskStatus` is
  cross-checked against the ``_LEGAL`` transition table imported from
  ``store/racecheck.py``, and raw ``hset``/``publish`` calls that bypass
  the :class:`TaskStore` conveniences are flagged (outside
  ``tpu_faas_torch/store``).
- :mod:`tpu_faas_torch.analysis.tracesafety` — host syncs (``.item()``,
  ``.cpu()``, ``bool(tensor)``, ``nonzero()``, ``to_host`` ...) and
  branches on tensors in every function reachable from the card's device
  entry points (the batch and resident ticks, kernels B1 and B2, the
  sharded functions); the suppressed ones are the static inventory of
  host syncs on the card's path.
- :mod:`tpu_faas_torch.analysis.locks` — blocking calls made while holding
  a lock, and inconsistent multi-lock acquisition order across modules.
- :mod:`tpu_faas_torch.analysis.obs` — wall-clock latency math in
  dispatch/worker hot paths that belongs to the telemetry layer.
- :mod:`tpu_faas_torch.analysis.eventloop` — blocking work reachable from
  ``async def`` bodies.
- :mod:`tpu_faas_torch.analysis.registries` — the store-command
  registries (RESP dispatch, replication forward set, replica apply
  switch, sharded partitioner, racecheck pass-throughs, native command
  table) carry the same mutating-primitive set.
- :mod:`tpu_faas_torch.analysis.shardsafety` — statically-spelled store
  keys match a declared namespace with a known routing rule.
- :mod:`tpu_faas_torch.analysis.metricsdiscipline` — one metric family
  name, one label vocabulary; counters end ``_total``; no per-task labels.
- :mod:`tpu_faas_torch.analysis.kernelparity` — the CUDA kernels' ctypes
  bindings against their ``extern "C"`` signatures, read from the ``.cu``
  sources as text: the ``data_ptr()`` launch lists follow the
  ``_ResidentState`` registry in declaration order and fill the C
  parameter list, the ``argtypes`` follow the C types, the pointer types
  and ``check_arg`` dtypes follow the registry's dtype comments, and each
  kernel wrapper accepts what its plain version accepts.
- :mod:`tpu_faas_torch.analysis.devicesnapshot` — a host array uploaded
  asynchronously (``torch.from_numpy(a)`` then ``.to(dev,
  non_blocking=True)`` and its relatives) is not mutated in place later in
  the same scope; ``device.upload`` is the sanctioned snapshot.
- :mod:`tpu_faas_torch.analysis.planegate` — capability-gated wire and
  store fields are never written outside their plane's flag check.

Run ``python -m tpu_faas_torch.analysis [paths]`` (default: the port's
package; exit 1 on non-baselined error-severity findings); suppress a
deliberate site with a trailing ``# faas: allow(<rule>)`` comment and its
reason — a suppression that stops matching becomes a
``core.stale-suppression`` warning. ``--json``, ``--sarif``, ``--only``,
``--strict`` and the baseline flags are the JAX tool's. The analysers
import no torch: they read source text only.
"""

from __future__ import annotations

from tpu_faas_torch.analysis.core import (
    Checker,
    Finding,
    Module,
    load_baseline,
    run_paths,
    subtract_baseline,
    write_baseline,
)
from tpu_faas_torch.analysis.devicesnapshot import DeviceSnapshotChecker
from tpu_faas_torch.analysis.eventloop import EventLoopChecker
from tpu_faas_torch.analysis.kernelparity import KernelParityChecker
from tpu_faas_torch.analysis.locks import LockDisciplineChecker
from tpu_faas_torch.analysis.metricsdiscipline import MetricsDisciplineChecker
from tpu_faas_torch.analysis.obs import ObsChecker
from tpu_faas_torch.analysis.planegate import PlaneGateChecker
from tpu_faas_torch.analysis.protocol import ProtocolChecker
from tpu_faas_torch.analysis.registries import RegistryChecker
from tpu_faas_torch.analysis.shardsafety import ShardSafetyChecker
from tpu_faas_torch.analysis.tracesafety import TraceSafetyChecker

#: The default checker suite, in report order.
ALL_CHECKERS = (
    ProtocolChecker,
    TraceSafetyChecker,
    LockDisciplineChecker,
    ObsChecker,
    EventLoopChecker,
    RegistryChecker,
    ShardSafetyChecker,
    MetricsDisciplineChecker,
    KernelParityChecker,
    DeviceSnapshotChecker,
    PlaneGateChecker,
)

__all__ = [
    "ALL_CHECKERS",
    "Checker",
    "DeviceSnapshotChecker",
    "EventLoopChecker",
    "Finding",
    "KernelParityChecker",
    "LockDisciplineChecker",
    "MetricsDisciplineChecker",
    "Module",
    "ObsChecker",
    "PlaneGateChecker",
    "ProtocolChecker",
    "RegistryChecker",
    "ShardSafetyChecker",
    "TraceSafetyChecker",
    "load_baseline",
    "run_paths",
    "subtract_baseline",
    "write_baseline",
]
