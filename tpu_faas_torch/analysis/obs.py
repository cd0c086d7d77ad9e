"""Observability-discipline checker.

One rule:

- ``wall-clock-latency`` (error): a subtraction whose operand is a direct
  ``time.time()`` call, inside the dispatch/worker hot-path modules.
  Latency and age math on the wall clock is exactly what the telemetry
  layer (tpu_faas/obs) exists to own: its stamps are monotonic-anchored
  (``obs.trace.anchored_now``), so an NTP step or operator clock-set
  cannot produce negative queue waits or false lease expiries, and every
  measured duration lands in ONE registry instead of a private variable.
  Sites that genuinely need the wall clock — ages of CROSS-PROCESS stamps
  persisted as epoch seconds (leases, claims) — carry a justifying
  ``# faas: allow(obs.wall-clock-latency)``.

Scope is deliberately the dispatch/worker trees only (module path contains
``dispatch/`` or ``worker/``): the gateway's uptime arithmetic and the
bench harness's wall timings are not hot-path latency math, and flagging
them would bury the real findings.
"""

from __future__ import annotations

import ast
from typing import Iterable

from tpu_faas_torch.analysis.core import Checker, Finding, Module, dotted_name

_HOT_PATH_MARKERS = ("dispatch/", "worker/")


def _is_wall_clock_call(node: ast.AST) -> bool:
    return (
        isinstance(node, ast.Call)
        and dotted_name(node.func) == "time.time"
    )


class ObsChecker(Checker):
    name = "obs"

    def check(self, module: Module) -> Iterable[Finding]:
        rel = module.relpath
        if not any(marker in rel for marker in _HOT_PATH_MARKERS):
            return
        for node in ast.walk(module.tree):
            if not (
                isinstance(node, ast.BinOp) and isinstance(node.op, ast.Sub)
            ):
                continue
            if _is_wall_clock_call(node.left) or _is_wall_clock_call(
                node.right
            ):
                yield self.finding(
                    module,
                    node,
                    "wall-clock-latency",
                    "error",
                    "time.time() subtraction in a dispatch/worker hot path: "
                    "use the obs API (monotonic-anchored stamps, registry "
                    "histograms) — wall-clock steps corrupt raw deltas",
                )
