"""Deterministic fault-injection plane (see chaos/plan.py for design).

Processes arm chaos once at startup via :func:`from_env`; every seam
then holds either ``None`` (chaos off — one identity check of hot-path
cost, surfaces byte-identical) or a site handler. The env var is read
ON CONSTRUCTION of the owning component, never per event."""

from __future__ import annotations

import os

from tpu_faas_torch.chaos.plan import (
    ChaosConfigError,
    ChaosPlan,
    ChaosRule,
    ChaosWire,
    ExecChaos,
    StoreChaos,
    parse_chaos,
)

__all__ = [
    "ChaosConfigError",
    "ChaosPlan",
    "ChaosRule",
    "ChaosWire",
    "ExecChaos",
    "StoreChaos",
    "ENV_VAR",
    "from_env",
    "parse_chaos",
]

ENV_VAR = "TPU_FAAS_CHAOS"

#: process-global plan cache: every component in one process (store
#: client, dispatcher wire, worker exec) must share ONE plan so the
#: injection counts aggregate and a single bind_flightrec() covers all
#: sites. Keyed by the spec string — a changed env re-arms.
_cached_spec: str | None = None
_cached_plan: ChaosPlan | None = None


def from_env(environ=None) -> ChaosPlan | None:
    """The process's chaos plan per ``TPU_FAAS_CHAOS``, or None when the
    variable is unset/empty. A malformed spec raises
    :class:`ChaosConfigError` — at process start, where it's visible —
    rather than silently running a chaos-free "chaos" test.

    The plan is cached process-globally per spec string (decision
    streams keep advancing across components — that's the point: one
    process, one plan). Tests that need fresh streams for the same spec
    call :func:`parse_chaos` directly."""
    global _cached_spec, _cached_plan
    spec = (environ if environ is not None else os.environ).get(ENV_VAR)
    if not spec:
        return None
    if spec != _cached_spec:
        _cached_plan = parse_chaos(spec)
        _cached_spec = spec
    return _cached_plan


def _reset_for_tests() -> None:
    global _cached_spec, _cached_plan
    _cached_spec = None
    _cached_plan = None
