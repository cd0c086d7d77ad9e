"""Per-class tail-SLO attribution vocabulary (the composed-SLO plane).

Two ideas live here, both opt-in so the default exposition stays
byte-identical to the reference era:

**SLO classes.** Every task belongs to exactly one of a BOUNDED class
vocabulary (``interactive`` / ``batch`` / ``default``) — declared
explicitly at submit (``X-SLO-Class`` header, SDK ``slo_class=`` kwarg)
or derived from the priority sign (positive = interactive, negative =
batch). The vocabulary is closed for the same reason TenantTable's label
set is: classes become a Prometheus label on the latency histograms, and
an open vocabulary is an unbounded-cardinality series leak. With
``TPU_FAAS_OBS_CLASS`` unset the class label never appears anywhere —
histogram label sets, ``/slo`` output and the attribution counter family
are all byte-identical to the pre-attribution surface.

**Plane attribution.** Each opt-in plane (express result lane,
micro-batching, speculation, tenancy, columnar intake, admission)
already makes a per-task decision somewhere; this module gives those
sites ONE bounded counter family to fold the decision into:
``tpu_faas_task_attrib_total{plane, outcome, class}``. "Which plane
bought which percentile" then becomes a scrape — join the counter deltas
against the per-class histograms — instead of log archaeology.

**High-resolution buckets.** The default 18-bucket ladder cannot resolve
p999 (the top decades are whole-second wide). ``TPU_FAAS_OBS_HIRES_BUCKETS``
swaps the latency histograms onto a ~30-bucket log-spaced ladder
(1 ms → 60 s, ~1.45x ratio) — enough resolution that a p999 read off the
cumulative counts is meaningful. Off by default: the ladder changes
every ``le=`` line in the exposition, so it must be asked for.
"""

from __future__ import annotations

import math
import os

__all__ = [
    "SLO_CLASSES",
    "DEFAULT_CLASS",
    "CLASS_ENV",
    "HIRES_ENV",
    "ATTRIB_VOCAB",
    "class_label_enabled",
    "hires_enabled",
    "hires_buckets",
    "latency_buckets",
    "normalize_class",
    "class_of",
    "class_of_fields",
    "AttributionBook",
]

#: the CLOSED class vocabulary — a label value outside this set never
#: reaches a metric (unknown declarations degrade to ``default``)
SLO_CLASSES = ("interactive", "batch", "default")
DEFAULT_CLASS = "default"

#: env knob: truthy value turns the ``class`` label on (histograms, /slo,
#: attribution counters). Read at component construction, not per call.
CLASS_ENV = "TPU_FAAS_OBS_CLASS"
#: env knob: truthy value swaps latency histograms onto the hi-res ladder
HIRES_ENV = "TPU_FAAS_OBS_HIRES_BUCKETS"

_FALSY = ("", "0", "false", "no", "off")

#: the CLOSED (plane, outcome) vocabulary for
#: ``tpu_faas_task_attrib_total`` — every site that wants a new outcome
#: adds it HERE first (the conformance test walks this table), keeping
#: the family's cardinality |vocab| x |SLO_CLASSES| by construction.
ATTRIB_VOCAB: dict[str, tuple[str, ...]] = {
    # gateway result delivery: long-poll answered from the announce's
    # inline payload vs a store re-read
    "express": ("inline", "store"),
    # wire form the task reached its worker in
    "batch": ("bundle_rode", "solo"),
    # speculation plane: this task's first result came from a hedge
    # replica (won), or a resolved hedge's loser reported late (wasted)
    "speculation": ("hedged_won", "hedged_wasted"),
    # tenancy plane at dispatch: picked while its tenant was the
    # most-deficit row (boosted) vs dispatched with its tenant at/over
    # its inflight cap at tick start (held earlier that tick)
    "tenancy": ("fairness_boosted", "cap_held"),
    # columnar intake lane the record decoded into
    "columnar": ("arena", "fallback"),
    # tasks that never ran: gateway admission/brownout rejections and
    # dispatcher queue-deadline sheds
    "admission": ("shed",),
    "dispatch": ("shed_expired",),
}


def _truthy(env: str) -> bool:
    return os.environ.get(env, "").strip().lower() not in _FALSY


def class_label_enabled() -> bool:
    """Is the ``class`` label (and the attribution counter family) on?"""
    return _truthy(CLASS_ENV)


def hires_enabled() -> bool:
    return _truthy(HIRES_ENV)


def hires_buckets() -> tuple[float, ...]:
    """~30 log-spaced bucket uppers, 1 ms → 60 s (strictly increasing).

    Generated, not hand-typed: 30 points evenly spaced in log10 between
    1e-3 and 60, rounded to 4 significant digits (rounding cannot
    produce a duplicate at this spacing — ratio ~1.46 per step).
    """
    lo, hi, n = math.log10(0.001), math.log10(60.0), 30
    out = []
    for i in range(n):
        v = 10.0 ** (lo + (hi - lo) * i / (n - 1))
        # 4 significant digits keeps the exposition readable
        out.append(float(f"{v:.4g}"))
    return tuple(out)


def latency_buckets(default: tuple[float, ...]) -> tuple[float, ...]:
    """The ladder a latency histogram should use under the current env:
    the caller's default, unless hi-res buckets were asked for."""
    return hires_buckets() if hires_enabled() else default


def normalize_class(raw) -> str | None:
    """Validate a declared class against the closed vocabulary.

    Returns the canonical class for a valid declaration, None for
    anything else (missing, wrong type, unknown word) — callers decide
    whether None means "reject the request" (gateway header validation)
    or "fall through to derivation" (record-field reads).
    """
    if isinstance(raw, bytes):
        try:
            raw = raw.decode("utf-8")
        except UnicodeDecodeError:
            return None
    if not isinstance(raw, str):
        return None
    cls = raw.strip().lower()
    return cls if cls in SLO_CLASSES else None


def class_of(slo_class, priority) -> str:
    """Effective class: explicit valid declaration wins, else the
    priority sign (positive = interactive, negative = batch), else
    ``default``. Total — never raises, never returns an off-vocabulary
    value (garbage degrades, matching the store-field discipline)."""
    cls = normalize_class(slo_class)
    if cls is not None:
        return cls
    try:
        prio = int(priority) if priority is not None else 0
    except (TypeError, ValueError):
        prio = 0
    if prio > 0:
        return "interactive"
    if prio < 0:
        return "batch"
    return DEFAULT_CLASS


def class_of_fields(fields: dict) -> str:
    """Effective class of a store record / fields dict (gateway result
    path, dispatcher intake). Imports the field names lazily to keep
    obs/ free of a core dependency cycle."""
    from tpu_faas_torch.core.task import FIELD_PRIORITY, FIELD_SLO_CLASS

    return class_of(fields.get(FIELD_SLO_CLASS), fields.get(FIELD_PRIORITY))


class AttributionBook:
    """The per-process ``tpu_faas_task_attrib_total`` family, or a no-op.

    Constructed by every metrics-owning component (gateway context,
    dispatcher); when the class label is off the family is NEVER
    registered and every ``note()`` is a cheap early return — the
    exposition stays byte-identical. When on, the full
    plane x outcome x class child set is pre-created so scrapes carry
    explicit zeros (the bounded-vocabulary discipline, and what lets the
    bench read "plane live" as a plain nonzero check).
    """

    def __init__(self, registry, enabled: bool | None = None) -> None:
        self.enabled = (
            class_label_enabled() if enabled is None else bool(enabled)
        )
        self._m = None
        if self.enabled:
            self._m = registry.counter(
                "tpu_faas_task_attrib_total",
                "Per-task plane-attribution bits, folded in where each "
                "plane decides (express delivery source, wire bundling, "
                "hedge wins/waste, tenancy boosts/holds, columnar lane, "
                "sheds) — join deltas against the class-labeled latency "
                "histograms to see which plane bought which percentile",
                ("plane", "outcome", "class"),
            )
            for plane, outcomes in ATTRIB_VOCAB.items():
                for outcome in outcomes:
                    for cls in SLO_CLASSES:
                        self._m.labels(plane, outcome, cls)

    def note(self, plane: str, outcome: str, cls: str, n: int = 1) -> None:
        """Count one attribution bit. Off-vocabulary planes/outcomes are
        a programming error and raise (the vocabulary is closed on
        purpose); off-vocabulary classes degrade to ``default``."""
        if self._m is None:
            return
        if outcome not in ATTRIB_VOCAB.get(plane, ()):
            raise ValueError(
                f"attribution outcome {plane}/{outcome} not in "
                f"ATTRIB_VOCAB — extend the closed vocabulary first"
            )
        if cls not in SLO_CLASSES:
            cls = DEFAULT_CLASS
        self._m.labels(plane, outcome, cls).inc(n)
