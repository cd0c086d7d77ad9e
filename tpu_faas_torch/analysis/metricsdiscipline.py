"""Metrics-discipline checker: one name, one vocabulary, bounded
cardinality.

The exposition layer (tpu_faas/obs/metrics.py) enforces some of this at
runtime — duplicate families across rendered registries are a hard error,
and a family rejects re-registration with a different label set *within
one registry*. What runtime checks cannot see is DRIFT ACROSS PROCESSES:
the gateway and a dispatcher each hold private registries, so the same
family name registered with different label vocabularies in two modules
renders fine in every process and only collides on the operator's
dashboard, where `sum by (stage)` silently drops the series that spells
it `phase`. Cardinality is the same story: a per-task label value works
on the laptop and OOMs the scrape path in the fleet. Both are decisions
visible at the registration/use site, so this pass pins them at rest.

Rules (all error severity):

- ``counter-not-total`` — a counter family whose name does not end in
  ``_total`` (the Prometheus naming contract every dashboard and recording
  rule in OPERATIONS.md assumes; gauges and histograms have their own
  suffix conventions enforced by the renderer).
- ``label-vocabulary-drift`` — one family name registered with more than
  one label vocabulary (or metric type) anywhere in the scanned tree.
  Registering the same (name, vocabulary) in two modules is fine — the
  gateway and dispatcher legitimately own per-process copies of shared
  families.
- ``unbounded-cardinality-label`` — a per-entity identifier used as a
  label: declaring a label NAMED after one (``task_id``, ``trace_id``,
  ``digest``, ...) or passing such a value to ``.labels(...)``. Every
  distinct label value is a live child series held forever and rendered
  on every scrape; task-shaped cardinality belongs in the trace plane
  (``/trace/<task_id>``), not the metrics plane.

Registration sites are recognized as ``<registry>.counter/gauge/histogram
(name, help, labels)`` calls where the receiver's final identifier
contains ``registr``/``metrics`` — the project idiom (``REGISTRY``,
``self.metrics``, ``registry``) — so arbitrary ``.counter()`` methods on
unrelated objects do not trip the pass. Dynamic names/label tuples are
out of static scope.
"""

from __future__ import annotations

import ast
from typing import Iterable, Iterator

from tpu_faas_torch.analysis.core import Checker, Finding, Module, dotted_name

#: Identifier spellings whose value space grows with traffic, not with
#: topology. Any of these as a label name, or as a direct ``.labels()``
#: value, is unbounded cardinality.
UNBOUNDED_IDS = frozenset(
    {"task_id", "trace_id", "digest", "fn_digest", "function_digest",
     "function_id", "idempotency_key", "span_id"}
)

_REGISTER_METHODS = ("counter", "gauge", "histogram")


def _receiver_is_registry(node: ast.AST) -> bool:
    d = dotted_name(node)
    if d is None:
        return False
    final = d.rsplit(".", 1)[-1].lower()
    return "registr" in final or "metrics" in final


#: Substrings marking a receiver as a metric family for the ``.labels()``
#: value check (``self.m_requests``, ``_SHARD_ROUND_TRIPS``, ``_hist``,
#: the TickTracer ``_mirror``). Best-effort by construction: an unmatched
#: receiver costs a missed check, never a false positive.
_METRIC_MARKERS = ("metric", "hist", "gauge", "counter", "mirror", "series")


def _receiver_is_metric(node: ast.AST) -> bool:
    d = dotted_name(node)
    if d is None:
        return False
    final = d.rsplit(".", 1)[-1]
    if final.isupper():  # module-level family constants (_TASKS_TOTAL)
        return True
    bare = final.lower().lstrip("_")
    if bare == "m" or bare.startswith("m_"):  # the self.m_* idiom
        return True
    return any(marker in bare for marker in _METRIC_MARKERS)


def _label_tuple(call: ast.Call) -> tuple[str, ...] | None:
    """The statically-spelled label vocabulary of a registration call
    (third positional arg or ``labelnames=``); ``()`` when omitted, None
    when spelled dynamically."""
    node: ast.AST | None = None
    if len(call.args) > 2:
        node = call.args[2]
    for kw in call.keywords:
        if kw.arg == "labelnames":
            node = kw.value
    if node is None:
        return ()
    if isinstance(node, (ast.Tuple, ast.List)):
        out: list[str] = []
        for elt in node.elts:
            if isinstance(elt, ast.Constant) and isinstance(elt.value, str):
                out.append(elt.value)
            else:
                return None
        return tuple(out)
    return None


def _names_unbounded_value(node: ast.AST) -> str | None:
    """The unbounded identifier a ``.labels()`` value expression passes
    through verbatim, if any: ``task_id``, ``self.task_id``,
    ``str(trace_id)``, ``f"{digest}"``. A derived value
    (``shard_of(task_id)``) is bounded by construction and exempt."""
    d = dotted_name(node)
    if d is not None and d.rsplit(".", 1)[-1] in UNBOUNDED_IDS:
        return d.rsplit(".", 1)[-1]
    if (
        isinstance(node, ast.Call)
        and isinstance(node.func, ast.Name)
        and node.func.id == "str"
        and len(node.args) == 1
    ):
        return _names_unbounded_value(node.args[0])
    if isinstance(node, ast.JoinedStr):
        for value in node.values:
            if isinstance(value, ast.FormattedValue):
                hit = _names_unbounded_value(value.value)
                if hit is not None:
                    return hit
    return None


class MetricsDisciplineChecker(Checker):
    name = "metrics"

    def __init__(self) -> None:
        #: family name -> list of (vocab, kind, path, line)
        self._families: dict[
            str, list[tuple[tuple[str, ...] | None, str, str, int]]
        ] = {}

    def check(self, module: Module) -> Iterable[Finding]:
        for node in ast.walk(module.tree):
            if not (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
            ):
                continue
            attr = node.func.attr
            if attr in _REGISTER_METHODS and _receiver_is_registry(
                node.func.value
            ):
                yield from self._check_registration(module, node, attr)
            elif attr == "labels" and _receiver_is_metric(node.func.value):
                yield from self._check_labels_call(module, node)

    def _check_registration(
        self, module: Module, call: ast.Call, kind: str
    ) -> Iterator[Finding]:
        name_node = call.args[0] if call.args else None
        for kw in call.keywords:
            if kw.arg == "name":
                name_node = kw.value
        if not (
            isinstance(name_node, ast.Constant)
            and isinstance(name_node.value, str)
        ):
            return
        name = name_node.value
        vocab = _label_tuple(call)
        self._families.setdefault(name, []).append(
            (vocab, kind, module.relpath, call.lineno)
        )
        if kind == "counter" and not name.endswith("_total"):
            yield self.finding(
                module, call, "counter-not-total", "error",
                f"counter {name!r} does not end in _total: the Prometheus "
                f"naming contract every OPERATIONS.md dashboard/recording "
                f"rule assumes — rename it, or make it a gauge if it can "
                f"go down",
            )
        if vocab:
            bad = sorted(set(vocab) & UNBOUNDED_IDS)
            if bad:
                yield self.finding(
                    module, call, "unbounded-cardinality-label", "error",
                    f"{name!r} declares label(s) {', '.join(bad)}: every "
                    f"distinct value becomes a live child series held "
                    f"forever and rendered on every scrape — per-task "
                    f"cardinality belongs in the trace plane "
                    f"(/trace/<task_id>), not a metric label",
                )

    def _check_labels_call(
        self, module: Module, call: ast.Call
    ) -> Iterator[Finding]:
        for value in list(call.args) + [kw.value for kw in call.keywords]:
            hit = _names_unbounded_value(value)
            if hit is not None:
                yield self.finding(
                    module, call, "unbounded-cardinality-label", "error",
                    f".labels() receives {hit!r} verbatim as a label "
                    f"value: unbounded cardinality — one child series "
                    f"per {hit} held forever; aggregate it away (shard, "
                    f"stage, outcome) or move it to the trace plane",
                )

    def finalize(self) -> Iterable[Finding]:
        for name, sites in sorted(self._families.items()):
            vocabs = {
                (vocab, kind) for vocab, kind, _p, _l in sites
                if vocab is not None
            }
            if len(vocabs) <= 1:
                continue
            # opposite-site LINE numbers stay out of the message: it is
            # part of the baseline identity, which must survive drift
            spelled = "; ".join(
                f"{kind}{list(vocab)} in {path}"
                for vocab, kind, path, _line in sites
                if vocab is not None
            )
            for vocab, _kind, path, line in sites:
                if vocab is None:
                    continue
                yield Finding(
                    path=path,
                    line=line,
                    rule=f"{self.name}.label-vocabulary-drift",
                    severity="error",
                    message=(
                        f"metric family {name!r} is registered with more "
                        f"than one label vocabulary or type ({spelled}): "
                        f"per-process registries render each copy fine "
                        f"and the drift only collides on the operator's "
                        f"dashboard — one family, one vocabulary"
                    ),
                )
