"""Plane gating: capability-gated wire and store fields never written
outside their plane's flag check.

Every opt-in plane (payload blobs, tracing, tenancy, batching,
speculation) ships with the contract that OFF means a byte-identical
wire and store surface — reference-era workers and clients must never
see a field they did not negotiate. Until now every PR re-proved that
with tests; this checker derives the gate map from the code and proves
it at rest:

- the CAPABILITY REGISTRY is derived from ``CAP_* = "token"`` constants
  (``worker/messages.py``) and the membership tests ``CAP_X in caps``
  at the negotiation sites;
- the REFERENCE SURFACE is derived from the ``FIELD_*`` constants read
  inside ``Task.to_fields()`` (``core/task.py``) — those fields predate
  every plane and are exempt;
- the GATED-FIELD MAP is derived from occurrence: a ``FIELD_*``-keyed
  (or literal-string wire-keyed) subscript write that appears under a
  PLANE GATE anywhere registers that field as plane-gated. A plane gate
  is an ``if`` whose test contains a capability membership check,
  references a name whose last segment is a declared capability token
  (``ctx.trace``, the ``blob=``/``trace=`` params the dispatcher binds
  to cap tests), a ``use_*`` plane flag, or a ``*_plane`` attribute.

Once a field is registered as gated, EVERY statically-reachable write
of it must sit under a plane gate or a PRESENCE GATE — an enclosing
``if`` whose test mentions the written value (``if trace_id is not
None: fields[FIELD_TRACE_ID] = trace_id``), the idiom result-observe
and worker-echo sites use to round-trip a field only when it arrived.
Unconditional fields the gateway stamps on every record
(``FIELD_SUBMITTED_AT``) are never registered and never constrained —
the map is derived, not asserted.

Rules:

- ``planegate.ungated-field-write`` (error) — a ``FIELD_*``-keyed write
  of a plane-gated, post-reference field with no plane or presence gate
  in scope: the off-surface is no longer byte-identical.
- ``planegate.ungated-wire-write`` (error) — same, for the literal
  wire keys (``"fn_digest"``, ``"trace_id"``) the worker frames carry
  only under a negotiated capability.
- ``planegate.unknown-capability`` (error) — a membership test names a
  ``CAP_*`` constant no module in the run declares: the negotiation
  would silently never match.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass
from typing import Iterable

from tpu_faas_torch.analysis.core import Checker, Finding, Module, dotted_name

_CAP_NAME_RE = re.compile(r"^CAP_[A-Z0-9_]+$")
_FIELD_NAME_RE = re.compile(r"^FIELD_[A-Z0-9_]+$")
_USE_FLAG_RE = re.compile(r"^use_[a-z0-9_]+$")


def _names_in(node: ast.AST) -> set[str]:
    """Every dotted name (and bare name) referenced in an expression —
    the currency of presence-gate matching."""
    out: set[str] = set()
    for sub in ast.walk(node):
        name = dotted_name(sub)
        if name is not None:
            out.add(name)
    return out


def _cap_tests_in(node: ast.AST) -> set[str]:
    """``CAP_*`` constant names used as the left side of an ``in``
    membership test anywhere inside ``node``."""
    out: set[str] = set()
    for sub in ast.walk(node):
        if not isinstance(sub, ast.Compare):
            continue
        if not any(isinstance(op, ast.In) for op in sub.ops):
            continue
        last = (dotted_name(sub.left) or "").rsplit(".", 1)[-1]
        if _CAP_NAME_RE.match(last):
            out.add(last)
    return out


@dataclass
class _Write:
    module: Module
    node: ast.AST
    field: str  # FIELD_* constant name, or the literal wire key
    is_wire: bool
    gates: list[ast.AST]  # enclosing if-tests (body side only)
    value_names: set[str]


class PlaneGateChecker(Checker):
    name = "planegate"

    def __init__(self) -> None:
        #: declared CAP_* constants -> their token values
        self.capabilities: dict[str, str] = {}
        #: declared FIELD_* constants -> their wire values
        self.fields: dict[str, str] = {}
        #: FIELD_* names read inside ``to_fields`` — the reference era
        self.reference_fields: set[str] = set()
        #: parameter names bound to a cap test at some call site
        self.gate_params: set[str] = set()
        self._writes: list[_Write] = []
        self._cap_uses: list[tuple[Module, ast.AST, str]] = []

    # -- collection --------------------------------------------------------

    def check(self, module: Module) -> Iterable[Finding]:
        for stmt in module.tree.body:
            if (
                isinstance(stmt, ast.Assign)
                and len(stmt.targets) == 1
                and isinstance(stmt.targets[0], ast.Name)
                and isinstance(stmt.value, ast.Constant)
                and isinstance(stmt.value.value, str)
            ):
                name = stmt.targets[0].id
                if _CAP_NAME_RE.match(name):
                    self.capabilities[name] = stmt.value.value
                elif _FIELD_NAME_RE.match(name):
                    self.fields[name] = stmt.value.value
        for node in ast.walk(module.tree):
            if (
                isinstance(node, ast.FunctionDef)
                and node.name == "to_fields"
            ):
                for sub in ast.walk(node):
                    if isinstance(sub, ast.Name) and _FIELD_NAME_RE.match(
                        sub.id
                    ):
                        self.reference_fields.add(sub.id)
            if isinstance(node, ast.Call):
                for kw in node.keywords:
                    if kw.arg is not None and _cap_tests_in(kw.value):
                        self.gate_params.add(kw.arg)
            for cap in _cap_tests_in(node) if isinstance(
                node, ast.Compare
            ) else ():
                self._cap_uses.append((module, node, cap))
        self._collect_writes(module, module.tree.body, [])
        return ()

    def _collect_writes(self, module, body, gates) -> None:
        """Statement walk threading the stack of enclosing ``if`` tests —
        only the BODY side inherits a gate; ``else`` is by definition the
        plane-off path and must not."""
        for stmt in body:
            if isinstance(stmt, ast.If):
                self._collect_writes(
                    module, stmt.body, gates + [stmt.test]
                )
                self._collect_writes(module, stmt.orelse, gates)
                continue
            if isinstance(stmt, (ast.For, ast.AsyncFor, ast.While)):
                self._collect_writes(module, stmt.body, gates)
                self._collect_writes(module, stmt.orelse, gates)
                continue
            if isinstance(stmt, (ast.With, ast.AsyncWith)):
                self._collect_writes(module, stmt.body, gates)
                continue
            if isinstance(stmt, ast.Try):
                for part in (
                    stmt.body,
                    stmt.orelse,
                    stmt.finalbody,
                    *[h.body for h in stmt.handlers],
                ):
                    self._collect_writes(module, part, gates)
                continue
            if isinstance(
                stmt,
                (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef),
            ):
                # a nested scope starts a fresh gate stack: the enclosing
                # test does not guard when the inner function RUNS
                self._collect_writes(module, stmt.body, [])
                continue
            if isinstance(stmt, ast.Assign):
                for t in stmt.targets:
                    self._record_write(module, t, stmt.value, gates)
            elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
                self._record_write(module, stmt.target, stmt.value, gates)

    def _record_write(self, module, target, value, gates) -> None:
        if not isinstance(target, ast.Subscript):
            return
        key = target.slice
        field = None
        is_wire = False
        last = (dotted_name(key) or "").rsplit(".", 1)[-1]
        if _FIELD_NAME_RE.match(last):
            field = last
        elif isinstance(key, ast.Constant) and isinstance(key.value, str):
            field = key.value
            is_wire = True
        if field is None:
            return
        self._writes.append(
            _Write(
                module=module,
                node=target,
                field=field,
                is_wire=is_wire,
                gates=list(gates),
                value_names=_names_in(value),
            )
        )

    # -- judgement ---------------------------------------------------------

    def _is_plane_gate(self, test: ast.AST) -> bool:
        if _cap_tests_in(test):
            return True
        cap_tokens = set(self.capabilities.values())
        for name in _names_in(test):
            last = name.rsplit(".", 1)[-1]
            if (
                last in cap_tokens
                or last in self.gate_params
                or _USE_FLAG_RE.match(last)
                or last.endswith("_plane")
            ):
                return True
        return False

    @staticmethod
    def _is_presence_gate(test: ast.AST, write: _Write) -> bool:
        return bool(_names_in(test) & write.value_names)

    def finalize(self) -> Iterable[Finding]:
        if self.capabilities:
            for module, node, cap in self._cap_uses:
                if cap not in self.capabilities:
                    yield self.finding(
                        module,
                        node,
                        "unknown-capability",
                        "error",
                        f"membership test names {cap}, which no module "
                        f"declares (declared: "
                        f"{sorted(self.capabilities)}) — this "
                        f"negotiation can never match",
                    )
        # derive the gated map from occurrence: a field written under a
        # plane gate anywhere is a plane field everywhere. Wire keys are
        # constrained only when they belong to the FIELD_* value
        # vocabulary — an arbitrary dict write under an incidental flag
        # must not conscript every same-keyed write in the tree.
        field_values = set(self.fields.values())
        gated_fields: set[str] = set()
        gated_wire: set[str] = set()
        for w in self._writes:
            if w.is_wire and w.field not in field_values:
                continue
            if any(self._is_plane_gate(t) for t in w.gates):
                if w.is_wire:
                    gated_wire.add(w.field)
                else:
                    gated_fields.add(w.field)
        # a FIELD_* constant whose wire value is a gated wire key gates
        # the constant-keyed writes too (and vice versa)
        for name, value in self.fields.items():
            if name in gated_fields:
                gated_wire.add(value)
            if value in gated_wire and name not in self.reference_fields:
                gated_fields.add(name)
        # exposed for the real-tree pin test: the derived map IS the spec
        self.gated_fields = gated_fields
        self.gated_wire = gated_wire
        reference_values = {
            self.fields[n]
            for n in self.reference_fields
            if n in self.fields
        }
        for w in self._writes:
            if w.is_wire:
                if w.field not in gated_wire or w.field not in field_values:
                    continue
                if w.field in reference_values:
                    continue
                rule = "ungated-wire-write"
                label = f"wire field '{w.field}'"
            else:
                if (
                    w.field not in gated_fields
                    or w.field in self.reference_fields
                ):
                    continue
                rule = "ungated-field-write"
                label = f"store field {w.field}"
            if any(
                self._is_plane_gate(t) or self._is_presence_gate(t, w)
                for t in w.gates
            ):
                continue
            yield self.finding(
                w.module,
                w.node,
                rule,
                "error",
                f"{label} is plane-gated elsewhere but written here "
                f"with no capability/plane flag or presence check in "
                f"scope — the plane-off wire/store surface is no "
                f"longer byte-identical (gate the write like its "
                f"sibling sites, or presence-guard it on the value it "
                f"round-trips)",
            )
