"""Replication-completeness checker: the five store-command registries
must change together.

A mutating store primitive (HSET, HSETNX, HINCRBY, HDEL, DEL, PUBLISH,
FLUSHDB, and whatever comes next) is spelled in FIVE places that have no
compile-time link to each other:

1. the Python RESP server's command dispatch
   (``store/server.py StoreServer._dispatch`` — the branch that executes
   it and calls ``_replicate``),
2. the replication forward set
   (``store/replication.py MUTATING_COMMANDS`` — what a replica refuses
   from clients, a fenced primary refuses from everyone, and a primary
   forwards down its streams),
3. the replica apply switch (``store/server.py apply_replicated`` — how a
   forwarded command lands on the replica),
4. the sharded batch partitioner (``store/sharding.py ShardedStore`` —
   the routed/broadcast method surface every fleet client goes through),
5. the race monitor's pass-through surface
   (``store/racecheck.py RaceCheckStore``),

plus the native C++ server's command table (``native/store_server.cpp``),
which must keep data-plane parity so graph/payload workloads run on the
production binary. PR 8's HINCRBY touched every one of these by hand;
this pass proves the sync at rest instead of rediscovering a gap in
review (a primitive present in the dispatch but absent from the forward
set silently un-replicates it; absent from the apply switch it is
forwarded and DROPPED; absent from the partitioner or the monitor it
bypasses routing or observation).

Mechanism: each registry is recognized STRUCTURALLY in the scanned source
(an assignment named ``MUTATING_COMMANDS``, a function named
``_dispatch`` whose ``name == "CMD"`` branches call ``_replicate``, a
function named ``apply_replicated``, classes named ``ShardedStore`` /
``RaceCheckStore``, and the C++ table found by walking up from the
dispatch module to ``native/store_server.cpp``) — so the pass runs
identically over the shipped tree and over toy fixtures in tests. The
mutating set is DERIVED per run: the union of the forward set, the apply
switch's branches, and every dispatch branch that replicates. Any found
registry missing any member of that set is an error.

One rule: ``registry-drift`` (error). Findings anchor at the incomplete
registry's definition line (the native table anchors at the dispatch
module, which is how it was located). See the registry-drift triage row
in docs/OPERATIONS.md for the fix recipe.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Iterable

from tpu_faas_torch.analysis.core import Checker, Finding, Module

_COMMAND_RE = re.compile(r"^[A-Z][A-Z0-9_]*$")
#: ``name == "HSET"`` comparisons in a C++ dispatch chain.
_NATIVE_BRANCH_RE = re.compile(r'name\s*==\s*"([A-Z][A-Z0-9_]*)"')
#: Variable names that hold the command word in a dispatch switch.
_DISPATCH_VARS = ("name", "cmd", "command")

#: Store-API methods that implement each RESP primitive, for the
#: class-shaped registries (partitioner, monitor pass-throughs). A
#: command not listed maps to its own lowercase spelling — so the NEXT
#: primitive is checked by default instead of skipped.
_METHOD_COVERAGE: dict[str, tuple[str, ...]] = {
    "HSET": ("hset", "hset_many"),
    "HSETNX": ("setnx_field", "setnx_fields", "hsetnx_many"),
    "HINCRBY": ("hincrby", "hincrby_many"),
    "HDEL": ("hdel",),
    "DEL": ("delete", "delete_many"),
    "PUBLISH": ("publish", "publish_many"),
    "FLUSHDB": ("flush",),
}


def _methods_for(command: str) -> tuple[str, ...]:
    return _METHOD_COVERAGE.get(command, (command.lower(),))


@dataclass
class _Registry:
    kind: str  # forward | dispatch | apply | sharded | racecheck | native
    label: str  # human name used in messages
    path: str  # finding anchor (module relpath)
    line: int
    commands: set[str] = field(default_factory=set)
    #: dispatch only: the subset of commands whose branch replicates
    replicating: set[str] = field(default_factory=set)
    methods: set[str] = field(default_factory=set)

    def covers(self, command: str) -> bool:
        if self.kind in ("sharded", "racecheck"):
            return any(m in self.methods for m in _methods_for(command))
        if self.kind == "dispatch":
            # handling the command is not enough: the branch must FORWARD
            # it (_replicate), or the primary mutates and replicas
            # silently diverge — the exact defect class this checker
            # exists to close
            return command in self.replicating
        return command in self.commands


def _branch_command(test: ast.AST) -> str | None:
    """The command a dispatch-switch test pins: ``name == "HSET"``."""
    if (
        isinstance(test, ast.Compare)
        and len(test.ops) == 1
        and isinstance(test.ops[0], ast.Eq)
        and isinstance(test.left, ast.Name)
        and test.left.id in _DISPATCH_VARS
        and isinstance(test.comparators[0], ast.Constant)
        and isinstance(test.comparators[0].value, str)
        and _COMMAND_RE.match(test.comparators[0].value)
    ):
        return test.comparators[0].value
    return None


def _calls_replicate(body: list[ast.stmt]) -> bool:
    for stmt in body:
        for node in ast.walk(stmt):
            if isinstance(node, ast.Call):
                fn = node.func
                name = (
                    fn.attr if isinstance(fn, ast.Attribute)
                    else fn.id if isinstance(fn, ast.Name) else None
                )
                if name in ("_replicate", "replicate"):
                    return True
    return False


def _string_set_members(value: ast.AST) -> set[str] | None:
    """Members of ``frozenset({...})`` / ``set([...])`` / a bare set or
    tuple literal of command strings; None when the value is dynamic."""
    if isinstance(value, ast.Call) and isinstance(value.func, ast.Name):
        if value.func.id in ("frozenset", "set") and value.args:
            return _string_set_members(value.args[0])
        return None
    if isinstance(value, (ast.Set, ast.List, ast.Tuple)):
        out: set[str] = set()
        for elt in value.elts:
            if isinstance(elt, ast.Constant) and isinstance(elt.value, str):
                out.add(elt.value)
        return out
    return None


def _find_native_table(anchor: Path) -> tuple[str, set[str]] | None:
    """Walk up from the dispatch module looking for the C++ server's
    source; returns (display path, commands) when found. Bounded walk —
    scanning an isolated fixture directory simply finds nothing."""
    for parent in list(anchor.resolve().parents)[:6]:
        cand = parent / "native" / "store_server.cpp"
        if cand.is_file():
            try:
                text = cand.read_text(encoding="utf-8")
            except OSError:
                return None
            return "native/store_server.cpp", set(
                _NATIVE_BRANCH_RE.findall(text)
            )
    return None


class RegistryChecker(Checker):
    name = "replication"

    def __init__(self) -> None:
        self._registries: list[_Registry] = []
        self._native_seen: set[str] = set()

    def check(self, module: Module) -> Iterable[Finding]:
        for node in ast.walk(module.tree):
            if isinstance(node, ast.Assign):
                for target in node.targets:
                    if (
                        isinstance(target, ast.Name)
                        and target.id == "MUTATING_COMMANDS"
                    ):
                        members = _string_set_members(node.value)
                        if members is not None:
                            self._registries.append(_Registry(
                                "forward",
                                "replication forward set "
                                "(MUTATING_COMMANDS)",
                                module.relpath, node.lineno,
                                commands=members,
                            ))
            elif isinstance(
                node, (ast.FunctionDef, ast.AsyncFunctionDef)
            ):
                if node.name == "_dispatch":
                    self._collect_dispatch(module, node)
                elif node.name == "apply_replicated":
                    self._collect_apply(module, node)
            elif isinstance(node, ast.ClassDef):
                if node.name in ("ShardedStore", "RaceCheckStore"):
                    kind = (
                        "sharded" if node.name == "ShardedStore"
                        else "racecheck"
                    )
                    label = (
                        "sharded batch partitioner (ShardedStore)"
                        if kind == "sharded"
                        else "race monitor pass-throughs (RaceCheckStore)"
                    )
                    self._registries.append(_Registry(
                        kind, label, module.relpath, node.lineno,
                        methods={
                            m.name for m in node.body
                            if isinstance(m, ast.FunctionDef)
                        },
                    ))
        return ()

    def _collect_dispatch(self, module: Module, fn: ast.AST) -> None:
        reg = _Registry(
            "dispatch",
            "RESP server command dispatch (_dispatch)",
            module.relpath, fn.lineno,
        )
        for node in ast.walk(fn):
            if isinstance(node, ast.If):
                cmd = _branch_command(node.test)
                if cmd is not None:
                    reg.commands.add(cmd)
                    if _calls_replicate(node.body):
                        reg.replicating.add(cmd)
        if not reg.commands:
            # a function that merely SHARES the name (dispatcher-side
            # _dispatch methods) is not a command switch
            return
        self._registries.append(reg)
        native = _find_native_table(module.path.parent)
        if native is not None and native[0] not in self._native_seen:
            self._native_seen.add(native[0])
            self._registries.append(_Registry(
                "native",
                f"native server command table ({native[0]})",
                module.relpath, fn.lineno,
                commands=native[1],
            ))

    def _collect_apply(self, module: Module, fn: ast.AST) -> None:
        reg = _Registry(
            "apply",
            "replica apply switch (apply_replicated)",
            module.relpath, fn.lineno,
        )
        for node in ast.walk(fn):
            if isinstance(node, ast.If):
                cmd = _branch_command(node.test)
                if cmd is not None:
                    reg.commands.add(cmd)
        self._registries.append(reg)

    def finalize(self) -> Iterable[Finding]:
        mutating: set[str] = set()
        for reg in self._registries:
            if reg.kind in ("forward", "apply"):
                mutating |= reg.commands
            elif reg.kind == "dispatch":
                mutating |= reg.replicating
        if not mutating:
            return
        for reg in self._registries:
            for command in sorted(mutating):
                if reg.covers(command):
                    continue
                holders = sorted(
                    r.label for r in self._registries
                    if r is not reg and r.covers(command)
                )
                expected = (
                    " (expected a method named one of: "
                    + ", ".join(_methods_for(command)) + ")"
                    if reg.kind in ("sharded", "racecheck") else ""
                )
                gap = f"missing from the {reg.label}{expected}"
                if reg.kind == "dispatch" and command in reg.commands:
                    gap = (
                        f"handled by the {reg.label} WITHOUT a _replicate "
                        f"call — the primary mutates and replicas "
                        f"silently diverge"
                    )
                yield Finding(
                    path=reg.path,
                    line=reg.line,
                    rule=f"{self.name}.registry-drift",
                    severity="error",
                    message=(
                        f"mutating primitive {command} is registered in "
                        f"{', '.join(holders) or 'no other registry'} but "
                        f"{gap}: the store-command registries must change "
                        f"together (see the registry-drift triage row in "
                        f"docs/OPERATIONS.md)"
                    ),
                )
