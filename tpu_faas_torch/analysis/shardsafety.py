"""Shard-safety checker: every statically-spelled store key belongs to a
declared namespace with a known routing rule.

The federated control plane (store/sharding.py) routes every key
deterministically: plain keys (task records, ``blob:``/``trace:``/
``function_digest:`` content) route by the consistent-hash ring, the live
index (``tasks:index``) partitions by FIELD, and the fleet coordination
hashes (``fleet:*``, ``dispatchers:alive``) broadcast on write and merge
on read. A key minted in a NEW namespace that the router has never heard
of still "works" on a single store and silently lands on one arbitrary
shard of a fleet — readers merging, broadcasting, or scanning by the
declared rules will simply not see it. This pass makes inventing a
namespace a compile-time decision instead of a failover-day discovery.

Rules:

- ``undeclared-namespace`` (error): a store operation whose key is
  statically spelled (a string literal, an f-string with a literal head,
  a known key constant, or a ``blob_key(...)``-style helper) does not
  match any declared namespace below. Declare the namespace here WITH its
  routing class (and teach ``ShardedStore`` the rule if it is not plain
  ring routing) before shipping the key.
- ``mixed-routing-pipeline`` (error): a literal multi-key batch
  (``hgetall_many``, ``delete_many``, ``hset_many`` items, ...) mixes
  routing classes outside ``tpu_faas/store/``. ``ShardedStore``'s batch
  forms special-case broadcast keys internally; a caller-side literal mix
  couples the call site to that special-casing — split the batch by
  routing class instead. Dynamically built batches are out of static
  scope (the partitioner handles them item by item at runtime).

Dynamic keys (task ids in variables) are out of static reach by design —
they are plain ring-routed keys, the default everything else is measured
against.
"""

from __future__ import annotations

import ast
from typing import Iterable, Iterator

from tpu_faas_torch.analysis.core import Checker, Finding, Module, dotted_name
from tpu_faas_torch.analysis.protocol import _in_store_package

#: The declared namespace table: (spelling, kind, routing class).
#: Spellings owned by store/base.py are DERIVED (that module is already
#: part of the suite's import surface via the protocol checker, so a
#: rename breaks this pass loudly). The two owned by admission/obs are
#: spelled LITERALLY instead — importing those packages here would widen
#: the suite's import footprint and crash the gate on a broken checkout
#: it is supposed to diagnose; a pin test in test_analysis_rules.py
#: asserts the literals against the runtime constants so they cannot
#: drift silently.
from tpu_faas_torch.store.base import (
    BLOB_PREFIX,
    BLOBREQ_PREFIX,
    DISPATCHERS_KEY,
    LEASE_CONF_KEY,
    LIVE_INDEX_KEY,
)

#: admission/signal.py FLEET_HEALTH_KEY (pin-tested, not imported).
FLEET_HEALTH_KEY = "fleet:health"
#: obs/tracectx.py TRACE_PREFIX (pin-tested, not imported).
TRACE_PREFIX = "trace:"

NAMESPACES: tuple[tuple[str, str, str], ...] = (
    (LIVE_INDEX_KEY, "exact", "field-partitioned"),  # tasks:index
    (FLEET_HEALTH_KEY, "exact", "broadcast"),
    (LEASE_CONF_KEY, "exact", "broadcast"),
    (DISPATCHERS_KEY, "exact", "broadcast"),
    ("fleet:", "prefix", "broadcast"),
    (BLOB_PREFIX, "prefix", "routed"),  # blob:<sha256>
    # blobreq:<sha256> — lazy-materialization request claims (result-blob
    # plane): ring-routed by digest so a requesting gateway and the
    # sweeper that ages the claim land on the same shard
    (BLOBREQ_PREFIX, "prefix", "routed"),
    (TRACE_PREFIX, "prefix", "routed"),  # trace:<trace_id>
    ("function_digest:", "prefix", "routed"),
    ("dep_done:", "prefix", "routed"),  # per-edge claim fields
    # estimator state (faas:fn_stats / faas:worker_stats): two well-known
    # singleton hashes, ring-routed — every client hashes the same
    # spelling to the same shard, so the fleet shares one copy of each
    ("faas:", "prefix", "routed"),
)

#: Identifier -> literal value, for keys spelled through their canonical
#: constants (imports are invisible to a per-module AST pass).
KNOWN_CONSTANTS: dict[str, str] = {
    "LIVE_INDEX_KEY": LIVE_INDEX_KEY,
    "FLEET_HEALTH_KEY": FLEET_HEALTH_KEY,
    "LEASE_CONF_KEY": LEASE_CONF_KEY,
    "DISPATCHERS_KEY": DISPATCHERS_KEY,
    "BLOB_PREFIX": BLOB_PREFIX,
    "BLOBREQ_PREFIX": BLOBREQ_PREFIX,
    "TRACE_PREFIX": TRACE_PREFIX,
}

#: Key-building helpers whose result namespace is known by construction.
_HELPER_PREFIXES: dict[str, str] = {
    "blob_key": BLOB_PREFIX,
    "blobreq_key": BLOBREQ_PREFIX,
    "trace_key": TRACE_PREFIX,
    "dep_done_field": "dep_done:",
}

#: Store methods whose FIRST argument is a single key.
_SINGLE_KEY_METHODS = frozenset(
    {"hset", "hget", "hgetall", "hmget", "hexists", "hdel", "delete",
     "hincrby", "setnx_field"}
)
#: Batch methods taking a list of keys.
_KEY_LIST_METHODS = frozenset(
    {"hget_many", "hgetall_many", "delete_many"}
)
#: Batch methods taking a list of (key, ...) tuples.
_KEY_TUPLE_METHODS = frozenset(
    {"hset_many", "setnx_fields", "hsetnx_many", "hincrby_many"}
)


def _receiver_is_store(node: ast.AST) -> bool:
    d = dotted_name(node)
    if d is None:
        return False
    return "store" in d.rsplit(".", 1)[-1].lower()


def classify(key: str, exact: bool) -> str | None:
    """The routing class of a resolved key spelling, or None when it
    matches no declared namespace. ``exact=False`` means ``key`` is a
    static PREFIX of a partially-dynamic spelling."""
    for spelling, kind, routing in NAMESPACES:
        if kind == "exact":
            if exact and key == spelling:
                return routing
            # a static prefix at least as long as the exact spelling can
            # only match by being exactly it
            if not exact and key.startswith(spelling):
                return routing
        elif key.startswith(spelling):
            return routing
        elif not exact and spelling.startswith(key) and key:
            # the static head stops short of the namespace delimiter
            # (f"{prefix}{x}" resolved through an unknown name): dynamic
            return "dynamic"
    return None


class ShardSafetyChecker(Checker):
    name = "shard"

    def check(self, module: Module) -> Iterable[Finding]:
        consts = dict(KNOWN_CONSTANTS)
        for node in module.tree.body:
            if isinstance(node, ast.Assign) and len(node.targets) == 1:
                t = node.targets[0]
                if (
                    isinstance(t, ast.Name)
                    and isinstance(node.value, ast.Constant)
                    and isinstance(node.value.value, str)
                ):
                    consts[t.id] = node.value.value
        store_internal = _in_store_package(module)
        for node in ast.walk(module.tree):
            if not (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and _receiver_is_store(node.func.value)
            ):
                continue
            method = node.func.attr
            if method in _SINGLE_KEY_METHODS:
                if node.args:
                    yield from self._check_key(
                        module, node, node.args[0], consts
                    )
            elif method in _KEY_LIST_METHODS:
                yield from self._check_batch(
                    module, node, consts, store_internal, tuples=False
                )
            elif method in _KEY_TUPLE_METHODS:
                yield from self._check_batch(
                    module, node, consts, store_internal, tuples=True
                )

    # -- key resolution ----------------------------------------------------
    def _resolve(
        self, node: ast.AST, consts: dict[str, str]
    ) -> tuple[str, bool] | None:
        """(text, is_exact) for a statically-spelled key, else None."""
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            return node.value, True
        d = dotted_name(node)
        if d is not None:
            name = d.rsplit(".", 1)[-1]
            if name in consts:
                return consts[name], True
            return None
        if isinstance(node, ast.JoinedStr):
            head: list[str] = []
            exact = True
            for value in node.values:
                if isinstance(value, ast.Constant) and isinstance(
                    value.value, str
                ):
                    head.append(value.value)
                elif isinstance(value, ast.FormattedValue):
                    resolved = self._resolve(value.value, consts)
                    if resolved is not None and resolved[1]:
                        head.append(resolved[0])
                        continue
                    exact = False
                    break
            text = "".join(head)
            return (text, exact) if text else None
        if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
            left = self._resolve(node.left, consts)
            if left is not None:
                right = self._resolve(node.right, consts)
                if right is not None and left[1] and right[1]:
                    return left[0] + right[0], True
                return left[0], False
            return None
        if isinstance(node, ast.Call):
            fn = dotted_name(node.func)
            if fn is not None:
                prefix = _HELPER_PREFIXES.get(fn.rsplit(".", 1)[-1])
                if prefix is not None:
                    return prefix, False
        return None

    def _routing_of(
        self, key_node: ast.AST, consts: dict[str, str]
    ) -> tuple[str | None, str] | None:
        """(routing-or-None, spelling) for a static key; None when the
        key is fully dynamic (out of static scope)."""
        resolved = self._resolve(key_node, consts)
        if resolved is None:
            return None
        text, exact = resolved
        routing = classify(text, exact)
        if routing == "dynamic":
            return None
        if routing is None and not exact and ":" not in text:
            # a static head that never reaches a namespace delimiter
            # pins nothing down
            return None
        return routing, text

    # -- rules -------------------------------------------------------------
    def _check_key(
        self,
        module: Module,
        call: ast.Call,
        key_node: ast.AST,
        consts: dict[str, str],
    ) -> Iterator[Finding]:
        got = self._routing_of(key_node, consts)
        if got is None or got[0] is not None:
            return
        declared = ", ".join(
            f"{s!r} ({r})" for s, _k, r in NAMESPACES
        )
        yield self.finding(
            module, call, "undeclared-namespace", "error",
            f"store key {got[1]!r} matches no declared namespace: on a "
            f"sharded fleet an undeclared key lands on one arbitrary "
            f"shard and the routed/broadcast/field-partitioned readers "
            f"never see it — declare the namespace (and its routing "
            f"rule) in analysis/shardsafety.py and teach ShardedStore "
            f"if it is not plain ring routing (declared: {declared})",
        )

    def _check_batch(
        self,
        module: Module,
        call: ast.Call,
        consts: dict[str, str],
        store_internal: bool,
        tuples: bool,
    ) -> Iterator[Finding]:
        items = call.args[0] if call.args else None
        if items is None:
            for kw in call.keywords:
                if kw.arg in ("items", "keys"):
                    items = kw.value
        if not isinstance(items, (ast.List, ast.Tuple)):
            return
        classes: dict[str, str] = {}
        for elt in items.elts:
            key_node = elt
            if tuples:
                if not isinstance(elt, ast.Tuple) or not elt.elts:
                    continue
                key_node = elt.elts[0]
            got = self._routing_of(key_node, consts)
            if got is None:
                continue
            routing, text = got
            if routing is None:
                yield from self._check_key(module, call, key_node, consts)
            else:
                classes.setdefault(routing, text)
        if len(classes) > 1 and not store_internal:
            detail = ", ".join(
                f"{text!r} is {routing}"
                for routing, text in sorted(classes.items())
            )
            yield self.finding(
                module, call, "mixed-routing-pipeline", "error",
                f"multi-key batch mixes routing classes ({detail}) "
                f"outside tpu_faas/store/: ShardedStore's batch forms "
                f"special-case broadcast keys internally, and leaning on "
                f"that from a call site couples it to the partitioner — "
                f"split the batch by routing class",
            )
