"""Graph-submission validation: refs, acyclicity, size caps.

The gateway admits a whole graph atomically (admission charges every node
up front), so validation must be complete BEFORE any store write: a cycle
discovered after half the nodes were created would leave acknowledged
WAITING records whose parents can never finish. Everything here is pure
and store-free.
"""

from __future__ import annotations

import os
from collections import deque

#: Hard cap on nodes per graph submission (env-overridable). Bounds the
#: gateway's create pipeline, the FIELD_CHILDREN/FIELD_DEPS field sizes,
#: and the device frontier's padded edge list.
MAX_GRAPH_NODES = int(os.environ.get("TPU_FAAS_MAX_GRAPH_NODES", "4096"))


class GraphValidationError(ValueError):
    """A graph submission the gateway must 400: bad refs, a cycle, or a
    size-cap violation. The message is client-facing."""


def _resolve_ref(ref, index: int, names: dict[str, int], n: int) -> int:
    """One depends_on entry -> node index. Accepts an integer index or a
    string naming another node's client-local ``id``."""
    if isinstance(ref, bool):
        raise GraphValidationError(
            f"nodes[{index}].depends_on contains a boolean; use an integer "
            "index or a node id string"
        )
    if isinstance(ref, int):
        if not 0 <= ref < n:
            raise GraphValidationError(
                f"nodes[{index}].depends_on references node {ref}, out of "
                f"range for {n} nodes"
            )
        return ref
    if isinstance(ref, str):
        target = names.get(ref)
        if target is None:
            raise GraphValidationError(
                f"nodes[{index}].depends_on references unknown node id "
                f"{ref!r}"
            )
        return target
    raise GraphValidationError(
        f"nodes[{index}].depends_on entries must be integer indices or "
        "node id strings"
    )


def validate_graph(
    nodes: list[dict], max_nodes: int | None = None
) -> tuple[list[list[int]], list[int]]:
    """Validate a graph submission; returns ``(deps, topo_order)`` where
    ``deps[i]`` is node i's parent indices (deduplicated, resolution of
    every depends_on ref) and ``topo_order`` is a topological order of the
    node indices (parents before children — Kahn's algorithm; its
    exhaustion proves acyclicity). Raises :class:`GraphValidationError`
    with a client-facing message on any violation."""
    cap = max_nodes if max_nodes is not None else MAX_GRAPH_NODES
    if not isinstance(nodes, list) or not nodes:
        raise GraphValidationError("'nodes' must be a non-empty list")
    if len(nodes) > cap:
        raise GraphValidationError(
            f"graph has {len(nodes)} nodes, above the cap of {cap} "
            "(TPU_FAAS_MAX_GRAPH_NODES); split the submission"
        )
    names: dict[str, int] = {}
    for i, node in enumerate(nodes):
        if not isinstance(node, dict):
            raise GraphValidationError(f"nodes[{i}] must be an object")
        name = node.get("id")
        if name is None:
            continue
        if not isinstance(name, str) or not name:
            raise GraphValidationError(
                f"nodes[{i}].id must be a non-empty string"
            )
        if name in names:
            raise GraphValidationError(
                f"nodes[{i}].id {name!r} duplicates nodes[{names[name]}].id"
            )
        names[name] = i
    n = len(nodes)
    deps: list[list[int]] = []
    for i, node in enumerate(nodes):
        raw = node.get("depends_on") or []
        if not isinstance(raw, list):
            raise GraphValidationError(
                f"nodes[{i}].depends_on must be a list"
            )
        seen: list[int] = []
        seen_set: set[int] = set()  # list keeps ref order; set keeps the
        # membership probe O(1) — a dense in-cap graph (4096 nodes x
        # thousands of refs) runs this inside the gateway event loop
        for ref in raw:
            parent = _resolve_ref(ref, i, names, n)
            if parent == i:
                raise GraphValidationError(
                    f"nodes[{i}] depends on itself"
                )
            if parent not in seen_set:
                seen_set.add(parent)
                seen.append(parent)
        deps.append(seen)
    # Kahn's algorithm: exhaustion == acyclic, and the pop order IS the
    # creation-safe topological order
    children: list[list[int]] = [[] for _ in range(n)]
    pending = [len(d) for d in deps]
    for i, d in enumerate(deps):
        for parent in d:
            children[parent].append(i)
    frontier = deque(i for i in range(n) if pending[i] == 0)
    topo: list[int] = []
    while frontier:
        i = frontier.popleft()
        topo.append(i)
        for child in children[i]:
            pending[child] -= 1
            if pending[child] == 0:
                frontier.append(child)
    if len(topo) != n:
        cyclic = sorted(i for i in range(n) if pending[i] > 0)
        raise GraphValidationError(
            f"graph contains a dependency cycle through nodes {cyclic[:8]}"
        )
    return deps, topo
