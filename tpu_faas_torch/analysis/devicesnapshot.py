"""Snapshot-before-upload: a host array copied to the card asynchronously
must not be mutated in place later in the same scope.

The PR 5 bug class as a rule, for torch. ``torch.from_numpy(a)`` shares
``a``'s memory, and a ``non_blocking=True`` copy to the card may read that
memory after the call returns: when the source lies in pinned memory (a
view of a pinned mirror) the copy is a DMA queued on the stream. An
in-place mutation of ``a`` later in the scope (``a[i] = v``, ``a += d``,
``a.fill(0)``) then races a tick that was already enqueued. The sanctioned
form is :func:`tpu_faas_torch.device.upload`, which snapshots into its own
pinned buffer first.

One rule:

- ``devicesnapshot.unsnapshotted-upload`` (error) — an asynchronous upload
  whose source is a live host array ``a`` (a bare name or attribute
  chain), which the SAME function later mutates in place with no
  rebinding of the name in between. The upload forms:

  - ``torch.from_numpy(a)`` (or ``torch.as_tensor(a)``, or a name bound
    to either) followed by ``.to(dev, non_blocking=True)`` or
    ``.cuda(non_blocking=True)``;
  - ``x.copy_(src, non_blocking=True)`` where ``src`` is such a view;
  - ``.pin_memory()`` on such a view, then a ``non_blocking`` copy:
    ``pin_memory()`` returns its input itself when that already lies in
    pinned memory (a view of a pinned mirror), so it is no snapshot.

  A view taken through a copy (``a.copy()``, ``np.array(a)``,
  ``.clone()``, ``device.upload(a)``) reads a private buffer and is
  exempt by construction; so is a blocking copy.

Scoping is textual and per function, as in the JAX checker: mutations that
finish before the upload are clean; a mutation on a textually later line
is the hazard.
"""

from __future__ import annotations

import ast
from typing import Iterable

from tpu_faas_torch.analysis.core import Checker, Finding, Module, dotted_name

#: calls that give a tensor sharing a host array's memory
_VIEW_CALLS = {"torch.from_numpy", "torch.as_tensor", "torch.asarray"}
#: methods that keep the view (same memory, or the input itself)
_VIEW_METHODS = {"pin_memory", "view", "reshape", "flatten", "contiguous",
                 "view_as", "unsqueeze", "squeeze"}
#: method calls that mutate an ndarray in place
_MUTATING_METHODS = {"fill", "sort", "put", "itemset", "partition", "resize"}


def _non_blocking(call: ast.Call) -> bool:
    return any(
        kw.arg == "non_blocking"
        and not (isinstance(kw.value, ast.Constant) and not kw.value.value)
        for kw in call.keywords
    )


class DeviceSnapshotChecker(Checker):
    name = "devicesnapshot"

    def check(self, module: Module) -> Iterable[Finding]:
        scopes: list[list[ast.stmt]] = [module.tree.body]
        for node in ast.walk(module.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                scopes.append(node.body)
        for body in scopes:
            yield from self._check_scope(module, body)

    def _check_scope(self, module, body) -> Iterable[Finding]:
        nodes = list(_walk_own_code(body))
        # names bound to a view of a host array: name -> the array
        views: dict[str, str] = {}
        for node in nodes:
            if (
                isinstance(node, ast.Assign)
                and len(node.targets) == 1
                and dotted_name(node.targets[0]) is not None
            ):
                src = self._view_source(node.value, views)
                if src is not None:
                    views[dotted_name(node.targets[0])] = src
        uploads: list[tuple[str, ast.Call]] = []
        mutations: dict[str, list[int]] = {}
        rebinds: dict[str, list[int]] = {}
        for node in nodes:
            if isinstance(node, ast.Call):
                target = self._upload_source(node, views)
                if target is not None:
                    uploads.append((target, node))
                fn = node.func
                if (
                    isinstance(fn, ast.Attribute)
                    and fn.attr in _MUTATING_METHODS
                ):
                    base = dotted_name(fn.value)
                    if base is not None:
                        mutations.setdefault(base, []).append(node.lineno)
            elif isinstance(node, (ast.Assign, ast.AnnAssign)):
                targets = (
                    node.targets
                    if isinstance(node, ast.Assign)
                    else [node.target]
                )
                for t in targets:
                    if isinstance(t, ast.Subscript):
                        base = dotted_name(t.value)
                        if base is not None:
                            mutations.setdefault(base, []).append(t.lineno)
                    else:
                        name = dotted_name(t)
                        if name is not None:
                            rebinds.setdefault(name, []).append(t.lineno)
            elif isinstance(node, ast.AugAssign):
                t = node.target
                base = (
                    dotted_name(t.value)
                    if isinstance(t, ast.Subscript)
                    else dotted_name(t)
                )
                if base is not None:
                    mutations.setdefault(base, []).append(node.lineno)
        for target, call in uploads:
            later = [
                line
                for line in mutations.get(target, [])
                if line > call.lineno
                # a rebinding between upload and mutation breaks the
                # aliasing: the mutation then hits a different object
                and not any(
                    call.lineno < r <= line for r in rebinds.get(target, [])
                )
            ]
            if later:
                yield self.finding(
                    module, call, "unsnapshotted-upload", "error",
                    f"'{target}' is copied to the card asynchronously here "
                    f"but mutated in place at line {min(later)} of the same "
                    f"scope: the copy may read the array after that "
                    f"mutation, which then leaks into the already-enqueued "
                    f"work — upload a snapshot (device.upload({target}), or "
                    f"torch.from_numpy({target}.copy()))",
                )

    def _view_source(self, node: ast.AST, views: dict[str, str]) -> str | None:
        """The host array ``node`` is a view of, or None."""
        if isinstance(node, (ast.Name, ast.Attribute)):
            return views.get(dotted_name(node) or "")
        if not isinstance(node, ast.Call):
            return None
        d = dotted_name(node.func)
        if d in _VIEW_CALLS and node.args:
            if any(kw.arg == "device" for kw in node.keywords):
                return None  # a copy made by the call itself
            return dotted_name(node.args[0])
        if isinstance(node.func, ast.Attribute) and (
            node.func.attr in _VIEW_METHODS
        ):
            return self._view_source(node.func.value, views)
        return None

    def _upload_source(self, call: ast.Call, views) -> str | None:
        """The live host array an asynchronous upload reads, or None."""
        if not isinstance(call.func, ast.Attribute) or not _non_blocking(
            call
        ):
            return None
        attr = call.func.attr
        if attr in ("to", "cuda"):
            return self._view_source(call.func.value, views)
        if attr == "copy_" and call.args:
            return self._view_source(call.args[0], views)
        return None


def _walk_own_code(body: list[ast.stmt]):
    """Every node of these statements, NOT descending into nested
    function/class definitions — each scope is judged on its own
    textual order."""
    stack: list[ast.AST] = [
        s
        for s in body
        if not isinstance(
            s, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
        )
    ]
    while stack:
        node = stack.pop()
        yield node
        for child in ast.iter_child_nodes(node):
            if not isinstance(
                child,
                (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef),
            ):
                stack.append(child)
