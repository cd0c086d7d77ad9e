"""Trace-safety checker for the port: host syncs on the card's path.

JAX's checker scopes every function reachable under ``jax.jit`` /
``shard_map`` / ``pallas_call``, where a host read is a trace-time error.
The port has no trace: its device path is eager PyTorch, and a host read
there is legal but stalls the host until the card has drained the stream
(the host enqueue is most of a rank tick, ``PERF.md`` section 5). So the
scope here is every function reachable from the card's device entry
points, declared in :data:`ROOTS`:

- ``SchedulerArrays.tick`` and ``state.packed_tick`` (the batch tick);
- ``ResidentScheduler.tick_resident``, ``_launch`` and ``resolve_next``
  (the resident tick and its readback), and the ``FusedTickKernel``
  entries with
  ``fused_resident_tick`` (kernel B1's wrapper);
- ``bid.bid_top2`` (kernel B2's wrapper);
- the sharded functions of ``parallel/mesh.py`` (``sharded_*`` and
  ``ring_winner_resolve``), and the multihost lead's and followers' ticks
  (``MultihostTick``, ``MultihostResidentScheduler``).

A root is named by its module's path suffix and its qualified name, so a
fixture tree (``sched/bid.py`` under a scratch directory) has roots too.
Reachability is the transitive closure over the functions a reached
function names: same-module functions, names imported from another
scanned module (``from m import f``, ``m.f``), ``self.method`` within the
class, and ``KERNEL(...)`` / ``KERNEL.entry(...)`` on a module-level
instance of a scanned class. It over-approximates: a function named on the
CPU branch of a wrapper is in scope too.

Which values are tensors is inferred from source text alone, per
function and without flow order: parameters annotated ``torch.Tensor``
(or a class of the run whose fields are tensors), names assigned from a
``torch.*`` call, from a function of the run whose return annotation is a
tensor, from a field of such a class (``out.n_pending``), or from an
operation, index or method call on a tensor; ``to_host``, ``int()``,
``len()`` and the shape probes (``.shape``, ``.dtype``, ``.device``,
``.numel()`` ...) give host values.

Rules inside the scope:

- ``host-sync`` (error): ``.item()``, ``.tolist()``, ``.cpu()`` or
  ``.numpy()`` of a tensor, ``float()``/``int()``/``bool()`` of a tensor,
  ``torch.tensor(..., device=...)``/``torch.as_tensor(..., device=...)``
  (a host value copied synchronously), an op whose output size depends on
  the data (``nonzero()``, ``argwhere``, ``masked_select``, ``unique``,
  one-argument ``torch.where``), ``torch.cuda.synchronize()`` or any
  ``.synchronize()``, and every call of ``to_host`` (the port's readback).
  A sanctioned readback is suppressed at its site with its reason; the
  suppressions are the static inventory of host syncs on the card's path.
- ``data-dependent-branch`` (error): Python ``if``/``while`` (or a
  conditional expression) on a tensor: ``bool(tensor)`` is a sync, and
  the branch waits for the card. ``is None`` tests, ``isinstance`` and
  the shape probes are static.
- ``print`` (warning): a print on the card's path.

Dropped from JAX's checker, with the reason:

- ``host-time``, ``python-random`` and ``state-mutation`` guard values a
  trace freezes into the compiled graph as constants. An eager torch
  function has no trace: it reads the clock, draws a random number or
  mutates captured state on every call, so none of the three is a hazard.
- ``unknown-axis-name`` checks collectives against the axis names of
  ``Mesh(...)`` declarations. The port's collectives (``psum``, ``pmax``,
  ``ppermute``, ``all_gather`` in ``parallel/mesh.py``) take the ``Mesh``
  object itself, the position list ``make_mesh`` built, as their first
  argument and name no axis; ``TASK_AXIS`` survives only as the key of
  ``Mesh.shape``. There is no name to leave unbound, so nothing is left
  to check.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Iterable, Iterator

from tpu_faas_torch.analysis.core import Checker, Finding, Module, dotted_name

#: The card's device entry points: (module path suffix, qualified name).
#: A ``*`` suffix on the name takes every module-level function with that
#: prefix.
ROOTS: tuple[tuple[str, str], ...] = (
    ("sched/state.py", "SchedulerArrays.tick"),
    ("sched/state.py", "packed_tick"),
    ("sched/resident.py", "ResidentScheduler.tick_resident"),
    ("sched/resident.py", "ResidentScheduler._launch"),
    ("sched/resident.py", "ResidentScheduler.resolve_next"),
    ("sched/fused_tick.py", "FusedTickKernel.__call__"),
    ("sched/fused_tick.py", "FusedTickKernel.auction"),
    ("sched/fused_tick.py", "FusedTickKernel.sinkhorn"),
    ("sched/fused_tick.py", "fused_resident_tick"),
    ("sched/bid.py", "bid_top2"),
    ("parallel/mesh.py", "sharded_*"),
    ("parallel/mesh.py", "ring_winner_resolve"),
    ("parallel/multihost_tick.py", "MultihostTick.lead_tick"),
    ("parallel/multihost_tick.py", "MultihostTick.follow_loop"),
    ("parallel/multihost_resident.py", "MultihostResidentScheduler._dispatch"),
    ("parallel/multihost_resident.py",
     "MultihostResidentScheduler.follow_loop"),
)

#: ``torch.*`` calls that give no tensor
_TORCH_HOST = frozenset({
    "device", "Size", "dtype", "is_tensor", "get_default_dtype",
    "get_num_threads", "set_num_threads", "manual_seed", "finfo", "iinfo",
    "no_grad", "inference_mode", "Generator",
})
#: methods and attributes of a tensor that give host values
_SHAPE_ATTRS = frozenset({
    "shape", "ndim", "dtype", "device", "is_cuda", "layout",
})
_SHAPE_METHODS = frozenset({
    "size", "dim", "numel", "data_ptr", "stride", "is_contiguous",
    "element_size", "get_device", "storage_offset", "nelement",
})
_STATIC_PROBES = frozenset({
    "len", "isinstance", "getattr", "hasattr", "type", "id", "callable",
})
#: calls whose result lies on the host
_HOST_RESULT = frozenset({"to_host", "int", "float", "bool", "len", "str"})
_HOST_RESULT_METHODS = frozenset({"item", "tolist", "numpy"})
#: ops whose output size depends on the data
_DATA_SIZED = frozenset({
    "nonzero", "argwhere", "masked_select", "unique", "unique_consecutive",
})


def _last(dotted: str) -> str:
    return dotted.rsplit(".", 1)[-1]


def _module_name(relpath: str) -> str:
    """``tpu_faas_torch/sched/state.py`` -> ``tpu_faas_torch.sched.state``."""
    rel = relpath[:-3] if relpath.endswith(".py") else relpath
    parts = rel.split("/")
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


def _annotation_text(node: ast.AST | None) -> str:
    return ast.unparse(node) if node is not None else ""


@dataclass
class _Fn:
    module: Module
    node: ast.FunctionDef | ast.AsyncFunctionDef
    qualname: str
    cls: str | None
    traced: bool = False


@dataclass
class _ModInfo:
    module: Module
    name: str
    #: local name -> (module name, attribute or None for a module alias)
    imports: dict[str, tuple[str, str | None]] = field(default_factory=dict)
    #: simple name -> defs of that name anywhere in the module
    by_name: dict[str, list[_Fn]] = field(default_factory=dict)
    #: qualified name -> def
    by_qual: dict[str, _Fn] = field(default_factory=dict)
    #: module-level NAME = Class(...) instances
    instances: dict[str, str] = field(default_factory=dict)


class TraceSafetyChecker(Checker):
    name = "trace"

    def __init__(self) -> None:
        self._mods: list[_ModInfo] = []
        #: roots found in the run, as (suffix, qualname) of ROOTS
        self.found_roots: set[tuple[str, str]] = set()
        #: qualified names ("module:qualname") of every traced function
        self.traced: set[str] = set()

    # -- collection --------------------------------------------------------
    def check(self, module: Module) -> Iterable[Finding]:
        info = _ModInfo(module, _module_name(module.relpath))
        pkg = info.name.rsplit(".", 1)[0] if "." in info.name else ""
        if module.relpath.endswith("__init__.py"):
            pkg = info.name
        for node in ast.walk(module.tree):
            if isinstance(node, ast.ImportFrom):
                base = node.module or ""
                if node.level:
                    up = pkg.split(".")
                    up = up[: len(up) - node.level + 1] if pkg else []
                    base = ".".join(up + ([base] if base else []))
                for a in node.names:
                    info.imports[a.asname or a.name] = (base, a.name)
            elif isinstance(node, ast.Import):
                for a in node.names:
                    if a.asname:
                        info.imports[a.asname] = (a.name, None)
                    else:
                        top = a.name.split(".", 1)[0]
                        info.imports[top] = (top, None)
        self._collect_defs(info, module.tree.body, "", None)
        for stmt in module.tree.body:
            if (
                isinstance(stmt, ast.Assign)
                and len(stmt.targets) == 1
                and isinstance(stmt.targets[0], ast.Name)
                and isinstance(stmt.value, ast.Call)
                and isinstance(stmt.value.func, ast.Name)
            ):
                info.instances[stmt.targets[0].id] = stmt.value.func.id
        self._mods.append(info)
        return ()

    def _collect_defs(self, info, body, prefix, cls) -> None:
        for node in body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                fn = _Fn(info.module, node, prefix + node.name, cls)
                info.by_name.setdefault(node.name, []).append(fn)
                info.by_qual[fn.qualname] = fn
                # nested defs: discovered through their enclosing function
                self._collect_defs(
                    info, node.body, f"{fn.qualname}.", None
                )
            elif isinstance(node, ast.ClassDef):
                self._collect_defs(
                    info, node.body, f"{prefix}{node.name}.", node.name
                )
            elif isinstance(node, (ast.If, ast.Try, ast.With)):
                for sub in ("body", "orelse", "finalbody"):
                    self._collect_defs(
                        info, getattr(node, sub, []) or [], prefix, cls
                    )

    # -- scope -------------------------------------------------------------
    def _mod(self, name: str) -> _ModInfo | None:
        for m in self._mods:
            if m.name == name or m.name.endswith("." + name):
                return m
        return None

    def _resolve(self, info: _ModInfo, fn: _Fn, ref: ast.AST) -> list[_Fn]:
        """The functions of the run a reference names."""
        if isinstance(ref, ast.Name) and isinstance(ref.ctx, ast.Load):
            if ref.id in info.by_name:
                return [f for f in info.by_name[ref.id] if f is not fn]
            if ref.id in info.instances:
                return self._methods(info, info.instances[ref.id], "__call__")
            imp = info.imports.get(ref.id)
            if imp is not None and imp[1] is not None:
                other = self._mod(imp[0])
                if other is not None:
                    if imp[1] in other.instances:
                        return self._methods(
                            other, other.instances[imp[1]], "__call__"
                        )
                    return [
                        f for f in other.by_name.get(imp[1], [])
                        if f.cls is None
                    ]
            return []
        if isinstance(ref, ast.Attribute) and isinstance(ref.value, ast.Name):
            base = ref.value.id
            if base in ("self", "cls") and fn.cls is not None:
                return self._methods(info, fn.cls, ref.attr)
            if base in info.instances:
                return self._methods(info, info.instances[base], ref.attr)
            imp = info.imports.get(base)
            if imp is not None:
                modname = imp[0] if imp[1] is None else f"{imp[0]}.{imp[1]}"
                other = self._mod(modname)
                if other is not None:
                    return [
                        f for f in other.by_name.get(ref.attr, [])
                        if f.cls is None
                    ]
                other = self._mod(imp[0]) if imp[1] is not None else None
                if other is not None and imp[1] in other.instances:
                    return self._methods(
                        other, other.instances[imp[1]], ref.attr
                    )
        return []

    @staticmethod
    def _methods(info: _ModInfo, cls: str, name: str) -> list[_Fn]:
        f = info.by_qual.get(f"{cls}.{name}")
        return [f] if f is not None else []

    def _roots(self) -> list[_Fn]:
        out = []
        for suffix, qual in ROOTS:
            for info in self._mods:
                rel = info.module.relpath
                if not (rel == suffix or rel.endswith("/" + suffix)):
                    continue
                if qual.endswith("*"):
                    hits = [
                        f for q, f in info.by_qual.items()
                        if "." not in q and q.startswith(qual[:-1])
                    ]
                else:
                    hits = [info.by_qual[qual]] if qual in info.by_qual else []
                if hits:
                    self.found_roots.add((suffix, qual))
                out.extend(hits)
        return out

    # -- judgement ---------------------------------------------------------
    def finalize(self) -> Iterable[Finding]:
        self._by_module = {id(m.module): m for m in self._mods}
        todo = self._roots()
        for f in todo:
            f.traced = True
        while todo:
            fn = todo.pop()
            info = self._by_module[id(fn.module)]
            for ref in ast.walk(fn.node):
                for g in self._resolve(info, fn, ref):
                    if not g.traced:
                        g.traced = True
                        todo.append(g)
        self.tensor_classes = self._tensor_classes()
        self.fields = {f for names in self.tensor_classes.values() for f in names}
        traced = [
            fn for info in self._mods for fns in info.by_name.values()
            for fn in fns if fn.traced
        ]
        self._infer(traced)
        for fn in sorted(traced, key=lambda f: (f.module.relpath,
                                                f.node.lineno)):
            info = self._by_module[id(fn.module)]
            self.traced.add(f"{info.name}:{fn.qualname}")
            yield from self._scans[id(fn)].run()

    def callees(self, fn: _Fn, call: ast.Call) -> list[_Fn]:
        """The traced functions a call may run."""
        info = self._by_module[id(fn.module)]
        return [g for g in self._resolve(info, fn, call.func) if g.traced]

    def _infer(self, traced: list[_Fn]) -> None:
        """Which names are tensors, in every traced function at once: a
        parameter is a tensor when its annotation says so, when a traced
        call site passes it one, or when the enclosing function's name is
        one (a closure); a call is a tensor when its callee returns one."""
        self.seeds: dict[int, set[str]] = {id(f): set() for f in traced}
        self.rets: dict[int, list[bool] | bool] = {}
        self._scans: dict[int, _FnScan] = {}
        nested: dict[int, list[_Fn]] = {}
        for f in traced:
            for g in traced:
                if g.module is f.module and g.qualname.startswith(
                    f.qualname + "."
                ) and "." not in g.qualname[len(f.qualname) + 1:]:
                    nested.setdefault(id(f), []).append(g)
        for _ in range(8):
            before = (
                {k: set(v) for k, v in self.seeds.items()}, dict(self.rets)
            )
            for f in traced:
                scan = _FnScan(self, f)
                self._scans[id(f)] = scan
                self.rets[id(f)] = scan.returns()
                for call in scan.calls():
                    for g in self.callees(f, call):
                        self.seeds[id(g)] |= scan.bound_params(g, call)
                for g in nested.get(id(f), []):
                    self.seeds[id(g)] |= scan.tensors - _params(g.node)
            if (self.seeds, self.rets) == before:
                break
        for f in traced:
            self._scans[id(f)] = _FnScan(self, f)

    def _tensor_classes(self) -> dict[str, set[str]]:
        """Classes of the run whose annotated fields include tensors (the
        tick outputs, the resident state): name -> the tensor fields."""
        out: dict[str, set[str]] = {}
        for info in self._mods:
            for node in ast.walk(info.module.tree):
                if not isinstance(node, ast.ClassDef):
                    continue
                names = {
                    s.target.id
                    for s in node.body
                    if isinstance(s, ast.AnnAssign)
                    and isinstance(s.target, ast.Name)
                    and "Tensor" in _annotation_text(s.annotation)
                }
                if names:
                    out[node.name] = names
        return out


def _params(node: ast.FunctionDef | ast.AsyncFunctionDef) -> set[str]:
    a = node.args
    out = {p.arg for p in (*a.posonlyargs, *a.args, *a.kwonlyargs)}
    for p in (a.vararg, a.kwarg):
        if p is not None:
            out.add(p.arg)
    return out


def _positional(fn: _Fn) -> list[str]:
    a = fn.node.args
    names = [p.arg for p in (*a.posonlyargs, *a.args)]
    if fn.cls is not None and names and names[0] in ("self", "cls"):
        names = names[1:]
    return names


class _FnScan:
    """One traced function: its tensor names, then its hazards."""

    def __init__(self, checker: TraceSafetyChecker, fn: _Fn) -> None:
        self.checker = checker
        self.module = fn.module
        self.fn = fn
        self.where = f"in {fn.qualname!r} (on the card's path)"
        self.tensors: set[str] = set()
        self.tensors = self._taint()

    # -- tensor inference --------------------------------------------------
    def _seeds(self) -> set[str]:
        a = self.fn.node.args
        out = set(self.checker.seeds.get(id(self.fn), ()))
        classes = self.checker.tensor_classes
        for p in (*a.posonlyargs, *a.args, *a.kwonlyargs):
            text = _annotation_text(p.annotation)
            if "Tensor" in text or any(c in text for c in classes):
                out.add(p.arg)
        return out

    def _taint(self) -> set[str]:
        tainted = self._seeds()
        self.tensors = tainted
        for _ in range(10):
            grew = False
            for node in self._own_nodes():
                if isinstance(node, (ast.Assign, ast.AnnAssign)):
                    value = node.value
                    targets = (
                        node.targets
                        if isinstance(node, ast.Assign)
                        else [node.target]
                    )
                elif isinstance(node, (ast.For, ast.comprehension)):
                    value, targets = node.iter, [node.target]
                elif isinstance(node, ast.AugAssign):
                    value, targets = node.value, [node.target]
                else:
                    continue
                if value is None:
                    continue
                for t in targets:
                    for name in self._tensor_targets(t, value):
                        if name not in tainted:
                            tainted.add(name)
                            grew = True
            if not grew:
                break
        return tainted

    def _tensor_targets(self, t: ast.AST, value: ast.AST) -> list[str]:
        """The names of ``t = value`` that receive a tensor: element by
        element where both sides are tuples of one length."""
        if isinstance(t, (ast.Tuple, ast.List)):
            kinds = self.kinds(value)
            if isinstance(kinds, list) and len(kinds) == len(t.elts):
                return [
                    n for e, k in zip(t.elts, kinds) if k
                    for n in self._names(e)
                ]
        return self._names(t) if self.is_tensor(value) else []

    @staticmethod
    def _names(t: ast.AST) -> list[str]:
        if isinstance(t, (ast.Tuple, ast.List)):
            return [n for e in t.elts for n in _FnScan._names(e)]
        if isinstance(t, ast.Starred):
            return _FnScan._names(t.value)
        d = dotted_name(t)
        return [d] if d is not None else []

    def kinds(self, node: ast.AST) -> list[bool] | bool:
        """Per element for a tuple-valued expression, else one verdict."""
        if isinstance(node, ast.Tuple):
            return [self.is_tensor(e) for e in node.elts]
        if isinstance(node, ast.Call):
            rets = [
                self.checker.rets.get(id(g))
                for g in self.checker.callees(self.fn, node)
            ]
            lists = [r for r in rets if isinstance(r, list)]
            if lists and all(len(x) == len(lists[0]) for x in lists):
                return [any(col) for col in zip(*lists)]
        return self.is_tensor(node)

    def returns(self) -> list[bool] | bool:
        """What the function returns: per element when every return is a
        tuple of one length."""
        values = [
            n.value for n in self._own_nodes()
            if isinstance(n, ast.Return) and n.value is not None
        ]
        text = _annotation_text(self.fn.node.returns)
        if not values:
            return False
        kinds = [self.kinds(v) for v in values]
        lists = [k for k in kinds if isinstance(k, list)]
        if len(lists) == len(kinds) and all(
            len(k) == len(lists[0]) for k in lists
        ):
            return [any(col) for col in zip(*lists)]
        return "Tensor" in text or any(
            k if isinstance(k, bool) else any(k) for k in kinds
        )

    def calls(self) -> list[ast.Call]:
        return [n for n in self._own_nodes() if isinstance(n, ast.Call)]

    def bound_params(self, g: _Fn, call: ast.Call) -> set[str]:
        """``g``'s parameters this call passes a tensor."""
        names = _positional(g)
        out = set()
        for i, arg in enumerate(call.args):
            if isinstance(arg, ast.Starred):
                break
            if i < len(names) and self.is_tensor(arg):
                out.add(names[i])
        params = _params(g.node)
        for kw in call.keywords:
            if kw.arg in params and self.is_tensor(kw.value):
                out.add(kw.arg)
        return out

    def is_tensor(self, node: ast.AST) -> bool:
        """Whether ``node`` may evaluate to a tensor (or a container of
        tensors)."""
        if isinstance(node, (ast.Name, ast.Attribute)):
            d = dotted_name(node)
            if d is not None and d in self.tensors:
                return True
            if isinstance(node, ast.Attribute):
                if node.attr in _SHAPE_ATTRS:
                    return False
                # a field of a tensor class, or an attribute of a tensor
                return (node.attr in self.checker.fields
                        or self.is_tensor(node.value))
            return False
        if isinstance(node, ast.Call):
            d = dotted_name(node.func)
            if d is not None:
                if d in _HOST_RESULT or d in _STATIC_PROBES:
                    return False
                root = d.split(".", 1)[0]
                if root == "torch" and "." in d:
                    if d.startswith("torch.cuda.") or _last(d) in _TORCH_HOST:
                        return False
                    return True
                if root in ("np", "numpy", "math", "ctypes"):
                    return False
            callees = self.checker.callees(self.fn, node)
            if callees:
                return any(
                    (r if isinstance(r, bool) else any(r))
                    for r in (self.checker.rets.get(id(g), False)
                              for g in callees)
                ) or any(
                    "Tensor" in _annotation_text(g.node.returns)
                    for g in callees
                )
            if isinstance(node.func, ast.Attribute):
                meth = node.func.attr
                if meth in _SHAPE_METHODS or meth in _HOST_RESULT_METHODS:
                    return False
                return self.is_tensor(node.func.value)
            return False
        if isinstance(node, ast.Subscript):
            return self.is_tensor(node.value)
        if isinstance(node, ast.BinOp):
            return self.is_tensor(node.left) or self.is_tensor(node.right)
        if isinstance(node, ast.UnaryOp):
            return self.is_tensor(node.operand)
        if isinstance(node, ast.Compare):
            if all(isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops):
                return False
            return any(
                self.is_tensor(x) for x in (node.left, *node.comparators)
            )
        if isinstance(node, ast.BoolOp):
            return any(self.is_tensor(v) for v in node.values)
        if isinstance(node, ast.IfExp):
            return self.is_tensor(node.body) or self.is_tensor(node.orelse)
        if isinstance(node, (ast.Tuple, ast.List)):
            return any(self.is_tensor(e) for e in node.elts)
        if isinstance(node, ast.Starred):
            return self.is_tensor(node.value)
        return False

    # -- walking -----------------------------------------------------------
    def _own_nodes(self) -> Iterator[ast.AST]:
        """The function's nodes, not descending into nested defs (each is
        its own traced function) or classes."""
        stack = list(self.fn.node.body)
        while stack:
            node = stack.pop()
            if isinstance(
                node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
            ):
                continue
            yield node
            stack.extend(ast.iter_child_nodes(node))

    def run(self) -> Iterator[Finding]:
        nodes = sorted(
            self._own_nodes(),
            key=lambda n: (getattr(n, "lineno", 0), getattr(n, "col_offset", 0)),
        )
        for node in nodes:
            if isinstance(node, ast.Call):
                yield from self._call(node)
            elif isinstance(node, (ast.If, ast.While, ast.IfExp)):
                if self.is_tensor(node.test):
                    kind = {
                        ast.If: "if", ast.While: "while",
                        ast.IfExp: "conditional expression",
                    }[type(node)]
                    yield self._finding(
                        node, "data-dependent-branch", "error",
                        f"Python `{kind}` on a tensor {self.where}: "
                        f"bool(tensor) waits for the card; keep the "
                        f"choice on the device (torch.where) or read the "
                        f"value back once, on purpose",
                    )

    def _finding(self, node, rule, severity, message) -> Finding:
        return self.checker.finding(self.module, node, rule, severity, message)

    def _call(self, call: ast.Call) -> Iterator[Finding]:
        d = dotted_name(call.func)
        func = call.func
        if d == "print":
            yield self._finding(
                call, "print", "warning",
                f"print() {self.where}: the card's path writes no output",
            )
            return
        if d is not None and _last(d) == "to_host" and not isinstance(
            func, ast.Attribute
        ) or d is not None and d.endswith("device.to_host"):
            yield self._sync(call, "to_host() reads a tensor back")
            return
        if d in ("torch.cuda.synchronize",) or (
            isinstance(func, ast.Attribute) and func.attr == "synchronize"
        ):
            yield self._sync(call, f"{d or '.synchronize'}() blocks the host")
            return
        if d in ("torch.tensor", "torch.as_tensor") and any(
            kw.arg == "device"
            and not (
                isinstance(kw.value, ast.Constant) and kw.value.value == "cpu"
            )
            for kw in call.keywords
        ):
            yield self._sync(
                call,
                f"{d}(..., device=...) copies a host value synchronously "
                f"(build device scalars on the device, e.g. clamp_min)",
            )
            return
        if d is not None and d.startswith("torch.") and _last(d) in (
            _DATA_SIZED
        ) or (d == "torch.where" and len(call.args) == 1 and not call.keywords):
            yield self._sync(
                call, f"{d}() sizes its output by the data"
            )
            return
        if isinstance(func, ast.Attribute) and self.is_tensor(func.value):
            attr = func.attr
            if attr in ("item", "tolist", "cpu"):
                yield self._sync(call, f".{attr}() reads a tensor back")
                return
            if attr == "numpy" and not (
                isinstance(func.value, ast.Call)
                and isinstance(func.value.func, ast.Attribute)
                and func.value.func.attr == "cpu"
            ):
                yield self._sync(call, ".numpy() reads a tensor back")
                return
            if attr in _DATA_SIZED:
                yield self._sync(call, f".{attr}() sizes its output by the data")
                return
        if (
            isinstance(func, ast.Name)
            and func.id in ("float", "int", "bool")
            and len(call.args) == 1
            and self.is_tensor(call.args[0])
        ):
            yield self._sync(
                call, f"{func.id}() of a tensor reads it back"
            )

    def _sync(self, call: ast.Call, what: str) -> Finding:
        return self._finding(
            call, "host-sync", "error",
            f"{what} {self.where}: the host waits for the card to drain "
            f"the stream (a sanctioned readback is suppressed at its site "
            f"with its reason)",
        )
