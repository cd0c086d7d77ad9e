"""Event-loop discipline checker: no blocking work reachable from
``async def`` bodies.

The gateway, the Python store server, and the replication link all live on
asyncio event loops. One blocking call in a coroutine — a synchronous store
round trip, ``time.sleep``, file I/O, a ``threading.Lock`` acquire, an
O(n²) scan over a request body — stalls EVERY connection sharing that
loop: the /result long-poller parks every other client, the store server
stops answering health probes, the replication link misses its ack window.
The sanctioned escapes are structural and therefore statically visible:
``run_in_executor`` / ``asyncio.to_thread`` take the callable UNCALLED, so
a blocking function passed as a value never trips this pass — only a call
executed on the loop does.

Rules (all error severity):

- ``blocking-store-call`` — a synchronous :class:`TaskStore` method called
  on a store-named receiver (``ctx.store``, ``self._store``, ``store``)
  in async-reachable code. The store surface is a network round trip on
  production backends; the gateway routes every handler-side store op
  through ``GatewayContext.store_call`` (executor + circuit breaker) for
  exactly this reason.
- ``blocking-sleep`` — ``time.sleep`` on the loop (``asyncio.sleep`` is
  the coroutine form).
- ``blocking-file-io`` — ``open()``, ``Path.read_text/write_text/
  read_bytes/write_bytes``, or the snapshot codec's ``save_file`` /
  ``load_file`` on the loop. The store server's startup snapshot load
  runs via ``run_in_executor`` for this reason (a multi-GB load would
  starve the just-bound health listener into a liveness-kill crash loop).
- ``blocking-lock`` — a ``threading``-style lock acquired on the loop:
  ``<lock>.acquire()`` or a synchronous ``with <lock>:`` (lock spelling
  per the locks checker: final identifier contains lock/mutex). A
  contended acquire freezes the whole loop, not one coroutine; use
  ``asyncio.Lock`` (``async with``) or move the locked section off-loop.
- ``quadratic-scan`` — a membership test (``x in acc``) against a
  sequence appended to inside the same loop: the O(refs²)
  ``validate_graph`` class (found live in PR 9 — a dependency-dedup list
  scan inside the gateway event loop, pre-admission, on bodies up to the
  256 MB cap). Use a set alongside the ordered list.
- ``hot-loop-dict-churn`` (warning) — a task-shaped dict display (one
  carrying a literal ``"task_id"`` key) built per iteration of a
  ``for``/``while`` loop in a Dispatcher method, or built by a
  ``task_message_kwargs`` materializer. The dispatcher's serve loop is
  the host wall the columnar plane (core/columns.py) attacks: at tens of
  thousands of tasks per second, one Python dict per task is allocator +
  per-key hashing churn at task rate, and profile-visible. Read from the
  arena columns instead; the ONE legitimate site is the legacy-worker
  wire boundary, where the dict IS the message contract — suppress there
  with a justification. Logging ``extra=`` dicts are exempt (the log
  call they ride dwarfs the dict; the rule targets the data plane, not
  diagnostics). Unlike the rules above, this one needs no async roots —
  the push dispatcher's serve loop is a plain sync loop.

Reachability is lexical plus a same-module call closure: an ``async def``
body is scanned directly (nested ``def``s are skipped — they are values,
usually executor thunks), and direct calls to same-module functions and
same-class methods are followed transitively, so a sync helper that does
the blocking on the coroutine's behalf (``StoreServer._save_if_configured``)
is still caught. Cross-module sync calls are out of static scope by the
same tradeoff the trace checker makes.
"""

from __future__ import annotations

import ast
from typing import Iterable, Iterator

from tpu_faas_torch.analysis.core import Checker, Finding, Module, dotted_name
from tpu_faas_torch.analysis.locks import _lock_id
from tpu_faas_torch.store.base import TaskStore

#: The synchronous store surface: every public TaskStore method, DERIVED
#: from the class (grow the protocol and this pass follows), minus the
#: handful that never leave the process.
_LOCAL_ONLY = frozenset({"decode_payloads"})
STORE_METHODS: frozenset[str] = frozenset(
    name
    for name in dir(TaskStore)
    if not name.startswith("_")
    and callable(getattr(TaskStore, name, None))
) - _LOCAL_ONLY

#: Dotted / final-attribute spellings of blocking file I/O. The snapshot
#: codec's file entry points are named here because they are this tree's
#: canonical "big synchronous disk write".
_FILE_IO_ATTRS = frozenset(
    {"read_text", "write_text", "read_bytes", "write_bytes",
     "save_file", "load_file"}
)


def _receiver_is_store(node: ast.AST) -> bool:
    """True when a call receiver is store-shaped: the final identifier of
    its dotted spelling contains "store" (``ctx.store``, ``self._store``,
    bare ``store``). Wrapper internals (``self.inner``) are deliberately
    not matched — the wrapper itself is the audited surface."""
    d = dotted_name(node)
    if d is None:
        return False
    return "store" in d.rsplit(".", 1)[-1].lower()


class _Scope:
    """One module's function topology: defs by name, methods by class,
    and every async def (the roots of the reachability walk)."""

    def __init__(self, tree: ast.Module) -> None:
        self.module_defs: dict[str, ast.FunctionDef] = {}
        self.methods: dict[tuple[str, str], ast.FunctionDef] = {}
        #: (async def node, enclosing class name or None)
        self.roots: list[tuple[ast.AsyncFunctionDef, str | None]] = []
        self._index(tree, cls=None, top=True)

    def _index(self, node: ast.AST, cls: str | None, top: bool) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                self._index(child, cls=child.name, top=False)
            elif isinstance(child, ast.AsyncFunctionDef):
                self.roots.append((child, cls))
                self._index(child, cls=cls, top=False)
            elif isinstance(child, ast.FunctionDef):
                if cls is not None:
                    self.methods.setdefault((cls, child.name), child)
                if top:
                    self.module_defs.setdefault(child.name, child)
                self._index(child, cls=cls, top=False)
            else:
                self._index(child, cls=cls, top=top)


def _lexical_statements(fn: ast.AST) -> Iterator[ast.AST]:
    """Every node lexically inside ``fn`` excluding nested function /
    lambda bodies: a nested def is a value (usually an executor thunk),
    not code running on the loop — unless it is CALLED directly, which
    the caller follows separately."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        yield node
        if isinstance(
            node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
        ):
            continue
        stack.extend(ast.iter_child_nodes(node))


def _nested_defs(fn: ast.AST) -> dict[str, ast.FunctionDef]:
    """Sync defs nested DIRECTLY inside ``fn``'s lexical body (candidates
    for direct-call following)."""
    out: dict[str, ast.FunctionDef] = {}
    for node in _lexical_statements(fn):
        if isinstance(node, ast.FunctionDef):
            out.setdefault(node.name, node)
    return out


class EventLoopChecker(Checker):
    name = "eventloop"

    def check(self, module: Module) -> Iterable[Finding]:
        yield from self._check_dict_churn(module)
        scope = _Scope(module.tree)
        if not scope.roots:
            return
        reported: set[tuple[int, str]] = set()
        for root, cls in scope.roots:
            yield from self._scan_root(module, scope, root, cls, reported)

    # -- per-task dict churn on the dispatch serve loop ---------------------
    @staticmethod
    def _task_shaped_dicts(fn: ast.AST) -> Iterator[ast.Dict]:
        """Dict displays carrying a literal ``"task_id"`` key — the
        per-task message shape — lexically inside ``fn`` (nested defs
        excluded, same value-not-code reasoning as the loop rules), minus
        logging ``extra=`` keyword dicts."""
        extras: set[ast.AST] = set()
        for node in _lexical_statements(fn):
            if isinstance(node, ast.Call):
                for kw in node.keywords:
                    if kw.arg == "extra":
                        extras.add(kw.value)
        for node in _lexical_statements(fn):
            if isinstance(node, ast.Dict) and node not in extras:
                for key in node.keys:
                    if (
                        isinstance(key, ast.Constant)
                        and key.value == "task_id"
                    ):
                        yield node
                        break

    def _check_dict_churn(self, module: Module) -> Iterator[Finding]:
        """Task-shaped dicts at task rate: inside the per-dispatch
        ``task_message_kwargs`` materializer, or per iteration of a loop in
        a Dispatcher method. The anchors scope the rule by themselves — no
        module path gating — so a new dispatcher backend inherits the
        discipline the moment its class name says what it is."""
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.ClassDef):
                continue
            for meth in node.body:
                if not isinstance(meth, ast.FunctionDef):
                    continue
                if meth.name == "task_message_kwargs":
                    for d in self._task_shaped_dicts(meth):
                        yield self.finding(
                            module, d, "hot-loop-dict-churn", "warning",
                            f"per-task dict materialized by "
                            f"{node.name}.task_message_kwargs(): on the "
                            f"dispatch serve loop this runs at task rate — "
                            f"legitimate ONLY at the legacy-worker wire "
                            f"boundary where the dict is the message "
                            f"contract (suppress there with the reason); "
                            f"everywhere else, read the arena columns",
                        )
                    continue
                if not node.name.endswith("Dispatcher"):
                    continue
                seen: set[ast.AST] = set()  # nested loops see the same dict
                for sub in _lexical_statements(meth):
                    if not isinstance(sub, (ast.For, ast.While)):
                        continue
                    for d in self._task_shaped_dicts(sub):
                        if d in seen:
                            continue
                        seen.add(d)
                        yield self.finding(
                            module, d, "hot-loop-dict-churn", "warning",
                            f"task-shaped dict built per iteration of a "
                            f"loop in {node.name}.{meth.name}(): per-task "
                            f"dict construction is allocator + hashing "
                            f"churn at task rate on the serve loop — read "
                            f"from the arena columns (core/columns.py) or "
                            f"justify a suppression at a wire boundary",
                        )

    # -- reachability walk -------------------------------------------------
    def _scan_root(
        self,
        module: Module,
        scope: _Scope,
        root: ast.AsyncFunctionDef,
        cls: str | None,
        reported: set[tuple[int, str]],
    ) -> Iterator[Finding]:
        visited: set[ast.AST] = {root}
        queue: list[tuple[ast.AST, str | None]] = [(root, cls)]
        while queue:
            fn, fn_cls = queue.pop()
            nested = _nested_defs(fn)
            via = "" if fn is root else (
                f" (in {getattr(fn, 'name', '?')}(), reachable from "
                f"async def {root.name})"
            )
            for node in _lexical_statements(fn):
                yield from self._check_node(module, node, via, reported)
                for callee, callee_cls in self._callees(
                    node, fn_cls, nested, scope
                ):
                    if callee not in visited:
                        visited.add(callee)
                        queue.append((callee, callee_cls))

    def _callees(
        self,
        node: ast.AST,
        cls: str | None,
        nested: dict[str, ast.FunctionDef],
        scope: _Scope,
    ) -> Iterator[tuple[ast.FunctionDef, str | None]]:
        """Direct same-module sync calls made by ``node``: a bare name
        resolving to a nested or module-level def, or ``self.x()`` /
        ``cls.x()`` resolving to a method of the enclosing class."""
        if not isinstance(node, ast.Call):
            return
        fn = node.func
        if isinstance(fn, ast.Name):
            target = nested.get(fn.id) or scope.module_defs.get(fn.id)
            if target is not None:
                yield target, cls
        elif (
            isinstance(fn, ast.Attribute)
            and isinstance(fn.value, ast.Name)
            and fn.value.id in ("self", "cls")
            and cls is not None
        ):
            target = scope.methods.get((cls, fn.attr))
            if target is not None:
                yield target, cls

    # -- blocking detection ------------------------------------------------
    def _emit(
        self,
        module: Module,
        node: ast.AST,
        rule: str,
        message: str,
        reported: set[tuple[int, str]],
    ) -> Iterator[Finding]:
        key = (getattr(node, "lineno", 1), rule)
        if key in reported:  # one finding per site, however many roots reach it
            return
        reported.add(key)
        yield self.finding(module, node, rule, "error", message)

    def _check_node(
        self,
        module: Module,
        node: ast.AST,
        via: str,
        reported: set[tuple[int, str]],
    ) -> Iterator[Finding]:
        if isinstance(node, ast.With):
            for item in node.items:
                lock = _lock_id(item.context_expr)
                if lock is not None:
                    yield from self._emit(
                        module, node, "blocking-lock",
                        f"synchronous 'with {lock}:' on the event loop"
                        f"{via}: a contended acquire freezes every "
                        f"coroutine on this loop — use asyncio.Lock "
                        f"(async with) or move the section off-loop",
                        reported,
                    )
            return
        if isinstance(node, (ast.For, ast.While)):
            yield from self._check_quadratic(module, node, via, reported)
            return
        if not isinstance(node, ast.Call):
            return
        d = dotted_name(node.func)
        if d == "time.sleep":
            yield from self._emit(
                module, node, "blocking-sleep",
                f"time.sleep() on the event loop{via}: every connection "
                f"on this loop stalls for the whole interval — await "
                f"asyncio.sleep() instead",
                reported,
            )
            return
        if d == "open" or (
            d is not None and d.rsplit(".", 1)[-1] in _FILE_IO_ATTRS
        ):
            target = d if d == "open" else d.rsplit(".", 1)[-1]
            yield from self._emit(
                module, node, "blocking-file-io",
                f"blocking file I/O ({target}) on the event loop{via}: "
                f"disk latency is unbounded under load — run it via "
                f"run_in_executor / asyncio.to_thread",
                reported,
            )
            return
        if isinstance(node.func, ast.Attribute):
            attr = node.func.attr
            if attr == "acquire" and _lock_id(node.func.value) is not None:
                yield from self._emit(
                    module, node, "blocking-lock",
                    f"{dotted_name(node.func.value)}.acquire() on the "
                    f"event loop{via}: a threading lock blocks the whole "
                    f"loop, not one coroutine — use asyncio.Lock or move "
                    f"the section off-loop",
                    reported,
                )
                return
            if attr in STORE_METHODS and _receiver_is_store(node.func.value):
                yield from self._emit(
                    module, node, "blocking-store-call",
                    f"synchronous store round trip .{attr}() on the event "
                    f"loop{via}: one slow store RTT parks every connection "
                    f"on this loop — route it through an executor "
                    f"(gateway: ctx.store_call)",
                    reported,
                )

    def _check_quadratic(
        self,
        module: Module,
        loop: ast.AST,
        via: str,
        reported: set[tuple[int, str]],
    ) -> Iterator[Finding]:
        """Membership test against a name appended to inside the same
        loop: each iteration rescans the accumulator — O(n²) on the loop
        for request-sized n. (Sets use .add, so list accumulation is
        what the .append probe identifies.)"""
        appended: set[str] = set()
        body = getattr(loop, "body", []) + getattr(loop, "orelse", [])
        nodes = []
        stack = list(body)
        while stack:
            n = stack.pop()
            nodes.append(n)
            if not isinstance(
                n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
            ):
                stack.extend(ast.iter_child_nodes(n))
        for n in nodes:
            if (
                isinstance(n, ast.Call)
                and isinstance(n.func, ast.Attribute)
                and n.func.attr == "append"
                and isinstance(n.func.value, ast.Name)
            ):
                appended.add(n.func.value.id)
        if not appended:
            return
        for n in nodes:
            if not isinstance(n, ast.Compare):
                continue
            for op, comp in zip(n.ops, n.comparators):
                if (
                    isinstance(op, (ast.In, ast.NotIn))
                    and isinstance(comp, ast.Name)
                    and comp.id in appended
                ):
                    yield from self._emit(
                        module, n, "quadratic-scan",
                        f"membership test against {comp.id!r}, which this "
                        f"loop also appends to{via}: O(n²) rescans on the "
                        f"event loop (the validate_graph class) — keep a "
                        f"set beside the ordered list",
                        reported,
                    )
