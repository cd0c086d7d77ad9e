"""Lock-discipline checker: no blocking while holding, one global order.

Two rules:

- ``blocking-call-under-lock`` (error): a call that can block — sleeps, zmq
  socket send/recv/poll, raw socket ops, subprocess spawns, thread joins and
  the TaskStore round-trip surface — made inside a ``with <lock>:`` body.
  Under a lock every such call turns one slow peer into a fleet-wide stall:
  the reference's safety story is single-threaded loops, and the places this
  framework DID add locks (store client, memory store, race monitor) stay
  safe only while their critical sections are pure CPU. A site that is
  deliberately serialized I/O (the RESP client's connection lock exists
  precisely to serialize socket use) carries a justifying
  ``# faas: allow(locks.blocking-call-under-lock)``.
- ``lock-order-inconsistent`` (error, cross-module): lock B acquired inside
  lock A somewhere, and lock A inside lock B somewhere else — the classic
  ABBA deadlock, invisible to any single run that doesn't interleave the
  two paths. Locks are identified by their source spelling (``self._lock``,
  ``_SHARED_LOCK``), which conflates same-named locks of different classes —
  an over-approximation that errs toward reporting.

Nested ``def``/``lambda`` bodies under a ``with`` are skipped: defining a
function under a lock doesn't run it there.
"""

from __future__ import annotations

import ast
from typing import Iterable, Iterator

from tpu_faas_torch.analysis.core import Checker, Finding, Module, dotted_name

#: Final attribute names that block regardless of receiver: zmq + socket
#: send/recv surface, liveness waits, pub/sub drains, and the RESP client's
#: own wire ops.
_BLOCKING_ATTRS = frozenset(
    {
        "sleep",
        "recv", "recv_multipart", "recv_json", "recv_string", "recv_pyobj",
        "send", "send_multipart", "send_json", "send_string", "send_pyobj",
        "sendall", "poll", "accept", "listen",
        "wait", "join", "get_message",
        "command", "send_many", "recv_reply",
    }
)
#: TaskStore surface: every one of these is (on production backends) a
#: network round trip.
_STORE_ATTRS = frozenset(
    {
        # NOT "keys": it is also a ubiquitous dict method, and flagging
        # every `d.keys()` under a lock would bury the real findings
        "hget", "hset", "hgetall", "hmget", "hdel", "hexists",
        "hget_many", "hset_many", "setnx_field", "setnx_fields",
        "delete", "delete_many", "publish", "subscribe",
        "create_task", "create_task_if_absent", "create_tasks",
        "get_status", "set_status", "finish_task", "cancel_task",
        "get_result", "get_payloads", "request_kill", "ping", "save",
    }
)
#: Fully-dotted blocking calls.
_BLOCKING_DOTTED = frozenset(
    {
        "time.sleep",
        "select.select",
        "subprocess.run", "subprocess.call", "subprocess.check_call",
        "subprocess.check_output", "subprocess.Popen",
        "socket.create_connection",
        "requests.get", "requests.post", "requests.put", "requests.request",
        "urllib.request.urlopen",
    }
)


def _lock_id(expr: ast.AST) -> str | None:
    """The lock's source spelling when ``expr`` looks like a lock, else
    None. Heuristic: final identifier contains "lock" or "mutex" (covers
    ``self._lock``, ``_SHARED_LOCK``, ``cv._rlock``...)."""
    d = dotted_name(expr)
    if d is None:
        return None
    final = d.rsplit(".", 1)[-1].lower()
    if "lock" in final or "mutex" in final:
        return d
    return None


class LockDisciplineChecker(Checker):
    name = "locks"

    def __init__(self) -> None:
        #: (outer, inner) -> first site observed, for the global order graph
        self._order: dict[tuple[str, str], tuple[str, int]] = {}

    def check(self, module: Module) -> Iterable[Finding]:
        for node in module.tree.body:
            yield from self._visit(module, node, [])

    def _visit(
        self, module: Module, node: ast.AST, held: list[tuple[str, int]]
    ) -> Iterator[Finding]:
        """Single-visit recursive walk carrying the held-lock stack."""
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            # a def under a lock runs later, without it — reset the stack
            for child in ast.iter_child_nodes(node):
                yield from self._visit(module, child, [])
            return
        if isinstance(node, (ast.With, ast.AsyncWith)):
            acquired: list[tuple[str, int]] = []
            for item in node.items:
                lock = _lock_id(item.context_expr)
                if lock is not None:
                    for outer, _ in held + acquired:
                        if outer != lock:
                            self._order.setdefault(
                                (outer, lock), (module.relpath, node.lineno)
                            )
                    acquired.append((lock, node.lineno))
                else:
                    # a non-lock context manager's ENTER expression still
                    # evaluates while outer locks are held
                    yield from self._visit(module, item.context_expr, held)
            inner = held + acquired
            for stmt in node.body:
                yield from self._visit(module, stmt, inner)
            return
        if isinstance(node, ast.Call) and held:
            label = self._blocking_label(node)
            if label is not None:
                # no line numbers in the message: it is part of the baseline
                # identity, which deliberately survives line drift
                lock = held[-1][0]
                yield self.finding(
                    module, node, "blocking-call-under-lock", "error",
                    f"{label} while holding {lock!r}: a blocked holder "
                    f"stalls every other acquirer of this lock",
                )
        for child in ast.iter_child_nodes(node):
            yield from self._visit(module, child, held)

    def _blocking_label(self, call: ast.Call) -> str | None:
        d = dotted_name(call.func)
        if d is not None and d in _BLOCKING_DOTTED:
            return f"{d}()"
        if isinstance(call.func, ast.Attribute):
            attr = call.func.attr
            if attr == "join" and isinstance(call.func.value, ast.Constant):
                return None  # ", ".join(...) is str.join, not Thread.join
            if attr in _BLOCKING_ATTRS:
                return f".{attr}()"
            if attr in _STORE_ATTRS:
                return f"store round trip .{attr}()"
        return None

    def finalize(self) -> Iterable[Finding]:
        for (a, b), (path, line) in sorted(self._order.items()):
            if (b, a) in self._order and a < b:
                other_path, other_line = self._order[(b, a)]
                sites = (
                    (path, line, a, b, other_path),
                    (other_path, other_line, b, a, path),
                )
                # opposite-site line numbers stay OUT of the message: it is
                # part of the baseline identity, which must survive drift
                for p, ln, first, second, op in sites:
                    yield Finding(
                        path=p,
                        line=ln,
                        rule="locks.lock-order-inconsistent",
                        severity="error",
                        message=(
                            f"{second!r} acquired while holding {first!r} "
                            f"here, but the opposite order exists in "
                            f"{op}: ABBA deadlock risk"
                        ),
                    )
