"""Protocol checker: every literal status write proven against racecheck.

The runtime :class:`~tpu_faas_torch.store.racecheck.RaceMonitor` models writers it
can observe; this pass closes the other half of the argument — that every
writer in the tree actually goes through an API the monitor models, and that
every literal status it writes is one the ``_LEGAL`` transition table can
reach through the API used:

- ``finish_task`` may only write a terminal status S with RUNNING -> S legal
  (``illegal-finish-status``) — a non-terminal "finish" would freeze the
  record without a result contract; ``finish_task_many`` item tuples with a
  literal status slot are held to the same rule;
- ``set_status`` may never write a terminal status
  (``terminal-set-status``) — terminal writes must flow through
  ``finish_task``/``finish_task_many``/``cancel_task``, which stamp
  FIELD_FINISHED_AT, drop the live-index entry and announce on
  RESULTS_CHANNEL; a bare terminal ``set_status`` leaks all three. The
  batched ``set_status_many`` carries ONE shared status as its first
  argument precisely so this rule stays statically provable for the
  dispatcher's coalesced RUNNING flush;
- a RUNNING ``set_status`` without ``extra_fields`` carries no ownership
  lease (``running-without-lease``, warning) — such a record is
  unadoptable-forever if worker and dispatcher die (see FIELD_LEASE_AT);
- ``set_status``/``set_status_many`` may never write WAITING outside the
  store package (``waiting-set-status``) — WAITING nodes are created with
  their dependency fields by ``create_task(s)(status=WAITING)`` and moved
  out only by the store's promotion plane (complete_dep_many /
  resolve_waiting); a bare WAITING write strands a task no dispatcher may
  ever send (WAITING -> RUNNING is illegal in ``racecheck._LEGAL``);
- any literal status outside the :class:`TaskStatus` enum is flagged
  wherever it appears (``unknown-status``);
- raw ``.hset()`` whose field-dict literal touches status/result, and raw
  ``.publish()`` to the tasks/results channels, are flagged outside
  ``tpu_faas_torch/store/`` (``raw-status-write`` / ``raw-task-publish``): those
  writes bypass the TaskStore conveniences, so the runtime monitor —
  which models exactly that API — provably would not cover them;
- raw ``.hset()``/``.setnx_field()``/``.delete()`` whose KEY statically
  names the ``blob:`` namespace, outside ``tpu_faas_torch/store/``
  (``raw-blob-write``): blobs are create-once content — writes must go
  through ``put_blob`` (setnx'd data field + TTL stamp), which the
  runtime monitor validates against the digest; deletes belong to the
  gateway sweeper's reference-checked GC, whose key lists are dynamic;
- a function on the quarantine drain path (any def whose name mentions
  ``quarantine``) may never call a terminal-status writer
  (``quarantine-drain-terminal``): quarantine is a ROUTING decision —
  the masked worker's in-flight tasks are still live and must complete
  or reclaim through the ordinary paths; a terminal write here turns a
  health policy into task loss. The banned-call set is derived from the
  live TaskStore API plus the dispatcher's named terminal wrappers.

The legal-status sets are DERIVED from ``racecheck._LEGAL`` and
``TaskStatus`` at import time, not copied: if the protocol grows a status or
a transition, this pass follows automatically.
"""

from __future__ import annotations

import ast
from pathlib import Path
from typing import Iterable, Iterator

from tpu_faas_torch.analysis.core import Checker, Finding, Module, dotted_name
from tpu_faas_torch.core.task import (
    FIELD_RESULT,
    FIELD_STATUS,
    TaskStatus,
)
from tpu_faas_torch.store.base import (
    BLOB_PREFIX,
    RESULTS_CHANNEL,
    TASKS_CHANNEL,
    TaskStore,
)
from tpu_faas_torch.store.racecheck import _LEGAL

#: All spellable statuses.
STATUS_NAMES: frozenset[str] = frozenset(s.value for s in TaskStatus)
#: Statuses with no legal way out (modulo the lawful-overwrite warnings the
#: monitor reports separately).
TERMINAL: frozenset[str] = frozenset(
    s.value for s in TaskStatus if s.is_terminal()
)
#: What finish_task may write: terminal statuses reachable from RUNNING.
LEGAL_FINISH: frozenset[str] = frozenset(
    to for frm, to in _LEGAL if frm == "RUNNING" and to in TERMINAL
)

#: Field-name spellings that mark a dict literal as a task-record write.
_STATUS_FIELD_NAMES = frozenset({"FIELD_STATUS", "FIELD_RESULT"})
_STATUS_FIELD_STRINGS = frozenset({FIELD_STATUS, FIELD_RESULT})
#: Channel spellings whose raw publish bypasses the store conveniences.
_TASK_CHANNEL_NAMES = frozenset({"TASKS_CHANNEL", "RESULTS_CHANNEL"})
_TASK_CHANNEL_STRINGS = frozenset({TASKS_CHANNEL, RESULTS_CHANNEL})

#: Store surfaces that can stamp a terminal status — DERIVED by probing the
#: candidate spellings against the live TaskStore API (a renamed or removed
#: surface drops out automatically, like the legal-status sets above).
_TERMINAL_WRITER_CANDIDATES = (
    "finish_task", "finish_task_many", "cancel_task", "expire_task",
)
TERMINAL_STORE_WRITERS: frozenset[str] = frozenset(
    n for n in _TERMINAL_WRITER_CANDIDATES if hasattr(TaskStore, n)
)
#: Dispatcher-side wrappers over those surfaces (dispatch/base.py fail_task
#: and the FAIL branch of reclaim_or_fail) — named here rather than probed
#: because importing the dispatch package would drag zmq into every
#: analysis run.
_DISPATCH_TERMINAL_WRAPPERS = frozenset({"fail_task", "reclaim_or_fail"})
#: The quarantine drain path may call none of these.
QUARANTINE_BANNED_CALLS: frozenset[str] = (
    TERMINAL_STORE_WRITERS | _DISPATCH_TERMINAL_WRAPPERS
)


def _status_literal(node: ast.AST) -> str | None:
    """The status string a call argument pins down, or None when dynamic.

    Understands the three spellings used across the tree: ``"RUNNING"``,
    ``TaskStatus.RUNNING``, and ``str(TaskStatus.RUNNING)``."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    dotted = dotted_name(node)
    if dotted is not None and dotted.startswith("TaskStatus."):
        return dotted.split(".", 1)[1]
    if (
        isinstance(node, ast.Call)
        and isinstance(node.func, ast.Name)
        and node.func.id == "str"
        and len(node.args) == 1
    ):
        return _status_literal(node.args[0])
    return None


def _in_store_package(module: Module) -> bool:
    """The store package implements the conveniences — its raw hash ops and
    announces ARE the API, not a bypass of it. Decided on the module's
    ABSOLUTE path (a ``tpu_faas_torch/store`` directory pair, or the
    installed ``tpu_faas_torch.store`` package itself) so the verdict is identical whether
    the file was scanned via its directory or named directly — relpath
    anchoring must never change what the checker exempts."""
    path = module.path.resolve()
    try:
        import tpu_faas_torch.store as _store_pkg

        if Path(_store_pkg.__file__).resolve().parent in path.parents:
            return True
    except ImportError:  # pragma: no cover - package always importable here
        pass
    parts = path.parts
    return any(
        parts[i] == "tpu_faas_torch" and parts[i + 1] == "store"
        for i in range(len(parts) - 1)
    )


class ProtocolChecker(Checker):
    name = "protocol"

    def check(self, module: Module) -> Iterable[Finding]:
        store_internal = _in_store_package(module)
        for node in ast.walk(module.tree):
            if isinstance(
                node, (ast.FunctionDef, ast.AsyncFunctionDef)
            ) and "quarantine" in node.name:
                yield from self._check_quarantine_drain(module, node)
            if not isinstance(node, ast.Call):
                continue
            method = (
                node.func.attr if isinstance(node.func, ast.Attribute) else None
            )
            if method == "finish_task":
                yield from self._check_finish(module, node)
            elif method == "set_status":
                yield from self._check_set_status(module, node, store_internal)
            elif method == "set_status_many":
                yield from self._check_set_status_many(
                    module, node, store_internal
                )
            elif method == "finish_task_many":
                yield from self._check_finish_many(module, node)
            elif method in ("hset", "hset_many") and not store_internal:
                yield from self._check_raw_hset(module, node)
                yield from self._check_raw_blob(module, node)
            elif method in ("setnx_field", "delete") and not store_internal:
                yield from self._check_raw_blob(module, node)
            elif method == "publish" and not store_internal:
                yield from self._check_raw_publish(module, node)

    # -- individual rules --------------------------------------------------
    def _check_quarantine_drain(
        self, module: Module, fn: ast.FunctionDef
    ) -> Iterator[Finding]:
        """No terminal-status write may originate on the quarantine drain
        path. A quarantined worker's in-flight tasks are still LIVE — they
        complete on the worker or ride the ordinary liveness reclaim —
        so any function named for the quarantine plane that calls a
        terminal writer has turned a routing decision into task loss."""
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            method = (
                node.func.attr
                if isinstance(node.func, ast.Attribute)
                else (node.func.id if isinstance(node.func, ast.Name) else None)
            )
            if method in QUARANTINE_BANNED_CALLS:
                yield self.finding(
                    module,
                    node,
                    "quarantine-drain-terminal",
                    "error",
                    f"{method} called inside quarantine-path function "
                    f"{fn.name!r}: quarantine drain must never write a "
                    f"terminal task status — the masked worker's in-flight "
                    f"tasks are still live (they complete or reclaim "
                    f"through the ordinary paths); a terminal write here "
                    f"turns a health-routing decision into task loss "
                    f"(banned: {', '.join(sorted(QUARANTINE_BANNED_CALLS))})",
                )

    def _arg(self, call: ast.Call, index: int, keyword: str) -> ast.AST | None:
        if len(call.args) > index:
            return call.args[index]
        for kw in call.keywords:
            if kw.arg == keyword:
                return kw.value
        return None

    def _check_status_value(
        self, module: Module, node: ast.AST, status: str
    ) -> Iterator[Finding]:
        if status not in STATUS_NAMES:
            yield self.finding(
                module,
                node,
                "unknown-status",
                "error",
                f"status literal {status!r} is not a TaskStatus member "
                f"(known: {', '.join(sorted(STATUS_NAMES))})",
            )

    def _check_finish(self, module: Module, call: ast.Call) -> Iterator[Finding]:
        arg = self._arg(call, 1, "status")
        status = _status_literal(arg) if arg is not None else None
        if status is None:
            return
        if status not in STATUS_NAMES:
            yield from self._check_status_value(module, call, status)
            return
        if status not in LEGAL_FINISH:
            yield self.finding(
                module,
                call,
                "illegal-finish-status",
                "error",
                f"finish_task writes {status}, but RUNNING -> {status} is "
                f"not a legal terminal transition in racecheck._LEGAL "
                f"(legal: {', '.join(sorted(LEGAL_FINISH))})",
            )

    def _check_set_status(
        self, module: Module, call: ast.Call, store_internal: bool = False
    ) -> Iterator[Finding]:
        arg = self._arg(call, 1, "status")
        status = _status_literal(arg) if arg is not None else None
        if status is None:
            return
        if status not in STATUS_NAMES:
            yield from self._check_status_value(module, call, status)
            return
        if status in TERMINAL:
            yield self.finding(
                module,
                call,
                "terminal-set-status",
                "error",
                f"set_status writes terminal {status}: terminal writes must "
                f"go through finish_task/cancel_task (FINISHED_AT stamp, "
                f"live-index removal, RESULTS_CHANNEL announce)",
            )
        elif status == "WAITING" and not store_internal:
            yield self.finding(
                module,
                call,
                "waiting-set-status",
                "error",
                "set_status writes WAITING outside the store package: "
                "WAITING nodes are created by create_task(s)(status=WAITING) "
                "with their dependency fields, and only the store's "
                "promotion plane (complete_dep_many/resolve_waiting) moves "
                "them out — a bare WAITING write strands a task no "
                "dispatcher may ever send",
            )
        elif status == "RUNNING" and self._arg(call, 2, "extra_fields") is None:
            yield self.finding(
                module,
                call,
                "running-without-lease",
                "warning",
                "RUNNING mark without extra_fields: no FIELD_LEASE_AT "
                "ownership lease rides the write, so the record is "
                "unadoptable if its worker and dispatcher both die",
            )

    def _check_set_status_many(
        self, module: Module, call: ast.Call, store_internal: bool = False
    ) -> Iterator[Finding]:
        """The batched status write carries ONE shared status as its first
        argument precisely so this check works like plain set_status's:
        never terminal, always a known member. (The per-item extra_fields
        — where the RUNNING lease stamps ride — are built dynamically, so
        the lease warning is out of static reach for the batch form; the
        runtime race monitor still observes every item.)"""
        arg = self._arg(call, 0, "status")
        status = _status_literal(arg) if arg is not None else None
        if status is None:
            return
        if status not in STATUS_NAMES:
            yield from self._check_status_value(module, call, status)
            return
        if status == "WAITING" and not store_internal:
            yield self.finding(
                module,
                call,
                "waiting-set-status",
                "error",
                "set_status_many writes WAITING outside the store package: "
                "only create_task(s)(status=WAITING) and the store's "
                "promotion plane may touch the WAITING state",
            )
            return
        if status in TERMINAL:
            yield self.finding(
                module,
                call,
                "terminal-set-status",
                "error",
                f"set_status_many writes terminal {status}: terminal writes "
                f"must go through finish_task/finish_task_many/cancel_task "
                f"(FINISHED_AT stamp, live-index removal, RESULTS_CHANNEL "
                f"announce)",
            )

    def _check_finish_many(
        self, module: Module, call: ast.Call
    ) -> Iterator[Finding]:
        """finish_task_many takes (task_id, status, result, first_wins)
        tuples; wherever an items list is a literal, each tuple's status
        slot is checked against the legal finish set. Dynamically built
        item lists (the dispatcher's drain buffer) are out of static scope
        — those statuses come off the wire and are validated by the
        runtime race monitor instead."""
        items = self._arg(call, 0, "items")
        if not isinstance(items, (ast.List, ast.Tuple)):
            return
        for elt in items.elts:
            if not isinstance(elt, ast.Tuple) or len(elt.elts) < 2:
                continue
            status = _status_literal(elt.elts[1])
            if status is None:
                continue
            if status not in STATUS_NAMES:
                yield from self._check_status_value(module, elt.elts[1], status)
            elif status not in LEGAL_FINISH:
                yield self.finding(
                    module,
                    elt,
                    "illegal-finish-status",
                    "error",
                    f"finish_task_many writes {status}, but RUNNING -> "
                    f"{status} is not a legal terminal transition in "
                    f"racecheck._LEGAL "
                    f"(legal: {', '.join(sorted(LEGAL_FINISH))})",
                )

    def _dict_literals(self, call: ast.Call) -> Iterator[ast.Dict]:
        for arg in list(call.args) + [kw.value for kw in call.keywords]:
            if isinstance(arg, ast.Dict):
                yield arg
            elif isinstance(arg, (ast.List, ast.Tuple)):
                for elt in arg.elts:
                    if isinstance(elt, ast.Dict):
                        yield elt
                    elif isinstance(elt, ast.Tuple):
                        for sub in elt.elts:
                            if isinstance(sub, ast.Dict):
                                yield sub

    def _check_raw_hset(
        self, module: Module, call: ast.Call
    ) -> Iterator[Finding]:
        for d in self._dict_literals(call):
            for key, value in zip(d.keys, d.values):
                if key is None:  # **spread: opaque, nothing provable
                    continue
                named = (
                    isinstance(key, ast.Name) and key.id in _STATUS_FIELD_NAMES
                )
                literal = (
                    isinstance(key, ast.Constant)
                    and key.value in _STATUS_FIELD_STRINGS
                )
                if not (named or literal):
                    continue
                yield self.finding(
                    module,
                    call,
                    "raw-status-write",
                    "error",
                    "raw hset writes a status/result field outside the "
                    "TaskStore conveniences: the racecheck monitor models "
                    "set_status/finish_task/cancel_task writers only, so "
                    "this write is invisible to the protocol",
                )
                is_status_key = (
                    isinstance(key, ast.Name) and key.id == "FIELD_STATUS"
                ) or (isinstance(key, ast.Constant) and key.value == FIELD_STATUS)
                if is_status_key:
                    status = _status_literal(value)
                    if status is not None:
                        yield from self._check_status_value(
                            module, value, status
                        )
                break  # one finding per dict literal

    @staticmethod
    def _names_blob_key(node: ast.AST) -> bool:
        """True when a key expression statically addresses the blob
        namespace: a "blob:..." literal, a blob_key(...) call, or any
        concatenation/f-string mentioning BLOB_PREFIX. Dynamic key lists
        (the sweeper's GC) are out of static reach by design."""
        if (
            isinstance(node, ast.Constant)
            and isinstance(node.value, str)
            and node.value.startswith(BLOB_PREFIX)
        ):
            return True
        if isinstance(node, ast.Call):
            named = dotted_name(node.func)
            if named is not None and named.split(".")[-1] == "blob_key":
                return True
        if isinstance(node, ast.BinOp):
            return ProtocolChecker._names_blob_key(
                node.left
            ) or ProtocolChecker._names_blob_key(node.right)
        named = dotted_name(node)
        if named is not None and named.split(".")[-1] == "BLOB_PREFIX":
            return True
        if isinstance(node, ast.JoinedStr):
            for v in node.values:
                if (
                    isinstance(v, ast.Constant)
                    and isinstance(v.value, str)
                    and v.value.startswith(BLOB_PREFIX)
                ):
                    return True
                if isinstance(
                    v, ast.FormattedValue
                ) and ProtocolChecker._names_blob_key(v.value):
                    return True
        return False

    def _check_raw_blob(
        self, module: Module, call: ast.Call
    ) -> Iterator[Finding]:
        key = self._arg(call, 0, "key")
        if key is None or not self._names_blob_key(key):
            return
        method = call.func.attr if isinstance(call.func, ast.Attribute) else "?"
        yield self.finding(
            module,
            call,
            "raw-blob-write",
            "error",
            f"raw {method} into the blob namespace outside the store "
            f"package: blobs are create-once content — writes must go "
            f"through put_blob (setnx'd data + TTL stamp, validated "
            f"against the digest by the race monitor), and deletes "
            f"through the sweeper's reference-checked GC",
        )

    def _check_raw_publish(
        self, module: Module, call: ast.Call
    ) -> Iterator[Finding]:
        channel = self._arg(call, 0, "channel")
        if channel is None:
            return
        named = dotted_name(channel)
        hit = (
            isinstance(channel, ast.Constant)
            and channel.value in _TASK_CHANNEL_STRINGS
        ) or (
            named is not None
            and named.split(".")[-1] in _TASK_CHANNEL_NAMES
        )
        if hit:
            yield self.finding(
                module,
                call,
                "raw-task-publish",
                "error",
                "raw publish on a task lifecycle channel outside the store "
                "package: announces must ride create_task/finish_task/"
                "cancel_task so ordering guarantees (announce AFTER the "
                "record write) hold",
            )
