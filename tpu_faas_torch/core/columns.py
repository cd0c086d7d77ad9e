"""Columnar task arena: the host data plane's struct-of-arrays backbone.

The dispatcher's hot path historically re-materialized every task as a
per-item Python object at every stage — store record dict -> PendingTask ->
per-field list comprehensions feeding the device tick's arrays. At
sub-millisecond task granularity the per-task constant cost of that churn
IS the throughput ceiling (BENCH_r07/r11: ~2.6k tasks/s per process while
the device tick is ~1 ms at 50k x 4k).

:class:`TaskColumns` keeps task metadata in preallocated numpy columns from
intake through the tick's act phase instead: fixed capacity, free-slot
recycling, id<->row interning, and vectorized gathers that hand the tick
zero-copy column slices (the tick already thinks in arrays — intake stops
converting array -> dict -> array). :class:`RowTask` is the per-task view:
it duck-types ``dispatch.base.PendingTask`` (same attribute surface, same
``task_message_kwargs``/``size_estimate`` semantics) so every downstream
consumer — pending queues, frame builders, estimators — works unchanged,
while the batch-wide loops read whole columns.

Lifecycle: ``intake_flat`` parses a store record (flat [field, value, ...]
lists, bytes or str — the shape ``hgetall_many_raw`` returns) straight into
a free row and hands back a RowTask; ``RowTask.release()`` detaches the
view (field values are snapshotted into a small shadow dict) and recycles
the row. Detach-on-release makes release idempotent and use-after-release
safe by construction: a released RowTask still answers every attribute from
its snapshot, it just no longer occupies arena capacity. A FULL arena makes
``intake_flat`` return None and the caller falls back to the plain
PendingTask path — overload degrades to the dict plane, never to an error.

Value parsing mirrors ``PendingTask.from_fields`` exactly (defensive
clamps included); tests/test_columns.py property-tests the equivalence.
"""

from __future__ import annotations

import math

import numpy as np

from tpu_faas_torch.core.task import (
    FIELD_COST,
    FIELD_DEADLINE,
    FIELD_FN,
    FIELD_FN_DIGEST,
    FIELD_PARAMS,
    FIELD_PRIORITY,
    FIELD_SLO_CLASS,
    FIELD_SPECULATIVE,
    FIELD_SUBMITTED_AT,
    FIELD_TENANT,
    FIELD_TIMEOUT,
    FIELD_TRACE_ID,
)
from tpu_faas_torch.obs.attribution import class_of

#: row lifecycle codes (the ``status`` column)
STATUS_FREE = 0
STATUS_PENDING = 1
STATUS_DISPATCHED = 2

#: priority clamp, same bound as PendingTask.from_fields (int32 batch
#: build with negation headroom)
_PRIO_CLAMP = 2**30


def _to_str(value) -> str:
    """Column values arrive as bytes on the binary-batch store path and
    str everywhere else; string-typed columns normalize here (payloads are
    the ASCII serialize contract, but utf-8 decoding is strictly more
    permissive and matches the str path byte for byte)."""
    return value.decode("utf-8") if isinstance(value, bytes) else value


def _positive_finite(raw) -> float:
    """``dispatch.base._parse_positive_finite`` over bytes-or-str, with
    nan standing in for None (the column encoding of 'no hint')."""
    if raw is None:
        return math.nan
    try:
        value = float(raw)
    except ValueError:
        return math.nan
    return value if math.isfinite(value) and value > 0.0 else math.nan


def _nan_none(value: float) -> float | None:
    return None if math.isnan(value) else float(value)


class TaskColumns:
    """Fixed-capacity struct-of-arrays task arena (module docstring)."""

    def __init__(self, capacity: int = 8192) -> None:
        cap = int(capacity)
        if cap <= 0:
            raise ValueError(f"arena capacity must be positive, got {cap}")
        self.capacity = cap
        # string-typed columns (object dtype: variable-length payloads)
        self.task_id = np.empty(cap, dtype=object)
        self.fn_payload = np.empty(cap, dtype=object)
        self.param_payload = np.empty(cap, dtype=object)
        self.fn_digest = np.empty(cap, dtype=object)
        self.trace_id = np.empty(cap, dtype=object)
        self.tenant = np.empty(cap, dtype=object)
        self.slo_class = np.empty(cap, dtype=object)
        # numeric columns (nan = absent on the optional-hint floats)
        self.status = np.zeros(cap, dtype=np.int8)
        self.priority = np.zeros(cap, dtype=np.int32)
        self.retries = np.zeros(cap, dtype=np.int32)
        self.speculative = np.zeros(cap, dtype=bool)
        self.cost = np.full(cap, np.nan, dtype=np.float64)
        self.timeout = np.full(cap, np.nan, dtype=np.float64)
        self.learned = np.full(cap, np.nan, dtype=np.float64)
        self.submitted_at = np.full(cap, np.nan, dtype=np.float64)
        self.deadline_at = np.full(cap, np.nan, dtype=np.float64)
        #: len(fn_payload) + len(param_payload), cached at intake so the
        #: size-estimate gather never touches the object columns
        self.payload_bytes = np.zeros(cap, dtype=np.int64)
        #: monotonic stamp of the moment the act loop sent the row's task
        #: (0 = never dispatched) — the profile/diagnostics dispatch stamp
        self.dispatched_at = np.zeros(cap, dtype=np.float64)
        #: id -> row interning (latest acquisition wins)
        self.rows: dict[str, int] = {}
        self._free: list[int] = list(range(cap - 1, -1, -1))

    # -- slot management ---------------------------------------------------
    @property
    def occupancy(self) -> int:
        return self.capacity - len(self._free)

    def row_of(self, task_id: str) -> int | None:
        return self.rows.get(task_id)

    def acquire(self, task_id: str) -> int | None:
        """Claim a free row for ``task_id`` (None when the arena is full —
        the caller's cue to fall back to the dict plane). The row comes
        back clean: every release scrubs its columns."""
        if not self._free:
            return None
        row = self._free.pop()
        self.task_id[row] = task_id
        self.status[row] = STATUS_PENDING
        self.rows[task_id] = row
        return row

    def release(self, row: int) -> None:
        """Recycle one row. Columns are scrubbed on the way out so object
        references (payload strings can be large) don't outlive the task,
        and the next acquire starts from defaults."""
        tid = self.task_id[row]
        if self.status[row] == STATUS_FREE:
            return  # already recycled (idempotence lives in RowTask.release)
        if tid is not None and self.rows.get(tid) == row:
            del self.rows[tid]
        self.task_id[row] = None
        self.fn_payload[row] = None
        self.param_payload[row] = None
        self.fn_digest[row] = None
        self.trace_id[row] = None
        self.tenant[row] = None
        self.slo_class[row] = None
        self.status[row] = STATUS_FREE
        self.priority[row] = 0
        self.retries[row] = 0
        self.speculative[row] = False
        self.cost[row] = np.nan
        self.timeout[row] = np.nan
        self.learned[row] = np.nan
        self.submitted_at[row] = np.nan
        self.deadline_at[row] = np.nan
        self.payload_bytes[row] = 0
        self.dispatched_at[row] = 0.0
        self._free.append(row)

    # -- intake ------------------------------------------------------------
    def intake_flat(self, task_id: str, flat: list) -> "RowTask | None":
        """Parse one store record — the flat ``[field, value, ...]`` list
        ``hgetall_many_raw`` returns, elements bytes or str — straight
        into a free row, no intermediate dict. Returns the attached
        RowTask, or None when the arena is full. Parsing semantics are
        PendingTask.from_fields verbatim: malformed hints degrade to
        defaults, priority clamps into int32 range, empty-string digests/
        trace ids/tenants read as absent."""
        row = self.acquire(task_id)
        if row is None:
            return None
        fn = params = ""
        for i in range(0, len(flat) - 1, 2):
            f, v = flat[i], flat[i + 1]
            if isinstance(f, bytes):
                f = f.decode("utf-8")
            if f == FIELD_FN:
                fn = _to_str(v)
            elif f == FIELD_PARAMS:
                params = _to_str(v)
            elif f == FIELD_PRIORITY:
                try:
                    p = int(v)
                except ValueError:
                    p = 0
                self.priority[row] = max(-_PRIO_CLAMP, min(_PRIO_CLAMP, p))
            elif f == FIELD_COST:
                self.cost[row] = _positive_finite(v)
            elif f == FIELD_TIMEOUT:
                self.timeout[row] = _positive_finite(v)
            elif f == FIELD_SUBMITTED_AT:
                self.submitted_at[row] = _positive_finite(v)
            elif f == FIELD_DEADLINE:
                self.deadline_at[row] = _positive_finite(v)
            elif f == FIELD_FN_DIGEST:
                self.fn_digest[row] = _to_str(v) or None
            elif f == FIELD_TRACE_ID:
                self.trace_id[row] = _to_str(v) or None
            elif f == FIELD_TENANT:
                self.tenant[row] = _to_str(v) or None
            elif f == FIELD_SLO_CLASS:
                self.slo_class[row] = _to_str(v) or None
            elif f == FIELD_SPECULATIVE:
                self.speculative[row] = v in ("1", b"1")
        self.fn_payload[row] = fn
        self.param_payload[row] = params
        self.payload_bytes[row] = len(fn) + len(params)
        return RowTask(self, row)

    # -- vectorized gathers (the tick's batch-build reads) ------------------
    def gather_sizes(self, rows: np.ndarray) -> np.ndarray:
        """f32 size estimates for many rows in three vector ops — the
        column form of ``PendingTask.size_estimate``'s trust order:
        explicit cost hint, else learned estimate, else payload bytes."""
        cost = self.cost[rows]
        learned = self.learned[rows]
        fallback = np.where(
            np.isnan(learned), self.payload_bytes[rows].astype(np.float64),
            learned,
        )
        return np.where(np.isnan(cost), fallback, cost).astype(np.float32)

    def gather_priorities(self, rows: np.ndarray) -> np.ndarray:
        return self.priority[rows]

    def gather_deadlines(self, rows: np.ndarray) -> np.ndarray:
        """f64 absolute deadlines, nan = none."""
        return self.deadline_at[rows]

    def stamp_dispatched(self, row: int, now: float) -> None:
        self.dispatched_at[row] = now
        self.status[row] = STATUS_DISPATCHED


def _obj_prop(col: str, default=None):
    def get(self):
        sh = self._shadow
        if sh is not None:
            return sh[col]
        v = getattr(self._arena, col)[self._row]
        return default if v is None else v

    def set(self, value):
        sh = self._shadow
        if sh is not None:
            sh[col] = value
        else:
            getattr(self._arena, col)[self._row] = value

    return property(get, set)


def _optfloat_prop(col: str):
    def get(self):
        sh = self._shadow
        if sh is not None:
            return sh[col]
        return _nan_none(getattr(self._arena, col)[self._row])

    def set(self, value):
        sh = self._shadow
        if sh is not None:
            sh[col] = value
        else:
            getattr(self._arena, col)[self._row] = (
                math.nan if value is None else float(value)
            )

    return property(get, set)


def _int_prop(col: str):
    def get(self):
        sh = self._shadow
        if sh is not None:
            return sh[col]
        return int(getattr(self._arena, col)[self._row])

    def set(self, value):
        sh = self._shadow
        if sh is not None:
            sh[col] = value
        else:
            getattr(self._arena, col)[self._row] = value

    return property(get, set)


def _bool_prop(col: str):
    def get(self):
        sh = self._shadow
        if sh is not None:
            return sh[col]
        return bool(getattr(self._arena, col)[self._row])

    def set(self, value):
        sh = self._shadow
        if sh is not None:
            sh[col] = value
        else:
            getattr(self._arena, col)[self._row] = bool(value)

    return property(get, set)


class RowTask:
    """Arena-backed task view, duck-typing ``dispatch.base.PendingTask``.

    While attached, every attribute reads/writes its arena column — there
    is no per-task field storage at all. ``release()`` detaches: the field
    values are snapshotted into a small shadow dict and the row recycles,
    after which the view keeps answering (and absorbing) every attribute
    from the snapshot. Double release is a no-op; a leaked (never
    released) view merely occupies a row until the arena fills and intake
    falls back to the dict plane — observable on the occupancy gauge,
    never a correctness failure.
    """

    __slots__ = ("_arena", "_row", "_shadow", "task_id", "is_hedge", "avoid_row")

    def __init__(self, arena: TaskColumns, row: int) -> None:
        self._arena = arena
        self._row = row
        self._shadow: dict | None = None
        # the id is immutable for the life of the task and by far the
        # most-read field (traces, inflight bookkeeping, claim maps read
        # it several times per dispatch) — a plain slot, not a column
        # property, so those reads cost what a PendingTask attribute does
        self.task_id = arena.task_id[row]
        # hedge replicas are host-constructed PendingTasks, never arena
        # rows; these exist so generic pending-task consumers can read them
        self.is_hedge = False
        self.avoid_row = -1

    fn_payload = _obj_prop("fn_payload", default="")
    param_payload = _obj_prop("param_payload", default="")
    fn_digest = _obj_prop("fn_digest")
    trace_id = _obj_prop("trace_id")
    tenant = _obj_prop("tenant")
    slo_class = _obj_prop("slo_class")
    priority = _int_prop("priority")
    retries = _int_prop("retries")
    speculative = _bool_prop("speculative")
    cost = _optfloat_prop("cost")
    timeout = _optfloat_prop("timeout")
    learned = _optfloat_prop("learned")
    submitted_at = _optfloat_prop("submitted_at")
    deadline_at = _optfloat_prop("deadline_at")

    @property
    def row(self) -> int | None:
        """Arena row while attached, None once released."""
        return None if self._shadow is not None else self._row

    @property
    def attached(self) -> bool:
        return self._shadow is None

    @property
    def effective_class(self) -> str:
        """PendingTask.effective_class verbatim: declared class wins,
        else the priority sign decides."""
        return class_of(self.slo_class, self.priority)

    @property
    def size_estimate(self) -> float:
        """PendingTask.size_estimate's trust order, column-backed."""
        if self._shadow is None:
            a, r = self._arena, self._row
            c = a.cost[r]
            if not math.isnan(c):
                return float(c)
            l = a.learned[r]
            if not math.isnan(l):
                return float(l)
            return float(a.payload_bytes[r])
        sh = self._shadow
        if sh["cost"] is not None:
            return sh["cost"]
        if sh["learned"] is not None:
            return sh["learned"]
        return float(len(sh["fn_payload"]) + len(sh["param_payload"]))

    def task_message_kwargs(self, blob: bool = False, trace: bool = False) -> dict:
        """PendingTask.task_message_kwargs verbatim — the ONE place the
        columnar plane materializes a per-task dict, because this dict IS
        the legacy-worker wire contract. Attached views read their columns
        directly (this runs once per dispatched task; six property hops
        here were a measurable slice of the serve loop)."""
        sh = self._shadow
        if sh is None:
            a, r = self._arena, self._row
            fn_digest = a.fn_digest[r]
            fn_payload = a.fn_payload[r]
            param_payload = a.param_payload[r]
            timeout = a.timeout[r]
            trace_id = a.trace_id[r]
        else:
            fn_digest = sh["fn_digest"]
            fn_payload = sh["fn_payload"]
            param_payload = sh["param_payload"]
            timeout = sh["timeout"]
            trace_id = sh["trace_id"]
        out = {  # faas: allow(eventloop.hot-loop-dict-churn) the TASK frame's wire payload: this dict IS the worker message contract, materialized once per dispatch at the legacy boundary
            "task_id": self.task_id,
            "param_payload": "" if param_payload is None else param_payload,
        }
        if blob and fn_digest:
            out["fn_digest"] = fn_digest
        else:
            out["fn_payload"] = "" if fn_payload is None else fn_payload
            if fn_digest:
                out["fn_digest"] = fn_digest
        if timeout is not None and not (
            isinstance(timeout, float) and math.isnan(timeout)
        ):
            out["timeout"] = float(timeout)
        if trace and trace_id:
            out["trace_id"] = trace_id
        return out

    def release(self) -> None:
        """Detach from the arena and recycle the row (idempotent). The
        snapshot keeps the view fully functional afterwards — parked or
        re-queued copies of a task that already left the arena behave
        exactly like plain PendingTasks."""
        if self._shadow is not None:
            return
        a, r = self._arena, self._row
        self._shadow = {
            "fn_payload": a.fn_payload[r] or "",
            "param_payload": a.param_payload[r] or "",
            "fn_digest": a.fn_digest[r],
            "trace_id": a.trace_id[r],
            "tenant": a.tenant[r],
            "slo_class": a.slo_class[r],
            "priority": int(a.priority[r]),
            "retries": int(a.retries[r]),
            "speculative": bool(a.speculative[r]),
            "cost": _nan_none(a.cost[r]),
            "timeout": _nan_none(a.timeout[r]),
            "learned": _nan_none(a.learned[r]),
            "submitted_at": _nan_none(a.submitted_at[r]),
            "deadline_at": _nan_none(a.deadline_at[r]),
        }
        a.release(r)

    #: post-discard field values: a discarded view answers defaults, not
    #: its last column state (see discard)
    _DISCARD_SHADOW = {
        "fn_payload": "",
        "param_payload": "",
        "fn_digest": None,
        "trace_id": None,
        "tenant": None,
        "slo_class": None,
        "priority": 0,
        "retries": 0,
        "speculative": False,
        "cost": None,
        "timeout": None,
        "learned": None,
        "submitted_at": None,
        "deadline_at": None,
    }

    def discard(self) -> None:
        """Detach WITHOUT the field snapshot — for views whose fate is
        sealed (the task is on the wire and a reclaim rebuilds from the
        store record, never from this object). The row recycles exactly
        as in :meth:`release`, but the 14-field snapshot — measurable at
        dispatch rates — is replaced by a template copy: ``task_id``
        survives (it is a slot), every other field reads as its default.
        Idempotent, and interchangeable with release() for double-detach
        (whichever runs first wins)."""
        if self._shadow is not None:
            return
        self._shadow = dict(self._DISCARD_SHADOW)
        self._arena.release(self._row)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        state = "detached" if self._shadow is not None else f"row={self._row}"
        return f"<RowTask {self.task_id!r} {state}>"
