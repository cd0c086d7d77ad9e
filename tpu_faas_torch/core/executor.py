"""The function executor: deserialize, call, catch everything, reserialize.

Capability contract (reference helper_functions.py:11-28):

- params decode to a pair ``(args_tuple, kwargs_dict)`` and the call is
  ``fn(*args, **kwargs)``;
- ANY exception — raised while deserializing the function, deserializing the
  params, or running the function — yields status FAILED with the serialized
  exception as the result; success yields COMPLETED with the serialized
  return value;
- the return triple ``(task_id, status, ser_result)`` is what worker pools
  hand back to their drain loops.

This function is the unit every execution backend shares: the local
dispatcher pool, pull workers, and push workers all ``apply_async`` it
(reference task_dispatcher.py:83-86, pull_worker.py:63-72, push_worker.py:117-123).
"""

from __future__ import annotations

import signal
import threading
from collections import OrderedDict
from typing import NamedTuple

from tpu_faas_torch.core.serialize import deserialize, serialize
from tpu_faas_torch.core.task import TaskStatus

#: Child-side cache of DESERIALIZED functions keyed by content digest
#: (core/payload.py sha256, carried on TASK messages as ``fn_digest``).
#: Lives in the pool child's module globals — each forkserver child keeps
#: its own — so steady-state execution of a repeated function pays ZERO
#: dill decode: the decode cost moves from per-task to per-(child,
#: function). Entry-bounded, not byte-bounded: the cached values are live
#: Python callables whose footprint dill can't meaningfully size.
_FN_CACHE_CAP = 64
_FN_CACHE: OrderedDict[str, object] = OrderedDict()


def _cached_fn(ser_fn: str, fn_digest: str | None):
    """Deserialize ``ser_fn``, through the digest-keyed cache when the
    caller supplied a digest. Trusting the digest (not re-hashing) is
    deliberate: it came from the same content-addressed plane that
    produced the payload, and hashing per task would give back a third of
    the decode saving."""
    if fn_digest is None:
        return deserialize(ser_fn)
    fn = _FN_CACHE.get(fn_digest)
    if fn is None:
        fn = deserialize(ser_fn)
        _FN_CACHE[fn_digest] = fn
        while len(_FN_CACHE) > _FN_CACHE_CAP:
            _FN_CACHE.popitem(last=False)
    else:
        _FN_CACHE.move_to_end(fn_digest)
    return fn


#: Child-side parent-result delivery (result-blob plane): while a graph
#: child executes, the serialized results of its confirmed parents —
#: shipped on the TASK frame as digests or bodies and resolved through
#: the worker's result cache — sit here. Plain module global: a pool
#: child executes one task at a time, and execute_fn scopes it to the
#: call. None everywhere the plane is off, so flat tasks and legacy
#: deployments never see it.
_DEP_RESULTS: dict[str, str] | None = None


def dep_results() -> dict[str, str]:
    """The executing graph child's parent results, parent task id ->
    SERIALIZED body; {} for flat tasks and delivery-off deployments.
    Functions opt in by calling this — graph edges stay ordering-only
    (examples/task_graphs.py) for everyone else."""
    return dict(_DEP_RESULTS) if _DEP_RESULTS else {}


def dep_values() -> dict[str, object]:
    """:func:`dep_results` with every body deserialized — the convenient
    form for fan-in consumers (``sum(dep_values().values())``-style)."""
    return {pid: deserialize(body) for pid, body in dep_results().items()}


class ExecutionResult(NamedTuple):
    task_id: str
    #: plain string, wire/store form: "COMPLETED" | "FAILED" | "CANCELLED"
    #: (the last only from a force-cancel interrupt, worker/pool.py)
    status: str
    result: str  # serialized payload (value or exception)
    #: wall seconds the execution took IN THE POOL CHILD (deserialize +
    #: call + serialize), measured at the source so it carries no pool
    #: queueing or transport time; rides the RESULT message as `elapsed`
    #: and feeds the dispatcher's runtime estimator (sched/estimator.py).
    #: None on paths that never executed (cancelled futures, broken pools).
    elapsed: float | None = None
    #: epoch seconds when the child began executing; rides the RESULT
    #: message as `started_at` so the dispatcher's task timeline
    #: (tpu_faas/obs/trace.py) gets exec_start/exec_end events measured at
    #: the source. `started_at + elapsed` is the exec-end stamp. None on
    #: paths that never executed.
    started_at: float | None = None


class TaskTimeout(BaseException):
    """Raised inside a pool child when a task exceeds its time budget.

    Deliberately a BaseException: runaway tasks are very often shaped like
    ``while True: try: work() except Exception: continue`` — an
    Exception-derived timeout would be swallowed by that loop (and the
    one-shot itimer never fires again), silently re-creating the wedged
    slot the feature exists to prevent. User code that catches
    BaseException defeats this, like it defeats KeyboardInterrupt; that
    residual case is the operator-kill path.
    """


class TaskCancelledInterrupt(BaseException):
    """Raised inside a pool child when a FORCE cancel interrupts the task
    mid-run (worker/pool.py's SIGUSR1 handler — the externally-triggered
    sibling of the SIGALRM timeout above, same BaseException rationale).
    Surfaces as a terminal CANCELLED result, not FAILED: the caller asked
    for exactly this outcome."""


#: Arm-time cap (~194 days): setitimer raises OverflowError far above this
#: (platform time_t), and no task budget is legitimately this long.
_MAX_TIMEOUT_S = float(2**24)


def execute_fn(
    task_id: str,
    ser_fn: str,
    ser_params: str,
    timeout: float | None = None,
    fn_digest: str | None = None,
    dep_results: dict[str, str] | None = None,
) -> ExecutionResult:
    """Execute one task; never raises.

    Runs in worker pool child processes — keep it dependency-light and make
    sure every outcome is expressible as a serializable (status, result) pair.

    ``timeout`` (seconds, client's ``timeout`` hint) bounds the call with a
    SIGALRM-based interrupt in the child: a runaway pure-Python task raises
    :class:`TaskTimeout` -> FAILED and RELEASES its process slot (without
    this, one infinite loop permanently eats a slot — a capacity leak the
    dispatcher's poison guard can't see, since the worker stays alive and
    heartbeating). Limitations, by design: POSIX main-thread only (elsewhere
    it degrades to no enforcement), and C-extension code that never yields
    to the interpreter can't be interrupted — that residual case needs an
    operator killing the worker (purge + re-dispatch then recover the task).
    """
    import time

    global _DEP_RESULTS
    t0_wall = time.time()
    t0 = time.perf_counter()
    _DEP_RESULTS = dep_results
    try:
        res = _execute_guarded(task_id, ser_fn, ser_params, timeout, fn_digest)
    except TaskTimeout as exc:
        # the alarm landed in the narrow window between an exception being
        # caught and the timer disarm: still a clean FAILED, never a raise
        res = ExecutionResult(task_id, str(TaskStatus.FAILED), serialize(exc))
    except TaskCancelledInterrupt as exc:
        # same narrow window for a force cancel's interrupt — and unlike a
        # fired (one-shot, self-disarming) alarm, the itimer may still be
        # ARMED here (the interrupt escaped between an exception being
        # caught and _execute_guarded's disarm): a stale alarm firing into
        # the child's NEXT task would fail it with the old task's budget
        if hasattr(signal, "setitimer"):
            try:
                signal.setitimer(signal.ITIMER_REAL, 0)
            except Exception:
                pass
        res = ExecutionResult(
            task_id, str(TaskStatus.CANCELLED), serialize(exc)
        )
    finally:
        # scope the delivery to this call: a later plane-off task in the
        # same child must see {} from dep_results(), not stale parents
        _DEP_RESULTS = None
    return res._replace(
        elapsed=time.perf_counter() - t0, started_at=t0_wall
    )


def _execute_guarded(
    task_id: str,
    ser_fn: str,
    ser_params: str,
    timeout: float | None,
    fn_digest: str | None = None,
) -> ExecutionResult:
    timer_armed = False
    try:
        # arming INSIDE the try: setitimer itself can raise (OverflowError
        # on absurd values — additionally clamped here), and a tiny budget's
        # alarm may fire before the user code even starts; both must follow
        # the normal FAILED path, not escape
        if timeout is not None and timeout > 0:
            if threading.current_thread() is threading.main_thread() and hasattr(
                signal, "setitimer"
            ):
                def _alarm(signum, frame):
                    raise TaskTimeout(
                        f"task {task_id} exceeded its {timeout}s time budget"
                    )

                signal.signal(signal.SIGALRM, _alarm)
                signal.setitimer(
                    signal.ITIMER_REAL, min(timeout, _MAX_TIMEOUT_S)
                )
                timer_armed = True
        fn = _cached_fn(ser_fn, fn_digest)
        params = deserialize(ser_params)
        args, kwargs = params  # contract: (args_tuple, kwargs_dict)
        result = fn(*args, **kwargs)
        # disarm BEFORE serializing: a late alarm firing inside the success
        # path would turn a finished task into a spurious FAILED
        if timer_armed:
            signal.setitimer(signal.ITIMER_REAL, 0)
            timer_armed = False
        return ExecutionResult(task_id, str(TaskStatus.COMPLETED), serialize(result))
    except TaskCancelledInterrupt as exc:
        # a force cancel interrupted the call: terminal CANCELLED, slot
        # freed — the one non-FAILED exceptional outcome (the caller asked
        # for exactly this)
        if timer_armed:
            signal.setitimer(signal.ITIMER_REAL, 0)
        return ExecutionResult(
            task_id, str(TaskStatus.CANCELLED), serialize(exc)
        )
    except (Exception, TaskTimeout) as exc:  # catch-all FAILED semantics
        if timer_armed:
            signal.setitimer(signal.ITIMER_REAL, 0)
        try:
            payload = serialize(exc)
            deserialize(payload)  # exception must round-trip for the client
        except Exception:
            # exception not round-trippable (holds a lock/socket, or is a
            # class the consumer can't reconstruct): degrade to its repr
            # rather than hand the client an unloadable payload
            payload = serialize(RuntimeError(repr(exc)))
        return ExecutionResult(task_id, str(TaskStatus.FAILED), payload)


def pack_params(*args: object, **kwargs: object) -> str:
    """Serialize a call's params in the wire format ``(args_tuple, kwargs_dict)``."""
    return serialize((args, kwargs))
