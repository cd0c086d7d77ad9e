"""Python client SDK.

The reference has no SDK — every test/benchmark hand-rolls requests + dill
(e.g. test_client.py:95-129). This wraps the four REST endpoints (SURVEY §0.1)
plus serialization and result polling into an ergonomic client, while keeping
the raw wire format identical so hand-rolled clients interoperate.
"""

from __future__ import annotations

import time
import uuid
import weakref
from dataclasses import dataclass
from typing import Any, Callable

import requests
from requests.adapters import HTTPAdapter, Retry

from tpu_faas_torch.core.executor import pack_params
from tpu_faas_torch.core.payload import payload_digest
from tpu_faas_torch.core.serialize import deserialize, serialize
from tpu_faas_torch.core.task import DEP_FAILED_PREFIX, TaskStatus
from tpu_faas_torch.obs.tracectx import new_trace_id
from tpu_faas_torch.utils.backoff import Backoff, BackoffPolicy


class _FnMemo:
    """Client-side function dedup — the SDK half of the payload plane.

    Two memo levels, both bounded:

    - ``serialize_fn`` caches the dill+base64 payload per CALLABLE
      IDENTITY (id + weakref liveness check, so a recycled id can never
      serve another function's bytes): a submit loop that registers or
      re-serializes the same function per call stops paying dill per
      iteration;
    - ``function_id_for``/``note_registered`` dedup registration by
      payload CONTENT (sha256): register(fn) called N times — or called
      with two closures that serialize identically — yields one
      function_id and one HTTP round trip.

    Correctness does not depend on either cache: a miss just pays the
    old cost, and the gateway's own register-once dedup (payload-plane
    mode) catches what the client-side memo can't see across processes.

    The one semantic the identity memo trades away: mutating state a
    callable CLOSES OVER (cell contents, ``__defaults__``) and
    re-registering the same object returns the originally-serialized
    bytes — the memo keys on object identity, not captured state (a
    per-call deep content probe would cost what the memo saves). Code
    that mutates-and-re-registers should pass a fresh callable (def/
    lambda re-evaluation gives one) — the same discipline dill's own
    snapshot-at-serialize behavior already demands between submits.
    """

    _CAP = 1024

    def __init__(self) -> None:
        self._payloads: dict[int, tuple[weakref.ref, str]] = {}
        self._registered: dict[str, str] = {}

    def serialize_fn(self, fn: Callable) -> str:
        entry = self._payloads.get(id(fn))
        if entry is not None:
            ref, payload = entry
            if ref() is fn:
                return payload
            del self._payloads[id(fn)]  # id recycled: stale entry
        payload = serialize(fn)
        try:
            ref = weakref.ref(fn)
        except TypeError:
            return payload  # not weakref-able: correct but unmemoized
        while len(self._payloads) >= self._CAP:
            self._payloads.pop(next(iter(self._payloads)))
        self._payloads[id(fn)] = (ref, payload)
        return payload

    def function_id_for(self, payload: str) -> str | None:
        return self._registered.get(payload_digest(payload))

    def note_registered(self, payload: str, function_id: str) -> None:
        while len(self._registered) >= self._CAP:
            self._registered.pop(next(iter(self._registered)))
        self._registered[payload_digest(payload)] = function_id


class TaskFailedError(Exception):
    def __init__(self, task_id: str, cause: object) -> None:
        super().__init__(f"task {task_id} FAILED: {cause!r}")
        self.task_id = task_id
        self.cause = cause


class TaskDependencyError(TaskFailedError):
    """Raised by result() on a dep-poisoned graph node: a parent reached a
    FAILED/EXPIRED/CANCELLED terminal, so this node was failed by the
    store's promotion plane WITHOUT ever being dispatched — no side
    effects exist for it (unlike its failed ancestor, which may have run
    partially). ``parent_id`` names the direct parent whose failure
    poisoned it (for transitive poisoning, the parent is itself poisoned
    and its own result carries the next hop up).

    Retry semantics: resubmitting the poisoned subgraph is safe — none of
    its nodes executed. Address the ROOT CAUSE first: fetch the parent's
    result (``client.raw_result(parent_id)``) for the original failure,
    fix/resubmit that node, then resubmit the dependents (graph
    submissions are not idempotency-keyed; a resubmit creates fresh
    nodes). Subclasses TaskFailedError, so code that catches the generic
    failure keeps working."""

    def __init__(self, task_id: str, parent_id: str, cause: object) -> None:
        super().__init__(task_id, cause)
        self.parent_id = parent_id


def _maybe_dependency_error(task_id: str, value: object):
    """The poison protocol is message-shaped (``dep_failed:<parent>: ...``
    on a RuntimeError), not dill-class-shaped, so any client can detect it
    without import coupling. Returns the specific error or None."""
    message = str(value)
    if isinstance(value, Exception) and message.startswith(DEP_FAILED_PREFIX):
        parent = message[len(DEP_FAILED_PREFIX):].split(":", 1)[0].strip()
        return TaskDependencyError(task_id, parent, value)
    return None


class TaskExpiredError(Exception):
    """Raised by result() when the task's terminal status is EXPIRED: its
    queue deadline (the ``deadline`` submit hint) lapsed while it was
    still QUEUED, so the dispatcher shed it — the function NEVER ran, no
    side effects exist. Distinct from CANCELLED (an explicit client act)
    and from the execution ``timeout`` hint (which interrupts a RUNNING
    task and surfaces as FAILED/TaskTimeout)."""

    def __init__(self, task_id: str) -> None:
        super().__init__(
            f"task {task_id} expired in queue before dispatch"
        )
        self.task_id = task_id


#: Longest single backoff sleep either SDK will take, whatever the server
#: (or a misconfigured proxy) puts in Retry-After — an hour-scale header
#: must not hang a submit() thread for an hour.
_RETRY_AFTER_CAP_S = 30.0

#: Overload (429/503) retry schedule, shared verbatim with the async
#: SDK: 0.25 s floor doubling to a 30 s cap, multiplicative jitter so a
#: rejected burst doesn't re-arrive as the same synchronized burst.
OVERLOAD_BACKOFF = BackoffPolicy(
    floor_s=0.25, factor=2.0, cap_s=30.0, jitter_lo=0.8, jitter_hi=1.3
)


def _retry_after_s(response, default: float) -> float:
    """The server's Retry-After (delay-seconds form), else ``default``;
    clamped to ``_RETRY_AFTER_CAP_S`` — the value is caller-controlled
    input from the network, not something to sleep on unbounded."""
    raw = response.headers.get("Retry-After")
    try:
        return min(max(0.0, float(raw)), _RETRY_AFTER_CAP_S)
    except (TypeError, ValueError):
        return default


class TaskCancelledError(Exception):
    """Raised by result() when the task's terminal status is CANCELLED —
    either cancelled while still QUEUED (never ran, no side effects) or
    force-cancelled mid-run (interrupted; side effects may have PARTIALLY
    executed). The terminal record doesn't distinguish the two; callers
    that care about side effects must not assume the task never started."""

    def __init__(self, task_id: str) -> None:
        super().__init__(f"task {task_id} was cancelled before completing")
        self.task_id = task_id


@dataclass
class TaskHandle:
    client: "FaaSClient"
    task_id: str
    #: distributed trace id of this submit (trace-enabled clients against
    #: a --trace gateway); None otherwise. Key for GET /trace/<task_id>'s
    #: cross-process timeline and for joining JSON logs fleet-wide.
    trace_id: str | None = None

    def status(self) -> str:
        return self.client.status(self.task_id)

    def done(self) -> bool:
        return TaskStatus(self.status()).is_terminal()

    def forget(self) -> None:
        """Delete this task's store record once terminal (frees the store;
        the gateway refuses with 409 while the task is still live)."""
        self.client.delete_task(self.task_id)

    def cancel(self, force: bool = False) -> bool:
        """Best-effort cancel; True when the record now reads CANCELLED.
        False when it could not be cancelled — already RUNNING or already
        terminal. True is best-effort, not a guarantee the function never
        executes: a cancel racing a concurrent dispatch can lose
        (store/base.py cancel_task), in which case the task runs and the
        record converges to COMPLETED/FAILED — poll status() before
        relying on side effects having been suppressed.

        ``force=True`` additionally asks a RUNNING task to stop: its
        worker interrupts it mid-run and ships a terminal CANCELLED
        result. Asynchronous — this call still returns False for a
        RUNNING task; await the outcome via status()/result() (which
        raises TaskCancelledError once the interrupt lands, or returns
        the value if the task beat the signal)."""
        return self.client.cancel(self.task_id, force=force)

    def result(self, timeout: float = 60.0, poll_interval: float = 0.01) -> Any:
        """Wait until terminal; return the deserialized value or raise
        :class:`TaskFailedError` with the deserialized exception. Uses the
        gateway's long-poll (``?wait=``) so each round trip parks at the
        gateway instead of hammering it; ``poll_interval`` only paces the
        degenerate wait<=0 rounds right at the deadline — when the SERVER
        parked the request, the park already was the pacing, and sleeping
        another poll_interval on top would put a client-side floor under
        every result delivery (against an express-lane gateway the whole
        submit->result path can be sub-millisecond). A non-terminal reply
        that came back in well under the requested wait means the server
        did NOT park (gateway draining/stopping, or a wait-oblivious
        foreign gateway) — those rounds pace, or the loop would hot-spin
        zero-delay requests at the worst moment."""
        deadline = time.monotonic() + timeout
        while True:
            remaining = deadline - time.monotonic()
            wait = max(0.0, min(remaining, 5.0))
            t_req = time.monotonic()
            status, payload = self.client.raw_result(self.task_id, wait=wait)
            done, value = _unwrap_terminal(self.task_id, status, payload)
            if done:
                return value
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"task {self.task_id} still {status} after {timeout}s"
                )
            if wait <= 0 or time.monotonic() - t_req < 0.5 * wait:
                time.sleep(poll_interval)


def _unwrap_terminal(task_id: str, status: str, payload: str):
    """(done, value) for one /result poll — the single place that knows the
    terminal-status protocol (FAILED carries a serialized exception;
    CANCELLED and EXPIRED carry no result at all)."""
    if not TaskStatus(status).is_terminal():
        return False, None
    if status == str(TaskStatus.CANCELLED):
        raise TaskCancelledError(task_id)
    if status == str(TaskStatus.EXPIRED):
        raise TaskExpiredError(task_id)
    value = deserialize(payload)
    if status == str(TaskStatus.FAILED):
        dep_error = _maybe_dependency_error(task_id, value)
        if dep_error is not None:
            raise dep_error
        raise TaskFailedError(task_id, value)
    return True, value


class FaaSClient:
    def __init__(
        self,
        base_url: str = "http://127.0.0.1:8000",
        connect_retries: int = 5,
        overload_retries: int = 4,
        auto_idempotency: bool = True,
        trace: bool = False,
        tenant: str | None = None,
    ) -> None:
        """``overload_retries``: how many times a submit rejected with
        429/503 (admission brownout, saturated system, store breaker) is
        retried, honoring the server's ``Retry-After`` with jittered
        exponential backoff; 0 surfaces the HTTPError on the first
        reject. ``auto_idempotency``: mint a fresh idempotency key per
        submit when the caller supplied none, so those retries (and any
        manual re-send after a lost response) are duplicate-safe end to
        end — the retry addresses the SAME task record. ``trace``: mint a
        distributed trace id per submit (obs/tracectx) and send it with
        the request; against a ``--trace`` gateway the returned handles
        carry ``trace_id`` and ``/trace/<task_id>`` assembles the
        cross-process timeline. Harmless against a trace-disabled
        gateway (the field is ignored there). ``tenant``: this client's
        tenant identity (tpu_faas/tenancy) — sent as ``X-Tenant-Id`` on
        every request, so the dispatcher's weighted-fair tick accounts
        the submits to it; None (the default) is the shared default
        tenant, and the header is ignored by tenancy-oblivious
        gateways."""
        self.base_url = base_url.rstrip("/")
        self.overload_retries = int(overload_retries)
        self.auto_idempotency = bool(auto_idempotency)
        self.trace = bool(trace)
        self.tenant = tenant
        #: serialize()/register dedup (see _FnMemo)
        self._memo = _FnMemo()
        self.http = requests.Session()
        if tenant is not None:
            # session-wide: single, batch, and graph submits all carry it
            self.http.headers["X-Tenant-Id"] = str(tenant)
        # retry CONNECTION-establishment failures only (gateway restarting
        # behind a load balancer): nothing has reached the wire yet, so the
        # retry is safe even for POSTs — re-sending an /execute_function
        # whose first attempt may have been APPLIED would run the task
        # twice, so read/status errors are deliberately never retried
        adapter = HTTPAdapter(
            max_retries=Retry(
                total=None,
                connect=connect_retries,
                read=0,
                status=0,
                # 'other' (SSL/proxy errors) must be 0 too: urllib3 treats a
                # None counter as unbounded, which would retry a bad cert
                # forever instead of raising
                other=0,
                # window must outlast a COLD gateway start (interpreter +
                # aiohttp import is seconds), not just a socket blip.
                # urllib3 sleeps factor*2^(n-1) per retry: 0+1+2+4+8 ~= 15 s
                # worst case against a dead gateway; a measured live cold
                # start bridged at ~7 s
                backoff_factor=0.5,
            )
        )
        self.http.mount("http://", adapter)
        self.http.mount("https://", adapter)

    def _post_submit(self, url: str, body: dict) -> requests.Response:
        """POST a submit with overload backoff: 429/503 replies are
        retried up to ``overload_retries`` times, sleeping the server's
        ``Retry-After`` (or the ``OVERLOAD_BACKOFF`` schedule when
        absent) with multiplicative jitter. Safe for submits because
        every retried body carries an idempotency key (auto-minted when
        the caller gave none) — the re-send addresses the same task
        record. The final reject is returned (not raised): callers keep
        their raise_for_status semantics."""
        bo = Backoff(OVERLOAD_BACKOFF)
        for attempt in range(self.overload_retries + 1):
            r = self.http.post(url, json=body)
            if r.status_code not in (429, 503) or attempt == self.overload_retries:
                return r
            time.sleep(bo.next(hint=_retry_after_s(r, bo.peek())))
        return r

    # -- raw endpoints (wire format identical to SURVEY §0.1) --------------
    def register_payload(self, name: str, payload: str) -> str:
        r = self.http.post(
            f"{self.base_url}/register_function",
            json={"name": name, "payload": payload},
        )
        r.raise_for_status()
        return r.json()["function_id"]

    def execute_payload(
        self,
        function_id: str,
        payload: str,
        priority: int | None = None,
        cost: float | None = None,
        timeout: float | None = None,
        idempotency_key: str | None = None,
        deadline: float | None = None,
        trace_id: str | None = None,
        parent_span: str | None = None,
        speculative: bool = False,
        slo_class: str | None = None,
    ) -> str:
        return self._execute(
            function_id,
            payload,
            priority=priority,
            cost=cost,
            timeout=timeout,
            idempotency_key=idempotency_key,
            deadline=deadline,
            trace_id=trace_id,
            parent_span=parent_span,
            speculative=speculative,
            slo_class=slo_class,
        )["task_id"]

    def _execute(
        self,
        function_id: str,
        payload: str,
        priority: int | None = None,
        cost: float | None = None,
        timeout: float | None = None,
        idempotency_key: str | None = None,
        deadline: float | None = None,
        trace_id: str | None = None,
        parent_span: str | None = None,
        speculative: bool = False,
        slo_class: str | None = None,
    ) -> dict:
        """One submit; returns the gateway's parsed response body (the
        handle constructors read ``trace_id`` off it — present only when
        the gateway runs ``--trace`` and the record was actually
        created)."""
        body: dict = {"function_id": function_id, "payload": payload}
        if priority is not None:
            body["priority"] = priority
        if slo_class is not None:
            body["slo_class"] = slo_class
        if cost is not None:
            body["cost"] = cost
        if timeout is not None:
            body["timeout"] = timeout
        if deadline is not None:
            body["deadline"] = deadline
        if speculative:
            body["speculative"] = True
        if trace_id is None and self.trace:
            trace_id = new_trace_id()
        if trace_id is not None:
            body["trace_id"] = trace_id
        if parent_span is not None:
            body["parent_span"] = parent_span
        if idempotency_key is None and self.auto_idempotency:
            idempotency_key = uuid.uuid4().hex
        if idempotency_key is not None:
            body["idempotency_key"] = idempotency_key
        r = self._post_submit(f"{self.base_url}/execute_function", body)
        r.raise_for_status()
        return r.json()

    def status(self, task_id: str) -> str:
        r = self.http.get(f"{self.base_url}/status/{task_id}")
        r.raise_for_status()
        return r.json()["status"]

    def delete_task(self, task_id: str) -> None:
        r = self.http.delete(f"{self.base_url}/task/{task_id}")
        r.raise_for_status()

    def cancel(self, task_id: str, force: bool = False) -> bool:
        """POST /cancel/{task_id}; True when the task is now CANCELLED.
        409 (RUNNING — the gateway refuses) maps to False rather than an
        exception: "too late to cancel" is an expected answer, not an
        error. ``force=True`` sends ``{"force": true}`` — a RUNNING task
        gets a mid-run interrupt request (202, still False here; the
        record converges via the result path)."""
        r = self.http.post(
            f"{self.base_url}/cancel/{task_id}",
            json={"force": True} if force else None,
        )
        if r.status_code == 409:
            return False
        r.raise_for_status()
        return bool(r.json().get("cancelled"))

    def raw_result(self, task_id: str, wait: float = 0.0) -> tuple[str, str]:
        """``wait`` > 0 long-polls at the gateway (capped server-side). The
        HTTP read timeout is wait + margin — a parked request against a
        wedged gateway must fail instead of blocking past the caller's own
        deadline forever."""
        params = {"wait": wait} if wait > 0 else None
        r = self.http.get(
            f"{self.base_url}/result/{task_id}",
            params=params,
            timeout=(5.0, wait + 15.0),
        )
        r.raise_for_status()
        body = r.json()
        return body["status"], body["result"]

    def wait_many(
        self, task_ids: list[str], wait: float = 0.0
    ) -> tuple[dict[str, tuple[str, str]], list[str], list[str]]:
        """The multiplexed long-poll (``POST /results/wait``): many task
        ids, ONE parked request — replaces a serial per-id long-poll
        rotation when waiting on a batch. Returns ``(results, pending,
        unknown)`` where ``results`` maps each newly-terminal task_id to
        its raw ``(status, result)`` pair (feed :func:`_unwrap_terminal` /
        deserialize as with raw_result), ``pending`` lists watched ids
        still live, and ``unknown`` ids the gateway found no record for.
        The gateway replies as soon as ANY watched task is terminal, so
        callers loop over waves until ``pending`` empties."""
        r = self.http.post(
            f"{self.base_url}/results/wait",
            json={"task_ids": list(task_ids), "wait": wait},
            timeout=(5.0, wait + 15.0),
        )
        r.raise_for_status()
        body = r.json()
        results = {
            tid: (entry["status"], entry["result"])
            for tid, entry in body.get("results", {}).items()
        }
        return results, body.get("pending", []), body.get("unknown", [])

    # -- ergonomic layer ---------------------------------------------------
    def register(self, fn: Callable, name: str | None = None) -> str:
        """Register ``fn``, deduplicated twice over: the serialize() of an
        unchanged callable is memoized, and re-registering content this
        client already registered returns the existing function_id with
        no HTTP round trip at all (run()/map() in a loop stop paying a
        registration per call)."""
        payload = self._memo.serialize_fn(fn)
        function_id = self._memo.function_id_for(payload)
        if function_id is not None:
            return function_id
        function_id = self.register_payload(name or fn.__name__, payload)
        self._memo.note_registered(payload, function_id)
        return function_id

    def submit(self, function_id: str, *args: Any, **kwargs: Any) -> TaskHandle:
        payload = pack_params(*args, **kwargs)
        body = self._execute(function_id, payload)
        return TaskHandle(self, body["task_id"], body.get("trace_id"))

    def submit_with(
        self,
        function_id: str,
        args: tuple = (),
        kwargs: dict | None = None,
        *,
        priority: int | None = None,
        cost: float | None = None,
        timeout: float | None = None,
        idempotency_key: str | None = None,
        deadline: float | None = None,
        speculative: bool = False,
        slo_class: str | None = None,
    ) -> TaskHandle:
        """submit() plus scheduling hints. The hints can't ride submit()
        itself — its **kwargs belong to the remote function — so args/kwargs
        are explicit here. ``priority``: higher is admitted first under
        overload (FCFS within a class); ``cost``: estimated run-cost, used to
        pair expensive tasks with fast workers; ``timeout``: execution time
        budget in seconds, enforced inside the worker's pool child — the
        task FAILs with TaskTimeout instead of eating a process slot
        forever; ``deadline``: submit-TTL in seconds — a task still QUEUED
        this long after submit is shed to the terminal EXPIRED status
        (result() raises TaskExpiredError) instead of burning a worker
        slot on an answer nobody is waiting for; ``idempotency_key``: a
        client-chosen string making this submit safely retryable — a
        re-send (lost response, impatient caller) addresses the SAME task
        instead of running it twice (auto-minted per submit unless
        auto_idempotency=False); ``speculative``: declares the task IDEMPOTENT
        and hedge-eligible — a dispatcher running --speculate-mult may race a
        replica against a straggling execution (tpu_faas/spec; exactly one
        result is ever delivered, the store's first-wins write arbitrates).
        Only set it for functions safe to execute more than once.
        ``slo_class``: the task's declared SLO class (``interactive``/
        ``batch``/``default``, obs/attribution.py) — labels its latency
        samples and attribution counters when the observability plane
        runs with TPU_FAAS_OBS_CLASS=1; undeclared tasks default by
        priority sign."""
        payload = pack_params(*args, **(kwargs or {}))
        body = self._execute(
            function_id,
            payload,
            priority=priority,
            cost=cost,
            timeout=timeout,
            idempotency_key=idempotency_key,
            deadline=deadline,
            speculative=speculative,
            slo_class=slo_class,
        )
        return TaskHandle(self, body["task_id"], body.get("trace_id"))

    def submit_many(
        self,
        function_id: str,
        params_list: list[tuple[tuple, dict]],
        priorities: list[int] | None = None,
        costs: list[float] | None = None,
        timeouts: list[float] | None = None,
        idempotency_keys: list[str | None] | None = None,
        deadlines: list[float] | None = None,
        speculative: bool = False,
        slo_class: str | None = None,
    ) -> list[TaskHandle]:
        """Batch submit over ONE HTTP call (+ one pipelined store round
        trip): ``params_list`` holds (args, kwargs) pairs. N single submits
        cost N round trips on both hops — this is the bulk path.
        ``priorities``/``costs``/``timeouts``/``deadlines`` are optional
        scheduling-hint lists parallel to ``params_list``. Keys are
        auto-minted per item (unless auto_idempotency=False or the caller
        passed its own list), so an overload-rejected batch retries
        duplicate-safe."""
        body: dict = {
            "function_id": function_id,
            "payloads": [
                pack_params(*args, **kwargs) for args, kwargs in params_list
            ],
        }
        if priorities is not None:
            body["priorities"] = priorities
        if costs is not None:
            body["costs"] = costs
        if timeouts is not None:
            body["timeouts"] = timeouts
        if deadlines is not None:
            body["deadlines"] = deadlines
        if speculative:
            # one flag for the whole batch: the idempotency promise is
            # per-call (tpu_faas/spec hedge eligibility)
            body["speculative"] = True
        if slo_class is not None:
            # one declared SLO class for the whole batch (the gateway
            # applies it element-wise), matching the wire contract
            body["slo_class"] = slo_class
        if idempotency_keys is None and self.auto_idempotency:
            idempotency_keys = [uuid.uuid4().hex for _ in params_list]
        if idempotency_keys is not None:
            body["idempotency_keys"] = idempotency_keys
        if self.trace:
            body["trace_ids"] = [new_trace_id() for _ in params_list]
        r = self._post_submit(f"{self.base_url}/execute_batch", body)
        r.raise_for_status()
        out = r.json()
        # the gateway's echo is authoritative: null for dedup hits (their
        # records carry the claim winner's trace), absent with tracing off
        trace_ids = out.get("trace_ids") or [None] * len(out["task_ids"])
        return [
            TaskHandle(self, tid, trace)
            for tid, trace in zip(out["task_ids"], trace_ids)
        ]

    def graph(self) -> "GraphBuilder":
        """Start a task-graph submission: ``g = client.graph()``, then
        ``h = g.call(fn, x)``, ``g.call(fn2, y, after=[h])``, ...,
        ``g.submit()``. Nodes run only after everything they depend on
        COMPLETED; a failed/cancelled/expired dependency fails its
        dependents without running them (result() raises
        :class:`TaskDependencyError`)."""
        return GraphBuilder(self)

    def execute_graph(self, nodes: list[dict]) -> dict:
        """Raw graph submit (wire format of POST /execute_graph); the
        ergonomic layer is :meth:`graph`."""
        r = self._post_submit(f"{self.base_url}/execute_graph", {"nodes": nodes})
        r.raise_for_status()
        return r.json()

    def run(
        self, fn: Callable, *args: Any, timeout: float = 60.0, **kwargs: Any
    ) -> Any:
        """Register + submit + wait, in one call."""
        return self.submit(self.register(fn), *args, **kwargs).result(timeout)

    def map(
        self,
        fn: Callable,
        iterable,
        timeout: float = 120.0,
        poll_interval: float = 0.01,
    ) -> list[Any]:
        """Pool.map-style batch: register once, submit every item, then wait
        on the whole wave with ONE parked multiplexed request per round
        (``wait_many`` — the reference's clients hand-roll a serial poll
        rotation instead, test_client.py:109-128); results come back in
        input order, and any FAILED task raises its TaskFailedError. A
        pre-express gateway (no /results/wait route) degrades to the
        serial long-poll rotation."""
        fid = self.register(fn)
        handles = [self.submit(fid, item) for item in iterable]
        deadline = time.monotonic() + timeout
        results: dict[int, Any] = {}
        pending = set(range(len(handles)))
        index_of = {h.task_id: i for i, h in enumerate(handles)}
        multiplex = True
        while pending:
            wait = min(2.0, max(0.0, deadline - time.monotonic()))
            t_req = time.monotonic()
            if multiplex:
                try:
                    got, _live, unknown = self.wait_many(
                        [handles[i].task_id for i in sorted(pending)],
                        wait=wait,
                    )
                except requests.HTTPError as exc:
                    if (
                        exc.response is not None
                        and exc.response.status_code == 404
                    ):
                        multiplex = False  # older gateway: serial rotation
                        continue
                    raise
                for tid, (status, payload) in got.items():
                    done, value = _unwrap_terminal(tid, status, payload)
                    if done:
                        results[index_of[tid]] = value
                        pending.discard(index_of[tid])
                if unknown:
                    # a watched record vanished mid-wait (swept/deleted):
                    # the serial rotation surfaced this as an immediate
                    # 404 — burning the remaining timeout on ids that can
                    # never resolve would hide which task died and why.
                    # (Delivered results above are consumed first: an id
                    # can never be both.)
                    raise requests.HTTPError(
                        f"task record(s) gone while waiting: {unknown}"
                    )
            else:
                first = min(pending)
                for i in sorted(pending):
                    status, payload = self.raw_result(
                        handles[i].task_id, wait=wait if i == first else 0.0
                    )
                    done, value = _unwrap_terminal(
                        handles[i].task_id, status, payload
                    )
                    if done:
                        results[i] = value
                        pending.discard(i)
            if pending:
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"{len(pending)} of {len(handles)} tasks still "
                        f"running after {timeout}s"
                    )
                if wait <= 0 or time.monotonic() - t_req < 0.5 * wait:
                    # the server never parked (deadline imminent, or a
                    # draining/wait-oblivious gateway replied instantly):
                    # pace the residual spin; parked rounds need no
                    # client pacing
                    time.sleep(poll_interval)
        return [results[i] for i in range(len(handles))]


# -- task-graph builder ------------------------------------------------------


@dataclass
class GraphNode:
    """One node of a graph submission: a dependency reference before
    submit() (pass it in another call's ``after=[...]``), a task handle
    after (``task_id`` assigned; result()/status()/cancel() delegate to a
    :class:`TaskHandle`). A poisoned node's result() raises
    :class:`TaskDependencyError` naming the failed parent."""

    builder: "GraphBuilder"
    index: int
    task_id: str | None = None
    trace_id: str | None = None

    @property
    def handle(self) -> TaskHandle:
        if self.task_id is None:
            raise RuntimeError(
                "graph not submitted yet: call GraphBuilder.submit() first"
            )
        return TaskHandle(self.builder.client, self.task_id, self.trace_id)

    def status(self) -> str:
        return self.handle.status()

    def result(self, timeout: float = 60.0, poll_interval: float = 0.01):
        return self.handle.result(timeout, poll_interval)

    def cancel(self, force: bool = False) -> bool:
        return self.handle.cancel(force=force)

    def forget(self) -> None:
        self.handle.forget()


class GraphBuilder:
    """Accumulate a DAG locally, submit it in ONE call::

        g = client.graph()
        parts = [g.call(extract, shard) for shard in shards]   # fan-out
        merged = g.call(merge, after=parts)                    # fan-in
        g.submit()
        total = merged.result(timeout=120.0)

    ``call`` accepts a callable (registered through the client's dedup
    memo — N calls of one function cost one registration) or a
    function_id string, plus the usual scheduling hints. ``after`` lists
    the GraphNodes this node depends on; the gateway validates
    acyclicity, charges admission for the whole graph up front, and the
    store's promotion plane runs the frontier from there. submit() may be
    called once; it returns the nodes in call order."""

    def __init__(self, client: FaaSClient) -> None:
        self.client = client
        self._nodes: list[dict] = []
        self._handles: list[GraphNode] = []
        self._submitted = False

    def call(
        self,
        fn: "Callable | str",
        *args: Any,
        after: "list[GraphNode] | tuple[GraphNode, ...]" = (),
        priority: int | None = None,
        cost: float | None = None,
        timeout: float | None = None,
        deadline: float | None = None,
        **kwargs: Any,
    ) -> GraphNode:
        if self._submitted:
            raise RuntimeError("graph already submitted")
        function_id = fn if isinstance(fn, str) else self.client.register(fn)
        deps: list[int] = []
        for dep in after:
            if not isinstance(dep, GraphNode) or dep.builder is not self:
                raise ValueError(
                    "'after' entries must be GraphNodes from this builder"
                )
            if dep.index not in deps:
                deps.append(dep.index)
        node: dict = {
            "function_id": function_id,
            "payload": pack_params(*args, **kwargs),
            "depends_on": deps,
        }
        if priority is not None:
            node["priority"] = priority
        if cost is not None:
            node["cost"] = cost
        if timeout is not None:
            node["timeout"] = timeout
        if deadline is not None:
            node["deadline"] = deadline
        handle = GraphNode(self, len(self._nodes))
        self._nodes.append(node)
        self._handles.append(handle)
        return handle

    def submit(self) -> list[GraphNode]:
        if self._submitted:
            raise RuntimeError("graph already submitted")
        out = self.client.execute_graph(self._nodes)
        self._submitted = True
        trace_ids = out.get("trace_ids") or [None] * len(out["task_ids"])
        for handle, task_id, trace in zip(
            self._handles, out["task_ids"], trace_ids
        ):
            handle.task_id = task_id
            handle.trace_id = trace
        return list(self._handles)
