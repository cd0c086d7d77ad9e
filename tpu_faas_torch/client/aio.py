"""Async client SDK (aiohttp) — the concurrent-submitter counterpart of
:mod:`tpu_faas.client.sdk`.

Same wire format as the sync client (SURVEY §0.1 endpoints + the batch
extension), but every call is a coroutine and result polling multiplexes on
one event loop — a single process can drive thousands of outstanding tasks
without a thread per poll. The sync ``FaaSClient`` remains the default for
scripts; this is for gateway-scale load generators and services embedding
the client in an async stack.
"""

from __future__ import annotations

import asyncio
import contextlib
import uuid
from dataclasses import dataclass
from typing import Any, Callable

import aiohttp

from tpu_faas_torch.client.sdk import (
    OVERLOAD_BACKOFF,  # shared 429/503 schedule: sync and async must agree
    TaskCancelledError,
    TaskDependencyError,
    TaskExpiredError,
    TaskFailedError,
    _FnMemo,  # shared serialize()/register dedup: sync and async agree
    _retry_after_s,  # shared Retry-After parsing: sync and async must agree
    _unwrap_terminal,  # shared terminal protocol (incl. dep_failed parsing)
)
from tpu_faas_torch.core.executor import pack_params
from tpu_faas_torch.obs.tracectx import new_trace_id
from tpu_faas_torch.utils.backoff import Backoff, BackoffPolicy

#: Connection-establishment retries: deterministic doubling from 0.3 s
#: (no jitter — these are budget-clamped by the caller's deadline, and
#: a lone client reconnecting to a restarting gateway has no thundering
#: herd to spread).
CONNECT_BACKOFF = BackoffPolicy(
    floor_s=0.3, factor=2.0, cap_s=30.0, jitter_lo=1.0, jitter_hi=1.0
)


@dataclass
class AsyncTaskHandle:
    client: "AsyncFaaSClient"
    task_id: str
    #: distributed trace id of this submit (trace-enabled clients against
    #: a --trace gateway); None otherwise — same contract as the sync
    #: TaskHandle.trace_id
    trace_id: str | None = None

    async def status(self) -> str:
        async with self.client.request(
            "GET", f"{self.client.base_url}/status/{self.task_id}"
        ) as r:
            r.raise_for_status()
            return (await r.json())["status"]

    async def result(
        self, timeout: float = 60.0, poll_interval: float = 0.01
    ) -> Any:
        """Push-based await: the request PARKS at the gateway (``?wait=``)
        and is woken by the result's announce — against an express-lane
        dispatcher the gateway replies straight from the forwarded
        payload, so ``await handle.result()`` never polls anything.
        ``poll_interval`` paces only the degenerate wait<=0 rounds right
        at the deadline — and any non-terminal reply that came back in
        well under the requested wait (a draining or wait-oblivious
        gateway never parked; pacing there prevents a zero-delay request
        hot-spin). A parked round was its own pacing, and sleeping after
        it would put a client-side floor under every delivery."""
        loop = asyncio.get_running_loop()
        deadline = loop.time() + timeout
        while True:
            remaining = max(0.0, min(deadline - loop.time(), 5.0))
            t_req = loop.time()
            async with self.client.request(
                "GET",
                f"{self.client.base_url}/result/{self.task_id}",
                # retry sleeps AND the parked request itself are bounded by
                # the caller's deadline: a dark or wedged gateway must not
                # block result(timeout=T) far past T
                retry_budget=max(0.5, deadline - loop.time()),
                params={"wait": remaining} if remaining > 0 else None,
                timeout=aiohttp.ClientTimeout(total=remaining + 15.0),
            ) as r:
                r.raise_for_status()
                body = await r.json()
            done, value = _unwrap_terminal(
                self.task_id, body["status"], body["result"]
            )
            if done:
                return value
            if loop.time() > deadline:
                raise TimeoutError(
                    f"task {self.task_id} still {body['status']} "
                    f"after {timeout}s"
                )
            if remaining <= 0 or loop.time() - t_req < 0.5 * remaining:
                await asyncio.sleep(poll_interval)

    async def forget(self) -> None:
        """Delete this task's store record once terminal."""
        await self.client.delete_task(self.task_id)

    async def cancel(self, force: bool = False) -> bool:
        """Best-effort cancel; True = the record now reads CANCELLED,
        which a lost dispatch race can still overwrite. ``force=True``
        asks a RUNNING task's worker to interrupt it mid-run (async; see
        sync TaskHandle.cancel for the full contract)."""
        return await self.client.cancel(self.task_id, force=force)


class AsyncFaaSClient:
    """Use as an async context manager:

        async with AsyncFaaSClient(url) as client:
            fid = await client.register(fn)
            handles = await client.submit_many(fid, params)
            values = await asyncio.gather(*(h.result() for h in handles))
    """

    def __init__(
        self,
        base_url: str = "http://127.0.0.1:8000",
        connect_retries: int = 5,
        overload_retries: int = 4,
        auto_idempotency: bool = True,
        trace: bool = False,
        tenant: str | None = None,
    ) -> None:
        """``overload_retries``/``auto_idempotency``: same overload
        contract as the sync FaaSClient — 429/503 submit rejects retry
        honoring ``Retry-After`` with jittered exponential backoff, and
        every submit carries an idempotency key (auto-minted unless the
        caller supplied one or disabled it) so retries are
        duplicate-safe. ``trace``: mint a distributed trace id per submit
        and send it along — same contract as the sync FaaSClient.
        ``tenant``: sent as ``X-Tenant-Id`` on every request (same
        contract as the sync FaaSClient's tenant)."""
        self.base_url = base_url.rstrip("/")
        self.connect_retries = connect_retries
        self.overload_retries = int(overload_retries)
        self.auto_idempotency = bool(auto_idempotency)
        self.trace = bool(trace)
        self.tenant = tenant
        #: serialize()/register dedup, shared shape with the sync SDK
        self._memo = _FnMemo()
        self._http: aiohttp.ClientSession | None = None

    @contextlib.asynccontextmanager
    async def request(
        self,
        method: str,
        url: str,
        retry_budget: float | None = None,
        retry_overload: bool = False,
        **kw,
    ):
        """All SDK HTTP rides through here: CONNECTION-establishment
        failures retry with backoff (gateway restarting behind a stable
        address — mirrors the sync client's adapter). Nothing has reached
        the wire on a connector error, so the retry is safe even for
        POSTs; errors after the request is sent are never retried —
        EXCEPT 429/503 overload rejects when ``retry_overload`` is set
        (submit paths only, whose bodies carry idempotency keys): those
        sleep the server's Retry-After (jittered) and re-send, up to
        ``overload_retries`` times.

        ``retry_budget`` caps the total seconds spent in retry sleeps —
        deadline-bound callers (AsyncTaskHandle.result) pass their
        remaining time so the retry loop can't blow past their timeout."""
        loop = asyncio.get_running_loop()
        give_up_at = (
            loop.time() + retry_budget if retry_budget is not None else None
        )
        connect_bo = Backoff(CONNECT_BACKOFF)
        overload_bo = Backoff(OVERLOAD_BACKOFF)
        while True:
            try:
                async with self.http.request(method, url, **kw) as r:
                    if (
                        retry_overload
                        and r.status in (429, 503)
                        and overload_bo.attempt < self.overload_retries
                    ):
                        await asyncio.sleep(
                            overload_bo.next(
                                hint=_retry_after_s(r, overload_bo.peek()),
                                clamp=(
                                    give_up_at - loop.time()
                                    if give_up_at is not None
                                    else None
                                ),
                            )
                        )
                        continue
                    yield r
                return
            except aiohttp.ClientConnectorError:
                if connect_bo.attempt >= self.connect_retries:
                    raise
                if give_up_at is not None:
                    remaining = give_up_at - loop.time()
                    if remaining <= 0:
                        raise
                    await asyncio.sleep(connect_bo.next(clamp=remaining))
                else:
                    await asyncio.sleep(connect_bo.next())

    @property
    def http(self) -> aiohttp.ClientSession:
        if self._http is None:
            raise RuntimeError(
                "AsyncFaaSClient must be entered first: "
                "`async with AsyncFaaSClient(url) as client: ...`"
            )
        return self._http

    async def __aenter__(self) -> "AsyncFaaSClient":
        headers = (
            {"X-Tenant-Id": str(self.tenant)}
            if self.tenant is not None
            else None
        )
        self._http = aiohttp.ClientSession(headers=headers)
        return self

    async def __aexit__(self, *exc: object) -> None:
        if self._http is not None:
            await self._http.close()
            self._http = None

    async def register(self, fn: Callable, name: str | None = None) -> str:
        # serialization is CPU work: off the event loop, like all packing
        # (the memo makes the repeat case a dict probe — see _FnMemo)
        loop = asyncio.get_running_loop()
        payload = await loop.run_in_executor(None, self._memo.serialize_fn, fn)
        function_id = self._memo.function_id_for(payload)
        if function_id is not None:
            return function_id
        async with self.request(
            "POST",
            f"{self.base_url}/register_function",
            json={"name": name or fn.__name__, "payload": payload},
        ) as r:
            r.raise_for_status()
            function_id = (await r.json())["function_id"]
        self._memo.note_registered(payload, function_id)
        return function_id

    async def submit(
        self, function_id: str, *args: Any, **kwargs: Any
    ) -> AsyncTaskHandle:
        loop = asyncio.get_running_loop()
        payload = await loop.run_in_executor(
            None, lambda: pack_params(*args, **kwargs)
        )
        body = {"function_id": function_id, "payload": payload}
        if self.trace:
            body["trace_id"] = new_trace_id()
        if self.auto_idempotency:
            body["idempotency_key"] = uuid.uuid4().hex
        async with self.request(
            "POST",
            f"{self.base_url}/execute_function",
            retry_overload=True,
            json=body,
        ) as r:
            r.raise_for_status()
            out = await r.json()
            return AsyncTaskHandle(self, out["task_id"], out.get("trace_id"))

    async def submit_with(
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
    ) -> AsyncTaskHandle:
        """submit() plus scheduling hints (mirrors the sync SDK): higher
        ``priority`` is admitted first under overload; ``cost`` is the
        estimated run-cost used for task<->worker pairing; ``timeout`` is
        the execution budget enforced inside the worker's pool child;
        ``deadline`` is a submit-TTL in seconds (still QUEUED past it →
        terminal EXPIRED, result() raises TaskExpiredError);
        ``idempotency_key`` makes the submit safely retryable (a re-send
        addresses the same task instead of running it twice; auto-minted
        unless auto_idempotency=False); ``speculative`` declares the task
        IDEMPOTENT and hedge-eligible (tpu_faas/spec) — only set it for
        functions safe to execute more than once; ``slo_class`` declares
        the task's SLO class (interactive/batch/default,
        obs/attribution.py) for per-class latency accounting when the
        observability plane runs with TPU_FAAS_OBS_CLASS=1."""
        loop = asyncio.get_running_loop()
        payload = await loop.run_in_executor(
            None, lambda: pack_params(*args, **(kwargs or {}))
        )
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
        if self.trace:
            body["trace_id"] = new_trace_id()
        if idempotency_key is None and self.auto_idempotency:
            idempotency_key = uuid.uuid4().hex
        if idempotency_key is not None:
            body["idempotency_key"] = idempotency_key
        async with self.request(
            "POST",
            f"{self.base_url}/execute_function",
            retry_overload=True,
            json=body,
        ) as r:
            r.raise_for_status()
            out = await r.json()
            return AsyncTaskHandle(self, out["task_id"], out.get("trace_id"))

    async def submit_many(
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
    ) -> list[AsyncTaskHandle]:
        # dill-packing thousands of payloads inline would stall the event
        # loop (and every concurrently polling handle) — do it in a worker
        # thread
        loop = asyncio.get_running_loop()
        payloads = await loop.run_in_executor(
            None,
            lambda: [
                pack_params(*args, **kwargs) for args, kwargs in params_list
            ],
        )
        body: dict = {"function_id": function_id, "payloads": payloads}
        if priorities is not None:
            body["priorities"] = priorities
        if costs is not None:
            body["costs"] = costs
        if timeouts is not None:
            body["timeouts"] = timeouts
        if deadlines is not None:
            body["deadlines"] = deadlines
        if speculative:
            body["speculative"] = True
        if slo_class is not None:
            # one declared class for the whole batch, applied element-wise
            # by the gateway (same wire contract as the sync SDK)
            body["slo_class"] = slo_class
        if idempotency_keys is None and self.auto_idempotency:
            idempotency_keys = [uuid.uuid4().hex for _ in params_list]
        if idempotency_keys is not None:
            body["idempotency_keys"] = idempotency_keys
        if self.trace:
            body["trace_ids"] = [new_trace_id() for _ in params_list]
        async with self.request(
            "POST",
            f"{self.base_url}/execute_batch",
            retry_overload=True,
            json=body,
        ) as r:
            r.raise_for_status()
            out = await r.json()
            trace_ids = out.get("trace_ids") or [None] * len(out["task_ids"])
            return [
                AsyncTaskHandle(self, tid, trace)
                for tid, trace in zip(out["task_ids"], trace_ids)
            ]

    async def wait_many(
        self, task_ids: list[str], wait: float = 0.0
    ) -> tuple[dict[str, tuple[str, str]], list[str], list[str]]:
        """The multiplexed long-poll (``POST /results/wait``), async twin
        of the sync SDK's wait_many: many task ids, ONE parked request;
        returns ``(results, pending, unknown)`` with ``results`` mapping
        newly-terminal ids to raw ``(status, result)`` pairs. The gateway
        replies as soon as ANY watched task is terminal — loop over waves
        until ``pending`` empties."""
        async with self.request(
            "POST",
            f"{self.base_url}/results/wait",
            json={"task_ids": list(task_ids), "wait": wait},
            timeout=aiohttp.ClientTimeout(total=wait + 15.0),
        ) as r:
            r.raise_for_status()
            body = await r.json()
        results = {
            tid: (entry["status"], entry["result"])
            for tid, entry in body.get("results", {}).items()
        }
        return results, body.get("pending", []), body.get("unknown", [])

    async def delete_task(self, task_id: str) -> None:
        """Free a terminal task's store record (409 while it is live)."""
        async with self.request(
            "DELETE", f"{self.base_url}/task/{task_id}"
        ) as r:
            r.raise_for_status()

    async def cancel(self, task_id: str, force: bool = False) -> bool:
        """POST /cancel/{task_id}; True when the task is now CANCELLED.
        409 (RUNNING) maps to False — "too late" is an answer, not an
        error. ``force=True`` requests a mid-run interrupt of a RUNNING
        task (202, still False; sync FaaSClient.cancel)."""
        async with self.request(
            "POST",
            f"{self.base_url}/cancel/{task_id}",
            json={"force": True} if force else None,
        ) as r:
            if r.status == 409:
                return False
            r.raise_for_status()
            return bool((await r.json()).get("cancelled"))

    async def run(
        self, fn: Callable, *args: Any, timeout: float = 60.0, **kwargs: Any
    ) -> Any:
        handle = await self.submit(await self.register(fn), *args, **kwargs)
        return await handle.result(timeout)

    def graph(self) -> "AsyncGraphBuilder":
        """Start a task-graph submission (async twin of
        FaaSClient.graph()): ``g.call(...)`` stays synchronous and cheap
        (callables register lazily at submit); ``await g.submit()`` posts
        the whole DAG in one call."""
        return AsyncGraphBuilder(self)

    async def execute_graph(self, nodes: list[dict]) -> dict:
        """Raw graph submit (wire format of POST /execute_graph)."""
        async with self.request(
            "POST",
            f"{self.base_url}/execute_graph",
            retry_overload=True,
            json={"nodes": nodes},
        ) as r:
            r.raise_for_status()
            return await r.json()


@dataclass
class AsyncGraphNode:
    """One node of an async graph submission — a dependency reference
    before submit(), an :class:`AsyncTaskHandle` delegate after. A
    dep-poisoned node's ``await result()`` raises
    :class:`TaskDependencyError` naming the failed parent."""

    builder: "AsyncGraphBuilder"
    index: int
    task_id: str | None = None
    trace_id: str | None = None

    @property
    def handle(self) -> AsyncTaskHandle:
        if self.task_id is None:
            raise RuntimeError(
                "graph not submitted yet: await GraphBuilder.submit() first"
            )
        return AsyncTaskHandle(self.builder.client, self.task_id, self.trace_id)

    async def status(self) -> str:
        return await self.handle.status()

    async def result(
        self, timeout: float = 60.0, poll_interval: float = 0.01
    ) -> Any:
        return await self.handle.result(timeout, poll_interval)

    async def cancel(self, force: bool = False) -> bool:
        return await self.handle.cancel(force=force)


class AsyncGraphBuilder:
    """The sync GraphBuilder's async twin. ``call`` is synchronous (graph
    assembly is pure bookkeeping — awaiting per node would serialize a
    wide fan-out for nothing); callables are registered at submit() time
    through the shared dedup memo, one HTTP round per distinct function."""

    def __init__(self, client: AsyncFaaSClient) -> None:
        self.client = client
        #: (fn-or-id, args, kwargs, deps, hints) per node until submit
        self._calls: list[tuple] = []
        self._handles: list[AsyncGraphNode] = []
        self._submitted = False

    def call(
        self,
        fn: "Callable | str",
        *args: Any,
        after: "list[AsyncGraphNode] | tuple[AsyncGraphNode, ...]" = (),
        priority: int | None = None,
        cost: float | None = None,
        timeout: float | None = None,
        deadline: float | None = None,
        **kwargs: Any,
    ) -> AsyncGraphNode:
        if self._submitted:
            raise RuntimeError("graph already submitted")
        deps: list[int] = []
        for dep in after:
            if not isinstance(dep, AsyncGraphNode) or dep.builder is not self:
                raise ValueError(
                    "'after' entries must be AsyncGraphNodes from this builder"
                )
            if dep.index not in deps:
                deps.append(dep.index)
        hints = {
            "priority": priority,
            "cost": cost,
            "timeout": timeout,
            "deadline": deadline,
        }
        handle = AsyncGraphNode(self, len(self._calls))
        self._calls.append((fn, args, kwargs, deps, hints))
        self._handles.append(handle)
        return handle

    async def submit(self) -> list[AsyncGraphNode]:
        if self._submitted:
            raise RuntimeError("graph already submitted")
        loop = asyncio.get_running_loop()
        nodes: list[dict] = []
        for fn, args, kwargs, deps, hints in self._calls:
            function_id = (
                fn if isinstance(fn, str) else await self.client.register(fn)
            )
            payload = await loop.run_in_executor(
                None, lambda a=args, k=kwargs: pack_params(*a, **k)
            )
            node: dict = {
                "function_id": function_id,
                "payload": payload,
                "depends_on": deps,
            }
            for key, value in hints.items():
                if value is not None:
                    node[key] = value
            nodes.append(node)
        out = await self.client.execute_graph(nodes)
        self._submitted = True
        trace_ids = out.get("trace_ids") or [None] * len(out["task_ids"])
        for handle, task_id, trace in zip(
            self._handles, out["task_ids"], trace_ids
        ):
            handle.task_id = task_id
            handle.trace_id = trace
        return list(self._handles)


__all__ = [
    "AsyncFaaSClient",
    "AsyncGraphBuilder",
    "AsyncGraphNode",
    "AsyncTaskHandle",
    "TaskCancelledError",
    "TaskDependencyError",
    "TaskExpiredError",
    "TaskFailedError",
]
