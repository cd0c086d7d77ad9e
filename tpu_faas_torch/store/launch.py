"""Store factory + in-thread server launcher.

URL scheme used across CLIs and configs:

- ``memory://``            in-process MemoryStore (single-process modes/tests)
- ``resp://host:port``     TCP client to any RESP store server (ours or Redis)
- ``resp://h1:p1,h2:p2``   ordered FAILOVER endpoint list (primary first,
  replicas after): the client settles on whichever endpoint holds the
  writable primary role and follows promotions (store/replication.py)
- ``resp://h1:p1;h2:p2``   SHARDED control plane (store/sharding.py): a
  ``;``-separated shard list builds a ShardedStore routing the task
  keyspace over the shards by consistent hashing. Each shard may itself
  be a ``,``-separated failover ring (``resp://p1:1,r1:2;p2:3,r2:4`` =
  two shards, each a primary+replica pair), so per-shard HA composes.
  ``memory://fresh;fresh`` shards over private in-process stores (tests).

`start_store_thread` runs the Python asyncio server inside a daemon thread and
returns a handle — used by tests and by single-machine deployments that don't
want a separate store process. Production path is the native C++ server
(tpu_faas.store.native) or any Redis-compatible endpoint.
"""

from __future__ import annotations

import asyncio
import threading
from dataclasses import dataclass
from urllib.parse import urlparse

from tpu_faas_torch.store.base import TaskStore
from tpu_faas_torch.store.client import RespStore
from tpu_faas_torch.store.memory import MemoryStore
from tpu_faas_torch.store.server import StoreServer

_SHARED_MEMORY_STORE: MemoryStore | None = None
_SHARED_LOCK = threading.Lock()


def make_store(
    url: str, owned_shards: list[int] | None = None, binbatch: bool = False
) -> TaskStore:
    """Create a TaskStore from a URL.

    ``memory://`` returns a process-wide shared MemoryStore (so a gateway and
    dispatcher running in one process see the same tasks); ``memory://fresh``
    returns a private instance.

    A ``;`` in the URL selects the sharded form (see module docstring):
    ``owned_shards`` then scopes the handle's consumption surface —
    announce subscriptions, rescans, announce replay — to those shard
    indices (a dispatcher owning a slice of the fleet); ``None`` consumes
    every shard (gateways, clients).

    ``binbatch`` (the dispatcher's ``--store-binbatch`` knob) asks RESP
    clients to negotiate the binary-batch command surface per connection
    (store/client.py); off sends zero extra bytes, and non-RESP backends
    ignore it entirely.
    """
    if ";" in url:
        from tpu_faas_torch.store.sharding import ShardedStore

        scheme, sep, rest = url.partition("://")
        if not sep:
            raise ValueError(f"unknown store url scheme: {url!r}")
        groups = [g for g in rest.split(";") if g]
        if len(groups) < 2:
            raise ValueError(
                f"sharded store url needs >= 2 ';'-separated shards: {url!r}"
            )
        if scheme == "memory":
            # sharding over ONE shared dict would be no sharding at all:
            # every memory shard is a private instance
            stores: list[TaskStore] = [
                MemoryStore() for _ in groups
            ]
        else:
            stores = [
                make_store(f"{scheme}://{group}", binbatch=binbatch)
                for group in groups
            ]
        return ShardedStore(stores, owned_shards=owned_shards)
    if owned_shards is not None:
        raise ValueError(
            "owned_shards needs a sharded (';'-separated) store url"
        )
    parsed = urlparse(url)
    if parsed.scheme == "memory":
        if parsed.netloc == "fresh" or parsed.path == "/fresh":
            return MemoryStore()
        global _SHARED_MEMORY_STORE
        with _SHARED_LOCK:
            if _SHARED_MEMORY_STORE is None:
                _SHARED_MEMORY_STORE = MemoryStore()
            return _SHARED_MEMORY_STORE
    if parsed.scheme in ("resp", "redis", "tcp"):
        if "," in parsed.netloc:
            # ordered failover list: "h1:p1,h2:p2[,...]" — urlparse can't
            # digest the comma form, so split it by hand
            from tpu_faas_torch.store.replication import parse_endpoint

            endpoints = [
                parse_endpoint(spec)
                for spec in parsed.netloc.split(",")
                if spec
            ]
            return RespStore(endpoints=endpoints, binbatch=binbatch)
        host = parsed.hostname or "127.0.0.1"
        port = parsed.port or 6380
        return RespStore(host, port, binbatch=binbatch)
    raise ValueError(f"unknown store url scheme: {url!r}")


@dataclass
class StoreServerHandle:
    server: StoreServer
    thread: threading.Thread
    loop: asyncio.AbstractEventLoop

    @property
    def port(self) -> int:
        return self.server.port

    @property
    def url(self) -> str:
        return f"resp://{self.server.host}:{self.server.port}"

    def stop(self) -> None:
        if self.loop.is_closed():  # idempotent: already stopped
            return

        async def _stop() -> None:
            await self.server.stop()

        try:
            fut = asyncio.run_coroutine_threadsafe(_stop(), self.loop)
            fut.result(timeout=5)
        except Exception:
            pass
        self.thread.join(timeout=5)


def start_store_thread(
    host: str = "127.0.0.1",
    port: int = 0,
    snapshot_path: str | None = None,
    autosave_interval: float = 0.0,
    replica_of: tuple[str, int] | str | None = None,
    epoch: int = 0,
    health_port: int | None = None,
) -> StoreServerHandle:
    """Start the Python store server in a daemon thread; returns once bound.
    ``replica_of`` starts it as a read-only replica tailing that primary
    (promote with ``RespStore.promote()``); ``epoch`` seeds the fencing
    epoch for restarts of previously-promoted stores; ``health_port``
    serves the HTTP /healthz //readyz probe pair (0 picks a free port,
    resolved on ``handle.server.health_port``)."""
    server = StoreServer(
        host,
        port,
        snapshot_path=snapshot_path,
        autosave_interval=autosave_interval,
        replica_of=replica_of,
        epoch=epoch,
        health_port=health_port,
    )
    started = threading.Event()
    loop_holder: dict[str, asyncio.AbstractEventLoop] = {}

    def run() -> None:
        loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)
        loop_holder["loop"] = loop

        async def main() -> None:
            await server.start()
            started.set()
            await server.serve_forever()

        try:
            loop.run_until_complete(main())
        finally:
            loop.close()

    thread = threading.Thread(target=run, name="tpu-faas-store", daemon=True)
    thread.start()
    if not started.wait(timeout=10):
        raise RuntimeError("store server failed to start")
    return StoreServerHandle(server=server, thread=thread, loop=loop_holder["loop"])


def find_redis_server() -> str | None:
    """Locate a real redis-server binary for the drop-in-Redis interop
    leg: $PATH first, then the checksum-pinned local build produced by
    ``native/build_redis.sh`` (environments without egress drop the
    pinned tarball and build once). One helper shared by
    tests/test_redis_compat.py and bench.py's ``redis_interop`` artifact
    field, so the two can never disagree about whether the real leg
    runs."""
    import os
    import shutil

    from tpu_faas_torch.store.native import NATIVE_DIR

    found = shutil.which("redis-server")
    if found:
        return found
    local = os.path.join(NATIVE_DIR, "redis-server")
    return local if os.access(local, os.X_OK) else None
