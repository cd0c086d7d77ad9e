"""Python asyncio task-store server speaking the RESP2 subset.

This is the portable fallback for the native C++ server (native/store_server.cpp);
both expose the identical protocol, so `RespStore` clients and a real Redis are
interchangeable. One asyncio task per connection; state is a plain dict guarded
by the event loop's single-threadedness.

Supported commands (the set the framework + the reference's usage of Redis
require): PING, SELECT (accepted, ignored — the reference pins db=1,
task_dispatcher.py:32), HSET, HSETNX, HGET, HEXISTS, HMGET, HGETALL, DEL, KEYS, PUBLISH, SUBSCRIBE,
UNSUBSCRIBE, FLUSHDB, SAVE, QUIT, SHUTDOWN.

Checkpoint/resume: ``--snapshot PATH`` loads PATH at startup and saves to it
on SAVE (no path argument), on SHUTDOWN/stop, and every ``--autosave`` seconds
while dirty. Format: tpu_faas/store/snapshot.py (replayable RESP command log
with DEL records, shared with the native server and the replication sync).

High availability: ``--replica-of host:port`` starts this server as a
read-only replica tailing that primary's write stream
(tpu_faas/store/replication.py): full snapshot sync, then every mutating
command in order, replicated PUBLISHes fanning out to local subscribers
and landing in the bounded announce ring that backs ``REPLAY``. A replica
accepts writes only after an explicit ``PROMOTE`` (which bumps the fencing
epoch); ``--epoch N`` restarts a previously-promoted store with its epoch
intact.

Run: ``python -m tpu_faas.store.server --port 6380``.
"""

from __future__ import annotations

import argparse
import asyncio
import fnmatch
import signal
from typing import Iterable

from tpu_faas_torch.store import resp, snapshot
from tpu_faas_torch.store.replication import (
    FENCED_ERR,
    MUTATING_COMMANDS,
    READONLY_ERR,
    AnnounceRing,
    ReplicaLink,
    ReplicationState,
    parse_endpoint,
)

#: Bound on the deleted-keys set carried into the next snapshot: the
#: tombstones exist so a checkpoint can EXPRESS deletions (snapshot.py);
#: past the cap the oldest are dropped — they are then simply absent from
#: the dump, which is the pre-tombstone behavior, never wrong state.
_TOMBSTONE_CAP = 100_000

#: Capability tokens the CAPS command advertises (store/client.py's
#: binary-batch negotiation): command-surface extensions beyond the
#: plain-Redis subset. "binbatch" = the MHGETALL/MFINISH aggregate forms.
#: A real Redis answers CAPS with -ERR unknown command, which the client
#: reads as "no capabilities" — negotiation is safe against any backend.
STORE_CAPS = ("binbatch",)


class StoreState:
    def __init__(self) -> None:
        self.hashes: dict[str, dict[str, str]] = {}
        # channel -> set of subscriber StreamWriters
        self.subs: dict[str, set[asyncio.StreamWriter]] = {}
        # all open connections, so stop() can close them (Python 3.12's
        # Server.wait_closed() blocks until every handler returns)
        self.conns: set[asyncio.StreamWriter] = set()
        # keys deleted since the last checkpoint, insertion-ordered (a
        # dict so the cap can drop oldest-first); written as DEL records
        # into the next snapshot so a replayed log can't resurrect them
        self.tombstones: dict[str, None] = {}


class StoreServer:
    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 6380,
        snapshot_path: str | None = None,
        autosave_interval: float = 0.0,
        replica_of: tuple[str, int] | str | None = None,
        epoch: int = 0,
        announce_ring: int = 0,
        health_port: int | None = None,
    ) -> None:
        self.host = host
        self.port = port
        self.snapshot_path = snapshot_path
        self.autosave_interval = autosave_interval
        #: HTTP liveness/readiness surface (``--health-port``): /healthz
        #: answers 200 while the process serves; /readyz answers 503
        #: while this store cannot take writes (loading its snapshot,
        #: unpromoted replica, fenced stale primary) — parity with the
        #: gateway/dispatcher stats servers, so fleet orchestration can
        #: route and restart shards like every other process. None = off.
        self.health_port = health_port
        self._health_server: asyncio.AbstractServer | None = None
        #: True until the startup snapshot load (if any) completed — the
        #: health listener binds FIRST so orchestration sees
        #: "alive but not ready" during a long load instead of a dead port
        self._loading = True
        self.state = StoreState()
        self._server: asyncio.AbstractServer | None = None
        self._shutdown = asyncio.Event()
        self._dirty = False
        self._autosave_task: asyncio.Task | None = None
        if isinstance(replica_of, str):
            replica_of = parse_endpoint(replica_of)
        self.replica_of = replica_of
        self.repl = ReplicationState(
            role="replica" if replica_of is not None else "primary",
            epoch=int(epoch),
        )
        if announce_ring > 0:
            self.repl.ring = AnnounceRing(announce_ring)
        self._link: ReplicaLink | None = None
        self._link_down_logged = False

    # -- lifecycle ---------------------------------------------------------
    async def start(self) -> None:
        if self.health_port is not None:
            # before the snapshot load: a long load must read as
            # alive-but-not-ready, not as a dead process
            self._health_server = await asyncio.start_server(
                self._handle_health, self.host, self.health_port
            )
            self.health_port = self._health_server.sockets[0].getsockname()[1]
        if self.snapshot_path is not None:
            # off-loop: a synchronous multi-GB load would block this very
            # event loop, so the just-bound health listener could accept
            # but never ANSWER — orchestration liveness probes would time
            # out and kill the process mid-load, the exact crash loop the
            # bind-before-load ordering exists to prevent
            self.state.hashes = await asyncio.get_running_loop().run_in_executor(
                None, snapshot.load_file, self.snapshot_path
            )
        self._loading = False
        self._server = await asyncio.start_server(
            self._handle_conn, self.host, self.port
        )
        # If port was 0, record the actual bound port.
        self.port = self._server.sockets[0].getsockname()[1]
        if self.replica_of is not None:
            self._link = ReplicaLink(self, *self.replica_of)
            self._link.start()
        if self.snapshot_path is not None and self.autosave_interval > 0:
            self._autosave_task = asyncio.create_task(self._autosave_loop())

    async def serve_forever(self) -> None:
        if self._server is None:
            await self.start()
        async with self._server:
            await self._shutdown.wait()
            # Drop live client connections before the async-with closes the
            # server: since Python 3.12 Server.wait_closed() waits for every
            # connection handler to finish, so a SHUTDOWN with an idle
            # subscriber still attached would hang the process forever.
            if self._autosave_task is not None:
                self._autosave_task.cancel()
            if self._link is not None:
                self._link.stop()
            if self._health_server is not None:
                self._health_server.close()
            for w in list(self.state.conns):
                w.close()

    async def stop(self) -> None:
        try:
            self._save_if_configured()
        except OSError as exc:
            print(f"shutdown snapshot save failed: {exc}", flush=True)
        if self._autosave_task is not None:
            self._autosave_task.cancel()
        if self._link is not None:
            self._link.stop()
        self._shutdown.set()
        if self._health_server is not None:
            self._health_server.close()
        if self._server is not None:
            self._server.close()
        for w in list(self.state.conns):
            w.close()
        if self._server is not None:
            await self._server.wait_closed()

    # -- HTTP health surface (--health-port) -------------------------------
    def readiness(self) -> tuple[bool, str]:
        """(ready, reason) for /readyz: ready iff this store can take
        writes RIGHT NOW. A loading snapshot, an unpromoted replica, and
        a fenced stale primary all serve 503 — route elsewhere, don't
        restart (liveness stays unconditional on /healthz)."""
        if self._loading:
            return False, "loading_snapshot"
        if self.repl.fenced:
            return False, "fenced"
        if self.repl.role == "replica":
            return False, "replica"
        return True, "ok"

    async def _handle_health(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        """Minimal HTTP/1.1 for the two probe paths — deliberately not an
        HTTP framework: the store process must not grow a dependency (or
        a thread) for two constant-shaped replies."""
        import json

        try:
            # bounded read: a connection that never sends a full request
            # (port scanner, half-open LB probe) must not pin a coroutine
            # + fd for its TCP lifetime
            async def _read_request() -> bytes:
                line = await reader.readline()
                while True:  # drain headers; probes send no body
                    h = await reader.readline()
                    if h in (b"\r\n", b"\n", b""):
                        return line

            request_line = await asyncio.wait_for(_read_request(), timeout=5.0)
            parts = request_line.split()
            path = parts[1].decode("ascii", "replace") if len(parts) > 1 else "/"
            if path == "/healthz":
                status, body = 200, b'{"ok": true}'
            elif path == "/readyz":
                ready, reason = self.readiness()
                status = 200 if ready else 503
                body = json.dumps(
                    {"ready": ready, "reason": reason}
                ).encode()
            else:
                status, body = 404, b'{"error": "not found"}'
            reason_phrase = {200: "OK", 404: "Not Found", 503: "Service Unavailable"}[status]
            writer.write(
                (
                    f"HTTP/1.1 {status} {reason_phrase}\r\n"
                    "Content-Type: application/json\r\n"
                    f"Content-Length: {len(body)}\r\n"
                    "Connection: close\r\n\r\n"
                ).encode()
                + body
            )
            await writer.drain()
        except (
            ConnectionError,
            ValueError,  # readline LimitOverrun on a >64 KiB garbage line
            asyncio.IncompleteReadError,
            asyncio.TimeoutError,
        ):
            pass
        finally:
            writer.close()

    # -- checkpointing -----------------------------------------------------
    def _save_if_configured(self) -> None:
        # deliberate blocking checkpoint: state mutates ONLY on this event
        # loop, so blocking it for the dump's duration IS the point-in-time
        # consistency mechanism — same contract as Redis SAVE (an async
        # BGSAVE would need copy-on-write state this server doesn't keep)
        if self.snapshot_path is not None:
            snapshot.save_file(  # faas: allow(eventloop.blocking-file-io)
                self.snapshot_path,
                self.state.hashes,
                deleted=list(self.state.tombstones),
            )
            # the file is now a complete point-in-time dump WITH these
            # deletions recorded; start the next delta window empty
            self.state.tombstones.clear()
            self._dirty = False

    # -- replication plumbing ----------------------------------------------
    def _note_deleted(self, key: str) -> None:
        """A key vanished (DEL, or HDEL emptied it): tombstone it for the
        next snapshot so a replayed log cannot resurrect it."""
        ts = self.state.tombstones
        ts.pop(key, None)  # re-insert at the tail (ordered dict semantics)
        ts[key] = None
        while len(ts) > _TOMBSTONE_CAP:
            ts.pop(next(iter(ts)))

    def _replicate(self, parts: list[str]) -> None:
        """A mutating command was applied: advance the replication offset,
        record PUBLISHes in the announce ring, and forward the command
        verbatim to every attached replica stream — BEFORE the caller's
        reply is written, so an acknowledged write has at least reached
        the kernel send buffer toward each live replica when this
        process dies (the zero-loss-failover half-promise; the rescan and
        announce replay cover the rest)."""
        self.repl.offset += 1
        name = parts[0].upper()
        if name == "PUBLISH":
            self.repl.ring.append(self.repl.offset, parts[1], parts[2])
        elif name == "FLUSHDB":
            self.repl.ring.clear()
            self.state.tombstones.clear()
        if self.repl.replicas:
            data = resp.encode_command(*parts)
            for w in list(self.repl.replicas):
                if w.is_closing():
                    self.repl.replicas.pop(w, None)
                    continue
                try:
                    w.write(data)
                except (ConnectionResetError, BrokenPipeError):
                    self.repl.replicas.pop(w, None)

    def apply_replicated(self, cmd: list) -> None:
        """Replica side: apply one command from the primary's stream.
        Commands arrive in primary execution order; anything outside the
        mutating set is ignored (future-proofing — an upgraded primary
        must not crash an older replica). Chained replication falls out:
        applying re-forwards through _replicate to OUR replicas."""
        if not cmd or not isinstance(cmd[0], str):
            return
        name, args = cmd[0].upper(), [str(a) for a in cmd[1:]]
        if name not in MUTATING_COMMANDS:
            return
        st = self.state
        if name == "HSET":
            h = st.hashes.setdefault(args[0], {})
            for f, v in zip(args[1::2], args[2::2]):
                h[f] = v
        elif name == "HSETNX":
            h = st.hashes.setdefault(args[0], {})
            h.setdefault(args[1], args[2])
        elif name == "HINCRBY":
            h = st.hashes.setdefault(args[0], {})
            try:
                value = int(h.get(args[1], "0")) + int(args[2])
            except ValueError:
                value = 0
            h[args[1]] = str(value)
        elif name == "HDEL":
            h = st.hashes.get(args[0])
            if h is not None:
                for f in args[1:]:
                    h.pop(f, None)
                if not h:
                    del st.hashes[args[0]]
                    self._note_deleted(args[0])
        elif name == "DEL":
            for k in args:
                if st.hashes.pop(k, None) is not None:
                    self._note_deleted(k)
        elif name == "PUBLISH":
            # local fan-out (fire-and-forget, like the primary's own) so
            # subscribers attached to the replica see the announce stream
            asyncio.ensure_future(self._publish(args[0], args[1]))
        elif name == "FLUSHDB":
            st.hashes.clear()
        self._dirty = True
        self._replicate([name, *args])

    def load_replicated_snapshot(
        self, hashes: dict[str, dict[str, str]], epoch: int, offset: int
    ) -> None:
        """Replica side: adopt the primary's full-sync state (REPLSYNC
        header + snapshot). Replaces local hashes wholesale — a fresh
        point-in-time dump needs no tombstones."""
        self.state.hashes = hashes
        self.state.tombstones.clear()
        self.repl.epoch = epoch
        self.repl.offset = offset
        self._dirty = True
        self._link_down_logged = False
        print(
            f"replica synced from {self.replica_of}: epoch={epoch} "
            f"offset={offset} keys={len(hashes)}",
            flush=True,
        )

    def note_link_down(self, exc: BaseException) -> None:
        if not self._link_down_logged:
            self._link_down_logged = True
            print(
                f"replication link to {self.replica_of} lost ({exc}); "
                "retrying until promoted or the primary returns",
                flush=True,
            )

    def promote(self) -> int:
        """Replica -> primary: stop tailing, take writes, bump the fencing
        epoch. Idempotent on an already-primary server (epoch unchanged —
        a retried PROMOTE must not burn fencing generations)."""
        if self.repl.role != "replica":
            return self.repl.epoch
        if self._link is not None:
            self._link.stop()
            self._link = None
        self.repl.role = "primary"
        self.repl.epoch += 1
        print(f"promoted to primary (epoch {self.repl.epoch})", flush=True)
        return self.repl.epoch

    async def _autosave_loop(self) -> None:
        while True:
            await asyncio.sleep(self.autosave_interval)
            if self._dirty:
                try:
                    self._save_if_configured()
                except OSError as exc:
                    # transient failure (disk full, dir unwritable) must not
                    # kill autosave for the rest of the server's life
                    print(f"autosave failed (will retry): {exc}", flush=True)

    # -- connection handling ----------------------------------------------
    async def _handle_conn(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        parser = resp.RespParser()
        subscribed: set[str] = set()
        self.state.conns.add(writer)
        try:
            while not reader.at_eof():
                data = await reader.read(65536)
                if not data:
                    break
                parser.feed(data)
                try:
                    cmds = parser.pop_all()
                except resp.ProtocolError as exc:
                    # non-RESP bytes (health probe, stray HTTP, telnet):
                    # reply with an error and drop the connection
                    writer.write(resp.encode_error(str(exc)))
                    await writer.drain()
                    return
                for cmd in cmds:
                    if not isinstance(cmd, list) or not cmd:
                        writer.write(resp.encode_error("protocol error"))
                        continue
                    keep_going = await self._dispatch(cmd, writer, subscribed)
                    if not keep_going:
                        await writer.drain()
                        return
                await writer.drain()
        except (ConnectionResetError, BrokenPipeError, asyncio.CancelledError):
            pass
        finally:
            self.state.conns.discard(writer)
            self.repl.replicas.pop(writer, None)
            for ch in subscribed:
                self.state.subs.get(ch, set()).discard(writer)
            writer.close()

    async def _dispatch(
        self,
        cmd: list[str],
        writer: asyncio.StreamWriter,
        subscribed: set[str],
    ) -> bool:
        name, args = cmd[0].upper(), cmd[1:]
        st = self.state
        if name in MUTATING_COMMANDS:
            # HA write gating, BEFORE any state is touched: an unpromoted
            # replica is read-only (its state is the primary's to write),
            # and a fenced stale primary refuses everyone — including
            # epoch-oblivious legacy clients (see replication.py)
            if self.repl.role == "replica":
                writer.write(resp.encode_error(READONLY_ERR))
                return True
            if self.repl.fenced:
                writer.write(resp.encode_error(FENCED_ERR))
                return True
        if name == "PING":
            writer.write(resp.encode_simple("PONG"))
        elif name == "SELECT":
            writer.write(resp.encode_simple("OK"))
        elif name == "INFO":
            # Redis-style ops introspection: "key:value" lines in one bulk
            n_subs = sum(len(ws) for ws in st.subs.values())
            lines = [
                "server:tpu-faas-store-python",
                f"keys:{len(st.hashes)}",
                f"subscribers:{n_subs}",
                f"channels:{len(st.subs)}",
                f"dirty:{int(self._dirty)}",
                f"snapshot_path:{self.snapshot_path or ''}",
                # -- replication introspection (replication.py) ----------
                f"role:{'fenced' if self.repl.fenced else self.repl.role}",
                f"epoch:{self.repl.epoch}",
                f"repl_offset:{self.repl.offset}",
                f"repl_replicas:{len(self.repl.replicas)}",
                f"repl_min_acked:{self.repl.min_acked()}",
                f"repl_lag:{self.repl.lag()}",
                f"repl_link_up:{int(self._link.synced) if self._link else 0}",
                f"announce_ring:{len(self.repl.ring)}",
            ]
            writer.write(resp.encode_bulk("\n".join(lines)))
        elif name == "ROLE":
            # [role, epoch, offset]: the client failover handshake's "can
            # this endpoint take writes?" probe (store/client.py _connect)
            role = "fenced" if self.repl.fenced else self.repl.role
            writer.write(
                resp.encode_array(
                    [
                        resp.encode_bulk(role),
                        resp.encode_integer(self.repl.epoch),
                        resp.encode_integer(self.repl.offset),
                    ]
                )
            )
        elif name == "FENCE":
            # epoch declaration: a client that has seen a promotion
            # declares the highest epoch it knows. A PRIMARY seeing a
            # declaration above its own epoch has been superseded — fence
            # it permanently. Replies with this server's epoch so the
            # client's knowledge is monotone too.
            try:
                declared = int(args[0]) if args else 0
            except ValueError:
                writer.write(resp.encode_error("FENCE needs an integer epoch"))
                return True
            if declared > self.repl.epoch and self.repl.role == "primary":
                if not self.repl.fenced:
                    self.repl.fenced = True
                    print(
                        f"fenced: a client declared epoch {declared} > "
                        f"our {self.repl.epoch}; refusing writes",
                        flush=True,
                    )
            writer.write(resp.encode_integer(self.repl.epoch))
        elif name == "PROMOTE":
            writer.write(resp.encode_integer(self.promote()))
        elif name == "REPLSYNC":
            # full sync + stream registration, atomically (no await between
            # the snapshot and the registration, so no command is missed
            # or doubled): [epoch, offset, snapshot] then raw forwarded
            # commands ride this connection forever
            snap = snapshot.dump_hashes(st.hashes)
            writer.write(
                resp.encode_array(
                    [
                        resp.encode_integer(self.repl.epoch),
                        resp.encode_integer(self.repl.offset),
                        resp.encode_bulk(snap),
                    ]
                )
            )
            self.repl.replicas[writer] = self.repl.offset
        elif name == "REPLACK":
            # reply-less by design: the primary->replica direction of this
            # connection is the replication stream, and an interleaved
            # "+OK" would corrupt it
            try:
                acked = int(args[0])
            except (IndexError, ValueError):
                return True
            if writer in self.repl.replicas:
                self.repl.replicas[writer] = acked
        elif name == "REPLAY":
            # announce-ring replay: [tail, ch, payload, ch, payload ...]
            # for entries with offset > after; after=-1 asks for the tail
            # alone (the dispatcher's offset-priming read)
            try:
                after = int(args[0]) if args else -1
            except ValueError:
                writer.write(resp.encode_error("REPLAY needs an integer offset"))
                return True
            items = [resp.encode_integer(self.repl.ring.tail)]
            if after >= 0:
                for _off, ch, payload in self.repl.ring.since(after):
                    items.append(resp.encode_bulk(ch))
                    items.append(resp.encode_bulk(payload))
            writer.write(resp.encode_array(items))
        elif name == "HSET":
            if len(args) < 3 or len(args) % 2 == 0:
                writer.write(resp.encode_error("wrong number of arguments for HSET"))
                return True
            h = st.hashes.setdefault(args[0], {})
            added = 0
            for f, v in zip(args[1::2], args[2::2]):
                if f not in h:
                    added += 1
                h[f] = v
            self._dirty = True
            self._replicate(["HSET", *args])
            writer.write(resp.encode_integer(added))
        elif name == "HGET":
            if len(args) != 2:
                writer.write(resp.encode_error("wrong number of arguments for HGET"))
                return True
            writer.write(resp.encode_bulk(st.hashes.get(args[0], {}).get(args[1])))
        elif name == "HEXISTS":
            if len(args) != 2:
                writer.write(
                    resp.encode_error("wrong number of arguments for HEXISTS")
                )
                return True
            writer.write(
                resp.encode_integer(
                    1 if args[1] in st.hashes.get(args[0], {}) else 0
                )
            )
        elif name == "HSETNX":
            if len(args) != 3:
                writer.write(
                    resp.encode_error("wrong number of arguments for HSETNX")
                )
                return True
            h = st.hashes.setdefault(args[0], {})
            if args[1] in h:
                writer.write(resp.encode_integer(0))
            else:
                h[args[1]] = args[2]
                self._dirty = True
                self._replicate(["HSETNX", *args])
                writer.write(resp.encode_integer(1))
        elif name == "HINCRBY":
            if len(args) != 3:
                writer.write(
                    resp.encode_error("wrong number of arguments for HINCRBY")
                )
                return True
            h = st.hashes.setdefault(args[0], {})
            try:
                delta = int(args[2])
            except ValueError:
                writer.write(
                    resp.encode_error("HINCRBY delta is not an integer")
                )
                return True
            try:
                current = int(h.get(args[1], "0"))
            except ValueError:
                writer.write(
                    resp.encode_error("hash value is not an integer")
                )
                return True
            value = current + delta
            h[args[1]] = str(value)
            self._dirty = True
            self._replicate(["HINCRBY", *args])
            writer.write(resp.encode_integer(value))
        elif name == "HDEL":
            if len(args) < 2:
                writer.write(resp.encode_error("wrong number of arguments for HDEL"))
                return True
            h = st.hashes.get(args[0])
            removed = 0
            if h is not None:
                for f in args[1:]:
                    if f in h:
                        del h[f]
                        removed += 1
                if not h:  # Redis semantics: empty hash = absent key
                    del st.hashes[args[0]]
                    self._note_deleted(args[0])
            if removed:
                self._dirty = True
                self._replicate(["HDEL", *args])
            writer.write(resp.encode_integer(removed))
        elif name == "HMGET":
            if len(args) < 2:
                writer.write(resp.encode_error("wrong number of arguments for HMGET"))
                return True
            h = st.hashes.get(args[0], {})
            writer.write(
                resp.encode_array([resp.encode_bulk(h.get(f)) for f in args[1:]])
            )
        elif name == "HGETALL":
            h = st.hashes.get(args[0], {}) if args else {}
            flat: list[bytes] = []
            for f, v in h.items():
                flat.append(resp.encode_bulk(f))
                flat.append(resp.encode_bulk(v))
            writer.write(resp.encode_array(flat))
        elif name == "CAPS":
            writer.write(
                resp.encode_array([resp.encode_bulk(c) for c in STORE_CAPS])
            )
        elif name == "MHGETALL":
            # batched HGETALL: ONE command whose reply is an array of
            # per-key flat field/value arrays (missing key -> empty array,
            # matching HGETALL). Replaces N pipelined HGETALLs on the
            # intake hot path — the client builds one command and parses
            # one reply instead of N of each.
            records: list[bytes] = []
            for k in args:
                h = st.hashes.get(k, {})
                flat = []
                for f, v in h.items():
                    flat.append(resp.encode_bulk(f))
                    flat.append(resp.encode_bulk(v))
                records.append(resp.encode_array(flat))
            writer.write(resp.encode_array(records))
        elif name == "MFINISH":
            return await self._mfinish(args, writer)
        elif name == "DEL":
            n = 0
            for k in args:
                if st.hashes.pop(k, None) is not None:
                    self._note_deleted(k)
                    n += 1
            self._dirty = self._dirty or n > 0
            if n:
                self._replicate(["DEL", *args])
            writer.write(resp.encode_integer(n))
        elif name == "KEYS":
            pattern = args[0] if args else "*"
            ks = [k for k in st.hashes if fnmatch.fnmatchcase(k, pattern)]
            writer.write(resp.encode_array([resp.encode_bulk(k) for k in ks]))
        elif name == "PUBLISH":
            if len(args) != 2:
                writer.write(resp.encode_error("wrong number of arguments for PUBLISH"))
                return True
            # replicate BEFORE replying: the announce reaches the
            # replica's ring (and its subscribers) no later than the
            # publisher's acknowledgment — what makes post-failover
            # REPLAY a trustworthy re-discovery source
            self._replicate(["PUBLISH", args[0], args[1]])
            n = await self._publish(args[0], args[1])
            writer.write(resp.encode_integer(n))
        elif name == "SUBSCRIBE":
            for ch in args:
                subscribed.add(ch)
                st.subs.setdefault(ch, set()).add(writer)
                writer.write(
                    resp.encode_array(
                        [
                            resp.encode_bulk("subscribe"),
                            resp.encode_bulk(ch),
                            resp.encode_integer(len(subscribed)),
                        ]
                    )
                )
        elif name == "UNSUBSCRIBE":
            channels: Iterable[str] = args or list(subscribed)
            for ch in channels:
                subscribed.discard(ch)
                st.subs.get(ch, set()).discard(writer)
                writer.write(
                    resp.encode_array(
                        [
                            resp.encode_bulk("unsubscribe"),
                            resp.encode_bulk(ch),
                            resp.encode_integer(len(subscribed)),
                        ]
                    )
                )
        elif name == "FLUSHDB":
            st.hashes.clear()
            self._dirty = True
            self._replicate(["FLUSHDB"])
            writer.write(resp.encode_simple("OK"))
        elif name == "SAVE":
            target = args[0] if args else self.snapshot_path
            if target is None:
                writer.write(
                    resp.encode_error("SAVE needs a path (no --snapshot configured)")
                )
                return True
            try:
                # deliberate blocking checkpoint, like Redis SAVE: the loop
                # pause guarantees the dump is a consistent point-in-time
                # cut (see _save_if_configured)
                snapshot.save_file(  # faas: allow(eventloop.blocking-file-io)
                    target, st.hashes, deleted=list(st.tombstones)
                )
            except OSError as exc:
                writer.write(resp.encode_error(f"SAVE failed: {exc}"))
                return True
            if target == self.snapshot_path:
                # delta window restarts only for the CONFIGURED target —
                # an ad-hoc SAVE elsewhere must not eat the tombstones the
                # next checkpoint still needs to record
                st.tombstones.clear()
                self._dirty = False
            writer.write(resp.encode_simple("OK"))
        elif name == "QUIT":
            writer.write(resp.encode_simple("OK"))
            return False
        elif name == "SHUTDOWN":
            try:
                self._save_if_configured()
            except OSError as exc:
                # like Redis: a failed save aborts the shutdown and the
                # client is told, rather than dying with unsaved state or
                # silently staying up
                writer.write(
                    resp.encode_error(f"SHUTDOWN aborted, save failed: {exc}")
                )
                return True
            self._shutdown.set()
            return False
        else:
            writer.write(resp.encode_error(f"unknown command '{name}'"))
        return True

    async def _mfinish(self, args: list[str], writer) -> bool:
        """MFINISH <now> <inline_max> <n> (task_id status result fw)*n —
        the server-side batched terminal flush behind the client's
        binary-batch fast path (store/client.py finish_task_many).

        Semantics mirror the client's pipelined slow path exactly: the
        first-wins freeze set is evaluated against PRE-batch state
        (CANCELLED is lawfully overwritable by a late real result; any
        other terminal or unknown/missing status freezes), and ids written
        earlier in the SAME batch freeze later first-wins duplicates. Each
        surviving task applies record-write -> live-index drop -> announce
        in order, and replicates as the same PRIMITIVE commands the slow
        path would have sent (HSET/HDEL/PUBLISH) — replication streams,
        snapshots, and replica-attached subscribers are indistinguishable
        from the pipelined form. Replies with the written-task count."""
        from tpu_faas_torch.core.task import (
            FIELD_FINAL_AT,
            FIELD_FINAL_STATUS,
            FIELD_FINISHED_AT,
            FIELD_RESULT,
            FIELD_STATUS,
            TaskStatus,
        )
        from tpu_faas_torch.store.base import (
            LIVE_INDEX_KEY,
            RESULTS_CHANNEL,
            encode_result_announce,
        )

        # branch-local HA write gate (MFINISH expands to mutating
        # primitives but is not itself in MUTATING_COMMANDS — the
        # replication stream only ever carries the primitives)
        if self.repl.role == "replica":
            writer.write(resp.encode_error(READONLY_ERR))
            return True
        if self.repl.fenced:
            writer.write(resp.encode_error(FENCED_ERR))
            return True
        try:
            now, inline_max, n = args[0], int(args[1]), int(args[2])
            rest = args[3:]
            if n < 0 or len(rest) != 4 * n:
                raise ValueError
        except (IndexError, ValueError):
            writer.write(
                resp.encode_error("wrong number of arguments for MFINISH")
            )
            return True
        st = self.state
        items = [
            (rest[4 * i], rest[4 * i + 1], rest[4 * i + 2], rest[4 * i + 3] == "1")
            for i in range(n)
        ]
        frozen: set[str] = set()
        for task_id, _status, _result, fw in items:
            if not fw or task_id in frozen:
                continue
            status = st.hashes.get(task_id, {}).get(FIELD_STATUS)
            if status == str(TaskStatus.CANCELLED):
                continue  # a late real result lawfully overwrites
            if TaskStatus.terminal_str(status, unknown=True):
                frozen.add(task_id)
        written: set[str] = set()
        for task_id, status, result, fw in items:
            if fw and (task_id in written or task_id in frozen):
                continue
            h = st.hashes.setdefault(task_id, {})
            h[FIELD_STATUS] = status
            h[FIELD_FINAL_STATUS] = status
            h[FIELD_FINAL_AT] = now
            h[FIELD_RESULT] = result
            h[FIELD_FINISHED_AT] = now
            self._replicate(
                [
                    "HSET", task_id,
                    FIELD_STATUS, status,
                    FIELD_FINAL_STATUS, status,
                    FIELD_FINAL_AT, now,
                    FIELD_RESULT, result,
                    FIELD_FINISHED_AT, now,
                ]
            )
            live = st.hashes.get(LIVE_INDEX_KEY)
            if live is not None and task_id in live:
                del live[task_id]
                if not live:
                    del st.hashes[LIVE_INDEX_KEY]
                    self._note_deleted(LIVE_INDEX_KEY)
                self._replicate(["HDEL", LIVE_INDEX_KEY, task_id])
            payload = encode_result_announce(task_id, status, result, inline_max)
            self._replicate(["PUBLISH", RESULTS_CHANNEL, payload])
            await self._publish(RESULTS_CHANNEL, payload)
            written.add(task_id)
        if written:
            self._dirty = True
        writer.write(resp.encode_integer(len(written)))
        return True

    async def _publish(self, channel: str, payload: str) -> int:
        """Fan a message out to subscribers; fire-and-forget like Redis pub/sub."""
        receivers = list(self.state.subs.get(channel, ()))
        msg = resp.encode_array(
            [
                resp.encode_bulk("message"),
                resp.encode_bulk(channel),
                resp.encode_bulk(payload),
            ]
        )
        n = 0
        for w in receivers:
            if w.is_closing():
                self.state.subs[channel].discard(w)
                continue
            try:
                w.write(msg)
                n += 1
            except (ConnectionResetError, BrokenPipeError):
                self.state.subs[channel].discard(w)
        return n


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description="tpu-faas task store server (Python)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=6380)
    ap.add_argument(
        "--snapshot",
        default=None,
        help="checkpoint file: loaded at startup, written on SAVE/SHUTDOWN",
    )
    ap.add_argument(
        "--autosave",
        type=float,
        default=0.0,
        help="seconds between automatic snapshots while dirty (0 = off)",
    )
    ap.add_argument(
        "--replica-of",
        default=None,
        metavar="HOST:PORT",
        help="start as a read-only replica tailing this primary's write "
        "stream; accepts writes only after an explicit PROMOTE command",
    )
    ap.add_argument(
        "--epoch",
        type=int,
        default=0,
        help="fencing epoch to start with (restart a previously-promoted "
        "store with its post-promotion epoch so old primaries stay fenced)",
    )
    ap.add_argument(
        "--announce-ring",
        type=int,
        default=0,
        help="override the bounded announce-replay ring size "
        "(default 10000 entries)",
    )
    ap.add_argument(
        "--health-port",
        type=int,
        default=None,
        help="serve HTTP GET /healthz (liveness) and /readyz (503 while "
        "loading a snapshot / unpromoted replica / fenced) on this port — "
        "probe parity with the gateway and dispatcher stats servers",
    )
    ns = ap.parse_args(argv)

    async def run() -> None:
        server = StoreServer(
            ns.host,
            ns.port,
            snapshot_path=ns.snapshot,
            autosave_interval=ns.autosave,
            replica_of=ns.replica_of,
            epoch=ns.epoch,
            announce_ring=ns.announce_ring,
            health_port=ns.health_port,
        )
        await server.start()
        # graceful kill/Ctrl-C must checkpoint, like the native server's
        # SIGTERM/SIGINT handlers — otherwise everything since the last
        # autosave is lost on `systemctl stop`
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGTERM, signal.SIGINT):
            loop.add_signal_handler(
                sig, lambda: asyncio.ensure_future(server.stop())
            )
        print(f"tpu-faas store listening on {server.host}:{server.port}", flush=True)
        await server.serve_forever()

    asyncio.run(run())


if __name__ == "__main__":
    main()
