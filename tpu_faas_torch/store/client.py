"""Blocking TCP client for the RESP store servers (TaskStore implementation).

Works against the Python asyncio server (store/server.py), the native C++
server (native/store_server.cpp), or a real Redis. Mirrors the structure the
reference gets from redis-py: one connection for commands, one dedicated
connection per pub/sub subscription with a non-blocking ``get_message()``
(reference task_dispatcher.py:34-36, 75).

Thread-safety: command calls are serialized by a lock, so one RespStore can be
shared across gateway/dispatcher threads; each Subscription owns its socket.

High availability: construct with an ordered ``endpoints`` list (or a
``resp://h1:p1,h2:p2`` URL through ``make_store``) and the client fails
over — every (re)connect walks the list from the active endpoint, runs a
FENCE/ROLE handshake against each candidate, and settles on the first
endpoint that reports the writable ``primary`` role. Unpromoted replicas
and fenced stale primaries are skipped; the highest epoch ever seen is
re-declared on every handshake, which is what fences a resurrected old
primary (store/replication.py). Single-endpoint clients send NO handshake
— the wire surface toward a plain Redis is byte-identical to before.
"""

from __future__ import annotations

import select
import socket
import threading
import time
from typing import Mapping

from tpu_faas_torch.obs import REGISTRY
from tpu_faas_torch.store import resp
from tpu_faas_torch.store.base import (
    BLOB_AT_FIELD,
    BLOB_DATA_FIELD,
    LIVE_INDEX_KEY,
    RESULTS_CHANNEL,
    TASKS_CHANNEL,
    Subscription,
    TaskStore,
    blob_key,
    encode_result_announce,
)

#: Process-wide round-trip counter, one series per store role: the scrape
#: analog of each handle's ``n_round_trips`` (one pipelined batch = 1).
#: A per-handle instance counter can't be scraped after the handle dies;
#: the registry series is the durable process total.
_ROUND_TRIPS_TOTAL = REGISTRY.counter(
    "tpu_faas_store_round_trips_total",
    "Store wire round trips paid by this process (pipelined batch = 1)",
    ("backend",),
)
#: Command bytes put on the store wire by this process — the payload
#: plane's primary win is measured here (a digest task record is ~100
#: bytes where the inline form carried the whole function body), so the
#: bench lane and operators need it as a first-class series, not a
#: tcpdump session.
_BYTES_SENT_TOTAL = REGISTRY.counter(
    "tpu_faas_store_bytes_sent_total",
    "Encoded command bytes sent to the store by this process",
    ("backend",),
)

#: Store failovers this process's clients performed: an endpoint rotation
#: that SETTLED on a different endpoint than the previous commands used.
#: Process-global like the round-trip counter — the operator-facing
#: "how often did we fail over" series.
_FAILOVERS_TOTAL = REGISTRY.counter(
    "tpu_faas_store_failovers_total",
    "Store endpoint failovers performed by this process's clients "
    "(reconnects that settled on a different endpoint)",
    ("backend",),
)

#: Commands that must not be replayed after an ambiguous connection loss —
#: replaying a PUBLISH announces (and therefore dispatches) a task twice, and
#: both servers apply SHUTDOWN then close without replying, so a retry would
#: shut down the supervisor-restarted replacement too.
_NON_IDEMPOTENT = frozenset({"PUBLISH", "SHUTDOWN"})


#: The receive buffer a subscription asks for (ROADMAP C.5): a burst the
#: reader has not drained yet (thousands of announces, ~45 B each) must fit
#: in the socket's buffer. With the default window, a gVisor-style network
#: stack stalls such a burst for seconds once ~64 KiB are unread.
SUBSCRIBER_RCVBUF = 8 << 20


class _Conn:
    """One blocking RESP connection."""

    def __init__(self, host: str, port: int, timeout: float = 10.0,
                 subscriber: bool = False) -> None:
        err: OSError = ConnectionError(f"no address for {host}:{port}")
        for family, kind, proto, _, addr in socket.getaddrinfo(
            host, port, type=socket.SOCK_STREAM
        ):
            sock = socket.socket(family, kind, proto)
            try:
                if subscriber:
                    # before connect: the TCP window scale is fixed on the
                    # SYN, so a buffer set after connect cannot widen it
                    sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF,
                                    SUBSCRIBER_RCVBUF)
                sock.settimeout(timeout)
                sock.connect(addr)
            except OSError as exc:
                sock.close()
                err = exc
                continue
            break
        else:
            raise err
        self.sock = sock
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self.parser = resp.RespParser()
        #: True once THIS connection negotiated the binary-batch command
        #: surface (CAPS advertised "binbatch") — per-connection exactly
        #: like CAP_BIN on the worker wire: a reconnect (possibly to a
        #: plain Redis after failover) re-negotiates from scratch
        self.binbatch = False

    def send(self, *parts: str | bytes | int) -> int:
        data = resp.encode_command(*parts)
        self.sock.sendall(data)
        return len(data)

    def recv_reply(self, raw: bool = False):
        while True:
            item = self.parser.pop(raw=raw)
            if item is not resp.NEED_MORE:
                if isinstance(item, resp.RespError):
                    raise item
                return item
            data = self.sock.recv(65536)
            if not data:
                raise ConnectionError("store connection closed")
            self.parser.feed(data)

    def send_many(self, commands) -> int:
        """RESP pipelining: every command in one write; replies follow in
        order. Returns bytes written."""
        data = b"".join(resp.encode_command(*c) for c in commands)
        self.sock.sendall(data)
        return len(data)

    def command(self, *parts: str | bytes | int):
        self.send(*parts)
        return self.recv_reply()

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass


class _RespSubscription(Subscription):
    """Dedicated connection subscribed to one channel.

    Survives a store restart: on connection loss the next ``get_message``
    reconnects and resubscribes. Messages published while disconnected are
    lost — exactly the fire-and-forget pub/sub contract the dispatchers
    already handle (reference SURVEY §5.4: stranded announcements).

    Failover: when built by a multi-endpoint RespStore, the subscription
    follows the store's ACTIVE endpoint — the one the command path's
    FENCE/ROLE handshake settled on — so after a promotion the bus
    reattaches to the endpoint actually receiving the writes (announces
    published to a fenced old primary's bus would never arrive). A
    generation check on every drain forces the reattach even while the
    old socket still looks healthy."""

    def __init__(
        self, host: str, port: int, channel: str, store: "RespStore | None" = None
    ) -> None:
        self._host = host
        self._port = port
        self._store = store
        self._channel = channel
        self._conn: _Conn | None = None
        self._gen = -1
        self._closed = False
        self._connect()  # initial failure propagates: caller wants a live bus

    def _endpoint(self) -> tuple[str, int, int]:
        if self._store is not None:
            # one-attribute read: endpoint and generation arrive together
            # (separate host/port/generation reads could tear against a
            # concurrent failover and pin this sub to the old endpoint
            # while recording the new generation)
            return self._store._sub_target
        return self._host, self._port, 0

    def _connect(self) -> None:
        host, port, gen = self._endpoint()
        self._conn = _Conn(host, port, subscriber=True)
        self._gen = gen
        reply = self._conn.command("SUBSCRIBE", self._channel)
        if not (isinstance(reply, list) and reply[0] == "subscribe"):
            raise resp.RespError(f"unexpected SUBSCRIBE reply: {reply!r}")

    def _reconnect(self) -> bool:
        if self._closed:
            return False
        if self._conn is not None:
            self._conn.close()
            self._conn = None
        try:
            self._connect()
            return True
        except OSError:
            return False

    def get_message(self, timeout: float = 0.0) -> str | None:
        if self._closed:
            return None
        if (
            self._conn is not None
            and self._store is not None
            and self._store.failover_generation != self._gen
        ):
            # the command path failed over: this socket may point at a
            # dead (or fenced — silently announce-less) endpoint. Any
            # frames still buffered on the old connection are drained
            # first; announces published to the old endpoint after the
            # failover are the bus's documented fire-and-forget loss,
            # covered by the dispatcher's replay + rescan re-arm.
            drained = self._drain_buffered()
            if drained is not None:
                return drained
            self._conn.close()
            self._conn = None
        if self._conn is None and not self._reconnect():
            return None
        try:
            return self._get_message(timeout)
        except (ConnectionError, OSError):
            if self._conn is not None:
                self._conn.close()
                self._conn = None  # reconnect on the next call
            return None

    def _drain_buffered(self) -> str | None:
        """Pop the next already-parsed push message without touching the
        socket (the failover handoff's no-loss drain of the old conn)."""
        item = self._conn.parser.pop()
        while item is not resp.NEED_MORE:
            payload = self._decode_push(item)
            if payload is not None:
                return payload
            item = self._conn.parser.pop()
        return None

    def _get_message(self, timeout: float) -> str | None:
        # First drain anything already parsed/buffered.
        payload = self._drain_buffered()
        if payload is not None:
            return payload
        # Then poll the socket.
        deadline = None if timeout <= 0 else timeout
        while True:
            ready, _, _ = select.select([self._conn.sock], [], [], deadline or 0)
            if not ready:
                return None
            data = self._conn.sock.recv(65536)
            if not data:
                raise ConnectionError("subscription connection closed")
            self._conn.parser.feed(data)
            item = self._conn.parser.pop()
            while item is not resp.NEED_MORE:
                payload = self._decode_push(item)
                if payload is not None:
                    return payload
                item = self._conn.parser.pop()
            # Partial message: keep waiting within the same timeout window.
            # (Simplification: we don't decrement the deadline; pub/sub frames
            # are tiny so a partial read resolves on the next recv.)

    def fileno(self) -> int | None:
        """Readability fd of the live subscription socket (None while
        disconnected) — lets an event-driven serve loop park in one poll()
        over workers AND the bus. The fd changes on reconnect/failover;
        pollers re-check each iteration (Subscription.fileno contract).
        NOTE: messages already parsed into the buffer don't show as
        readability — consumers drain to empty each wake, and their
        periodic fallback covers the rest."""
        if self._closed or self._conn is None:
            return None
        try:
            return self._conn.sock.fileno()
        except OSError:
            return None

    @staticmethod
    def _decode_push(item) -> str | None:
        if (
            isinstance(item, list)
            and len(item) == 3
            and item[0] == "message"
        ):
            return item[2]
        return None  # subscribe/unsubscribe confirmations etc.

    def close(self) -> None:
        # mark closed FIRST: a dispatch loop mid-get_message on another
        # thread would otherwise resurrect the subscription (reconnect +
        # re-SUBSCRIBE) after its owner already closed it
        self._closed = True
        if self._conn is not None:
            self._conn.close()


class RespStore(TaskStore):
    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 6380,
        endpoints: list[tuple[str, int]] | None = None,
        binbatch: bool = False,
    ) -> None:
        #: ordered failover ring; [(host, port)] in the classic
        #: single-endpoint form
        self.endpoints: list[tuple[str, int]] = (
            list(endpoints) if endpoints else [(host, port)]
        )
        #: where the next connect STARTS walking the ring (rotate_endpoint
        #: advances it); distinct from _settled_idx, the endpoint the last
        #: successful connection actually landed on
        self._active_idx = 0
        self._settled_idx = 0
        #: bumped every time commands SETTLE on a different endpoint than
        #: before; dispatchers watch it to trigger their failover re-arm
        #: (announce replay + rescan) and subscriptions to reattach
        self.failover_generation = 0
        #: highest fencing epoch any handshake reported; re-declared via
        #: FENCE on every multi-endpoint connect (never sent with a
        #: single endpoint — plain-Redis wire compatibility)
        self.known_epoch = 0
        #: (host, port, failover_generation) the subscriptions follow —
        #: one tuple attribute, written whole on settle, so subscription
        #: threads read endpoint and generation consistently lock-free
        self._sub_target: tuple[str, int, int] = (*self.endpoints[0], 0)
        self._lock = threading.Lock()
        self._closed = False
        #: wire round trips paid by this handle (TaskStore.n_round_trips
        #: contract: one pipelined batch = one). Written under the command
        #: lock; read lock-free by stats pollers (a torn read of an int is
        #: impossible in CPython, and the counter is observability only).
        self.n_round_trips = 0
        #: command bytes this handle put on the wire (same lock-free read
        #: contract as n_round_trips) — the bench lane's bytes-per-task
        #: measurement is a delta over this
        self.n_bytes_sent = 0
        self._rt_series = _ROUND_TRIPS_TOTAL.labels(backend="resp")
        self._bytes_series = _BYTES_SENT_TOTAL.labels(backend="resp")
        self._failover_series = _FAILOVERS_TOTAL.labels(backend="resp")
        #: binary-batch knob (``--store-binbatch``): when True, every fresh
        #: connection probes CAPS once and — iff the server advertises
        #: "binbatch" — hgetall_many/finish_task_many collapse into the
        #: MHGETALL/MFINISH aggregate commands with raw-bytes reply
        #: parsing. Off (the default) sends ZERO extra bytes: the wire
        #: toward a plain Redis is byte-identical to before (the same
        #: contract as the single-endpoint no-handshake rule above).
        self._binbatch = bool(binbatch)
        #: fault-injection seam (tpu_faas/chaos): None when
        #: TPU_FAAS_CHAOS is unset — one identity check per round trip,
        #: wire and exposition surfaces byte-identical
        from tpu_faas_torch import chaos as _chaos

        _plan = _chaos.from_env()
        self._chaos = _plan.store() if _plan is not None else None
        self._conn: _Conn | None = self._connect()

    @property
    def host(self) -> str:
        return self.endpoints[self._settled_idx][0]

    @property
    def port(self) -> int:
        return self.endpoints[self._settled_idx][1]

    def _connect(self) -> _Conn:
        """Connect to the first WRITABLE endpoint, walking the ring from
        the active index. Single-endpoint: a plain connect, no handshake
        bytes — the classic (plain-Redis-compatible) wire surface.
        Multi-endpoint: each TCP-reachable candidate gets a pipelined
        FENCE(known_epoch) + ROLE handshake; unpromoted replicas and
        fenced stale primaries are skipped (the FENCE declaration is what
        fences a resurrected old primary — see store/replication.py).
        Settling on a different endpoint than the previous connection
        bumps ``failover_generation`` and the failovers counter. Raises
        ConnectionError when no endpoint is writable — the same outage
        family the breaker and the dispatchers already handle."""
        n = len(self.endpoints)
        if n == 1:
            return self._negotiate(_Conn(*self.endpoints[0]))
        # discovery sweep: handshake EVERY reachable endpoint before
        # settling, so the highest epoch in the fleet is known first — a
        # fresh process (known_epoch 0) must not settle on a resurrected
        # stale primary while the true (higher-epoch) primary is also
        # reachable, and the stale one gets actively fenced below
        last_err: Exception | None = None
        candidates: list[tuple[int, _Conn, int, str | None]] = []
        for step in range(n):
            idx = (self._active_idx + step) % n
            host, port = self.endpoints[idx]
            try:
                conn = _Conn(host, port)
            except OSError as exc:
                last_err = exc
                continue
            try:
                conn.send_many(
                    [("FENCE", self.known_epoch), ("ROLE",)]
                )
                srv_epoch = conn.recv_reply()
                role_reply = conn.recv_reply()
            except (OSError, ConnectionError, resp.RespError) as exc:
                # RespError too: an endpoint that can't speak the HA
                # handshake (a plain Redis slipped into a multi-endpoint
                # ring) is not failover-safe to write through
                conn.close()
                last_err = exc
                continue
            epoch = srv_epoch if isinstance(srv_epoch, int) else -1
            self.known_epoch = max(self.known_epoch, epoch)
            role = role_reply[0] if isinstance(role_reply, list) and role_reply else None
            candidates.append((idx, conn, epoch, role))
        # the true primary is the one carrying the fleet's highest epoch;
        # a "primary" below it is a resurrected stale one — never settle
        # there (its writes are doomed to -ERR FENCED anyway)
        best: tuple[int, _Conn, int, str | None] | None = None
        for cand in candidates:
            if cand[3] == "primary" and cand[2] >= self.known_epoch:
                if best is None or cand[2] > best[2]:
                    best = cand
        for idx, conn, epoch, role in candidates:
            if best is not None and conn is best[1]:
                continue
            if role == "primary" and epoch < self.known_epoch:
                # actively fence the stale primary: our first handshake may
                # have declared a lower epoch than the sweep ended up with
                try:
                    conn.send_many([("FENCE", self.known_epoch)])
                    conn.recv_reply()
                except (OSError, ConnectionError, resp.RespError):
                    pass
            if role != "primary":
                last_err = ConnectionError(
                    f"store {self.endpoints[idx][0]}:{self.endpoints[idx][1]} "
                    f"is {role or 'unknown'}, not primary"
                )
            conn.close()
        if best is None:
            raise ConnectionError(
                f"no writable store endpoint among {self.endpoints}"
                + (f" (last: {last_err})" if last_err else "")
            )
        idx, conn, _epoch, _role = best
        self._active_idx = idx
        if idx != self._settled_idx:
            self._settled_idx = idx
            self.failover_generation += 1
            self._failover_series.inc()
        # one atomic tuple for the subscription threads: endpoint and
        # generation must be read together (a torn host/port-vs-generation
        # read would pin a subscription to the old endpoint while marking
        # it current, silencing the bus until an unrelated socket error)
        host, port = self.endpoints[idx]
        self._sub_target = (host, port, self.failover_generation)
        return self._negotiate(conn)

    def _negotiate(self, conn: _Conn) -> _Conn:
        """Binary-batch capability probe on a fresh connection: one CAPS
        round trip, sent ONLY when the knob is on (off = zero extra bytes,
        the byte-identical plain-Redis surface). A backend without CAPS
        (real Redis, native server) answers -ERR unknown command — read as
        no capabilities, never an error: the slow paths keep working and
        the negotiation result is pinned per-connection like CAP_BIN."""
        if self._binbatch:
            try:
                reply = conn.command("CAPS")
                conn.binbatch = isinstance(reply, list) and "binbatch" in reply
            except resp.RespError:
                conn.binbatch = False
        return conn

    def rotate_endpoint(self) -> bool:
        """Advance the ring so the NEXT connect starts at the following
        endpoint — the circuit breaker's half-open hook: a probe that
        failed against a dead-but-black-holing primary (slow connect
        timeout) immediately probes the replica instead of retrying the
        same endpoint or waiting out another open window. Returns False
        on single-endpoint handles (nothing to rotate to)."""
        if len(self.endpoints) < 2:
            return False
        with self._lock:
            if self._conn is not None:
                self._conn.close()
                self._conn = None
            self._active_idx = (self._active_idx + 1) % len(self.endpoints)
        return True

    def _command(self, *parts: str | bytes | int, _raw: bool = False):
        """Run one command; transparently reconnect once if the server
        restarted (matches redis-py's retry-on-ConnectionError the reference
        relies on — without it a store restart would permanently wedge every
        gateway/dispatcher holding a connection).

        Retry is restricted to idempotent commands. A ConnectionError is
        ambiguous too (the server may have applied the command and died
        before replying), and replaying a PUBLISH would announce the same
        task twice — dispatching it to two workers. Hash writes replay to the
        same end state, so they retry; PUBLISH raises to the caller, whose
        announce is at-most-once (a stranded QUEUED task is recoverable — the
        tpu-push dispatcher rescans for stranded tasks at startup and every
        ``rescan_period`` seconds while serving; double execution is not).

        ``self._conn`` is None between a failed reconnect and the next call:
        if the replacement connection can't be made immediately (server still
        restarting), the client must not keep using the CLOSED old socket —
        that would turn every later ConnectionError into a plain
        EBADF OSError that nothing retries, wedging the client forever.
        Instead the broken connection is dropped and each subsequent call
        retries the connect lazily until the server is back."""
        with self._lock:
            if self._closed:
                # a serve thread racing close() must not resurrect the
                # connection (same guard as _RespSubscription.close)
                raise ConnectionError("store client is closed")
            if self._conn is None:
                # previous reconnect failed; retry it now (raises if the
                # server is still down, leaving _conn None for next time)
                self._conn = self._connect()
            if self._chaos is not None:
                # may sleep (latency) or raise ConnectionError (outage
                # window) BEFORE the socket is touched — the injected
                # outage must look like an unreachable store, not a
                # desynchronized connection
                self._chaos.before(str(parts[0]))
            try:
                # deliberate I/O under lock: this lock EXISTS to serialize
                # use of the one connection (RESP replies are positional)
                self.n_round_trips += 1
                self._rt_series.inc()
                sent = self._conn.send(*parts)  # faas: allow(locks.blocking-call-under-lock)
                self.n_bytes_sent += sent
                self._bytes_series.inc(sent)
                return self._conn.recv_reply(raw=_raw)  # faas: allow(locks.blocking-call-under-lock)
            except (ConnectionError, TimeoutError):
                # TimeoutError too: the reply may still arrive later, so the
                # old connection is DESYNCHRONIZED (a future command would
                # read the stale reply as its own) — it must be dropped, and
                # any retry must go through a fresh connection
                self._conn.close()
                self._conn = None
                conn = self._connect()  # may raise: _conn stays None
                self._conn = conn
                if str(parts[0]).upper() in _NON_IDEMPOTENT:
                    raise
                # same serialized-connection justification as above
                self.n_round_trips += 1
                self._rt_series.inc()  # the retry is a second round trip
                sent = conn.send(*parts)  # faas: allow(locks.blocking-call-under-lock)
                self.n_bytes_sent += sent
                self._bytes_series.inc(sent)
                return conn.recv_reply(raw=_raw)  # faas: allow(locks.blocking-call-under-lock)

    def pipeline(self, commands: list[tuple], _raw: bool = False) -> list:
        """Run many commands over one round trip (RESP pipelining) and
        return their replies in order; error replies come back as
        :class:`resp.RespError` values in place rather than raising, so one
        bad command cannot mask the other N-1 results.

        ``_raw`` reads every reply in raw mode (bulk strings stay bytes) —
        the binary-batch fast paths' pipelined MHGETALL reads.

        No automatic retry: after a mid-pipeline connection loss there is no
        telling which commands were applied, so the connection is dropped
        and the outage surfaces to the caller."""
        if not commands:
            return []
        with self._lock:
            if self._closed:
                raise ConnectionError("store client is closed")
            if self._conn is None:
                self._conn = self._connect()
            if self._chaos is not None:
                self._chaos.before("PIPELINE")
            conn = self._conn
            try:
                # deliberate I/O under lock (see _command): one connection,
                # positional replies — interleaved pipelines would desync
                self.n_round_trips += 1
                self._rt_series.inc()  # N commands, one round trip
                sent = conn.send_many(commands)  # faas: allow(locks.blocking-call-under-lock)
                self.n_bytes_sent += sent
                self._bytes_series.inc(sent)
                out: list = []
                for _ in commands:
                    try:
                        out.append(conn.recv_reply(raw=_raw))  # faas: allow(locks.blocking-call-under-lock)
                    except resp.RespError as exc:
                        out.append(exc)
                if self._chaos is not None and self._chaos.torn():
                    # torn pipeline: every command APPLIED (replies were
                    # read), but the caller sees the connection die before
                    # learning so — the applied-but-reply-lost ambiguity
                    # the no-retry contract above exists for. The handler
                    # below tears the connection down for real.
                    raise ConnectionError(
                        "chaos: torn pipeline (commands applied, reply "
                        "lost)"
                    )
                return out
            except (ConnectionError, TimeoutError):
                conn.close()
                self._conn = None
                raise

    # -- raw hash ops ------------------------------------------------------
    def hset(self, key: str, fields: Mapping[str, str]) -> None:
        flat: list[str] = []
        for f, v in fields.items():
            flat.extend((f, v))
        self._command("HSET", key, *flat)

    def hget(self, key: str, field: str) -> str | None:
        return self._command("HGET", key, field)

    def hgetall(self, key: str) -> dict[str, str]:
        flat = self._command("HGETALL", key)
        return dict(zip(flat[0::2], flat[1::2]))

    def hmget(self, key: str, fields: list[str]) -> list[str | None]:
        return self._command("HMGET", key, *fields)

    @staticmethod
    def _finish_cmds(
        task_id: str,
        status,
        result: str,
        now: str,
        inline_max: int = 0,
        result_digest: str | None = None,
        result_size: int = 0,
    ) -> list[tuple]:
        """The terminal-write command triple shared by finish_task and
        finish_task_many — ONE builder, so the single and batched forms can
        never desynchronize on the record contract. ``inline_max`` > 0
        (express lane) puts the status + result inline on the announce —
        SAME pipelined round, record write still first, so durability and
        ordering are unchanged. ``result_digest`` (result-blob plane)
        appends the digest-form fields to the same HSET and switches the
        announce to the digest form; None keeps the legacy commands byte
        for byte."""
        from tpu_faas_torch.core.task import (
            FIELD_FINAL_AT,
            FIELD_FINAL_STATUS,
            FIELD_FINISHED_AT,
            FIELD_RESULT,
            FIELD_RESULT_DIGEST,
            FIELD_RESULT_SIZE,
            FIELD_STATUS,
        )

        hset: tuple = (
            "HSET", task_id,
            FIELD_STATUS, str(status),
            # redundant stamps powering cancel_task's clobber repair
            # (base.finish_task writes the same fields)
            FIELD_FINAL_STATUS, str(status),
            FIELD_FINAL_AT, now,
            FIELD_RESULT, result,
            FIELD_FINISHED_AT, now,
        )
        if result_digest:
            hset = hset + (
                FIELD_RESULT_DIGEST, result_digest,
                FIELD_RESULT_SIZE, str(int(result_size)),
            )
        return [
            hset,
            ("HDEL", LIVE_INDEX_KEY, task_id),  # drop from the live index
            (
                "PUBLISH", RESULTS_CHANNEL,
                encode_result_announce(
                    task_id, str(status), result, inline_max,
                    result_digest=result_digest, result_size=result_size,
                ),
            ),
        ]

    def finish_task(
        self,
        task_id: str,
        status,
        result: str,
        first_wins: bool = False,
        inline_max: int = 0,
        result_digest: str | None = None,
        result_size: int = 0,
    ) -> None:
        """Base semantics (terminal write + RESULTS_CHANNEL announce), but
        the write and the announce ride ONE pipelined round trip — the
        result path is the dispatcher's per-task hot path and must not grow
        a second RTT for the wake-up feature."""
        if first_wins and self._result_frozen(task_id):
            return
        cmds = self._finish_cmds(
            task_id, status, result, repr(time.time()), inline_max,
            result_digest=result_digest, result_size=result_size,
        )
        try:
            replies = self.pipeline(cmds)
        except (ConnectionError, TimeoutError):
            # retry once on a fresh connection (pipeline() dropped the dead
            # one), preserving the transparent reconnect result writes had
            # via _command before pipelining. Unlike the task-announce
            # PUBLISH (non-idempotent: a replay dispatches a task twice),
            # replaying THIS pair is safe — HSET lands the same end state
            # and a duplicate RESULTS_CHANNEL publish is just a spurious
            # wake the gateway handlers tolerate by design.
            replies = self.pipeline(cmds)
        errors = [r for r in replies if isinstance(r, resp.RespError)]
        if errors:
            raise errors[0]

    def hdel(self, key: str, *fields: str) -> None:
        if fields:
            self._command("HDEL", key, *fields)

    def delete(self, key: str) -> None:
        self._command("DEL", key)

    def delete_many(self, keys: list[str]) -> None:
        if keys:
            self._command("DEL", *keys)  # one round trip, variadic DEL

    def hset_many(self, items) -> None:
        """Pipelined multi-hash HSET: the lease-renewal path touches every
        in-flight task once per period — one round trip, not one per task."""
        if not items:
            return
        cmds = [
            ("HSET", key, *(p for kv in fields.items() for p in kv))
            for key, fields in items
        ]
        replies = self.pipeline(cmds)
        errors = [r for r in replies if isinstance(r, resp.RespError)]
        if errors:
            raise errors[0]

    def hexists(self, key: str, field: str) -> bool:
        return bool(self._command("HEXISTS", key, field))

    def hincrby(self, key: str, field: str, delta: int) -> int:
        # atomic at the single-threaded server (real Redis's HINCRBY has
        # the same contract) — the dependency plane's pending-count
        # decrement must not lose updates between concurrent dispatchers
        return int(self._command("HINCRBY", key, field, int(delta)))

    def hincrby_many(self, items: list[tuple[str, str, int]]) -> list[int]:
        """Pipelined HINCRBY: the promotion plane decrements every child of
        a finished parent batch in ONE round trip."""
        if not items:
            return []
        replies = self.pipeline(
            [("HINCRBY", key, field, int(delta)) for key, field, delta in items]
        )
        errors = [r for r in replies if isinstance(r, resp.RespError)]
        if errors:
            raise errors[0]
        return [int(r) for r in replies]

    def setnx_field(
        self, key: str, field: str, value: str
    ) -> tuple[bool, str]:
        # HSETNX is atomic at the single-threaded server; the HGET read-back
        # is correct even if another command interleaves, because a claimed
        # field is write-once (the winner's full-record HSET repeats the
        # same value and nothing else ever mutates it)
        created, current = self.pipeline(
            [("HSETNX", key, field, value), ("HGET", key, field)]
        )
        return created == 1, current

    def setnx_fields(
        self, items: list[tuple[str, str]], field: str
    ) -> list[tuple[bool, str]]:
        if not items:
            return []
        cmds: list[tuple] = []
        for key, value in items:
            cmds.append(("HSETNX", key, field, value))
            cmds.append(("HGET", key, field))
        replies = self.pipeline(cmds)
        return [
            (replies[2 * i] == 1, replies[2 * i + 1])
            for i in range(len(items))
        ]

    def hsetnx_many(self, items) -> list[bool]:
        """Pipelined HSETNX over (key, field, value) triples: the span
        plane's first-write-wins flush pays one round trip per flush, not
        one per span. An error reply on one item (foreign WRONGTYPE key)
        degrades to created=False for that item instead of poisoning the
        batch — spans are telemetry, the healthy writes must land."""
        if not items:
            return []
        replies = self.pipeline(
            [("HSETNX", key, field, value) for key, field, value in items]
        )
        return [r == 1 for r in replies]

    # -- pipelined batch ops ----------------------------------------------
    def hget_many(self, keys, field: str):
        return self.pipeline([("HGET", k, field) for k in keys])

    #: keys per MHGETALL command on the binary-batch path. The stream
    #: parser (store/resp.py) re-parses a partial nested array from its
    #: start each time more bytes arrive, so one monolithic MHGETALL over
    #: a whole intake batch (potentially MBs, dozens of recv chunks) costs
    #: quadratic parse work — measured as the dominant intake cost at the
    #: 20k-task bench shape. Bounded chunks pipelined over ONE round trip
    #: keep replies inside a couple of recv buffers (parse stays ~linear)
    #: and bound the server-side reply buffer too.
    _MHGETALL_CHUNK = 256

    def _binbatch_on(self) -> bool:
        """Whether the CURRENT connection negotiated the binary-batch
        command surface. Lock-free read by design (attribute reads are
        atomic in CPython); a reconnect racing the check is handled by the
        fast paths themselves — an MHGETALL/MFINISH landing on a freshly
        non-capable connection comes back as RespError and the caller
        falls through to the slow path."""
        conn = self._conn
        return self._binbatch and conn is not None and conn.binbatch

    def hgetall_many(self, keys):
        """Pipelined HGETALL over many keys — the batched-intake read: one
        round trip fetches every announced task's record. A per-key error
        reply (a WRONGTYPE key some foreign producer wrote) degrades to {}
        for THAT key — the same shape as a missing record, which intake
        skips with a warning — instead of raising and poisoning the whole
        batch: one bad key must never wedge the other N-1 announces (or,
        parked and re-drained, wedge intake forever).

        On a negotiated binary-batch connection the N pipelined HGETALLs
        collapse into pipelined MHGETALL commands of bounded chunks (one
        round trip, same reply shape per key; see ``_MHGETALL_CHUNK``)."""
        if not keys:
            return []
        if self._binbatch_on():
            reply = self._mhgetall_chunked(keys, raw_mode=False)
            if reply is not None:
                return [
                    dict(zip(flat[0::2], flat[1::2]))
                    if isinstance(flat, list)
                    else {}
                    for flat in reply
                ]
        out: list[dict[str, str]] = []
        for flat in self.pipeline([("HGETALL", k) for k in keys]):
            if isinstance(flat, resp.RespError):
                out.append({})
                continue
            out.append(dict(zip(flat[0::2], flat[1::2])))
        return out

    def hgetall_many_raw(self, keys) -> list[list]:
        """Base semantics (flat [field, value, ...] per key), but on a
        negotiated binary-batch connection the whole fetch is ONE MHGETALL
        with the reply parsed in RAW mode — bulk strings stay ``bytes``,
        no per-field utf-8 decode, no per-record dict. The columnar intake
        (dispatch/base.py) parses these flat lists straight into arena
        columns. Fallback (knob off / plain Redis / mid-failover): the
        pipelined HGETALL path with ``str`` elements — callers handle
        both element types by contract."""
        if not keys:
            return []
        if self._binbatch_on():
            reply = self._mhgetall_chunked(keys, raw_mode=True)
            if reply is not None:
                return [
                    flat if isinstance(flat, list) else [] for flat in reply
                ]
        out: list[list] = []
        for flat in self.pipeline([("HGETALL", k) for k in keys]):
            out.append([] if isinstance(flat, resp.RespError) else flat)
        return out

    def _mhgetall_chunked(self, keys, raw_mode: bool):
        """Fetch ``keys`` as pipelined bounded-chunk MHGETALLs (one round
        trip). Returns the per-key reply list, or None when any chunk came
        back non-conforming (peer changed under us mid-failover) — the
        caller falls through to the plain pipelined-HGETALL path."""
        chunk = self._MHGETALL_CHUNK
        cmds = [
            ("MHGETALL", *keys[lo : lo + chunk])
            for lo in range(0, len(keys), chunk)
        ]
        try:
            replies = self.pipeline(cmds, _raw=raw_mode)
        except resp.RespError:
            return None
        out: list = []
        for cmd, reply in zip(cmds, replies):
            if not isinstance(reply, list) or len(reply) != len(cmd) - 1:
                return None
            out.extend(reply)
        return out

    def set_status_many(self, status, items) -> None:
        """Pipelined multi-task status write (base semantics: one shared
        status, per-item extra fields) — the dispatcher's coalesced
        RUNNING flush pays one round trip per tick, not one per task."""
        from tpu_faas_torch.core.task import FIELD_STATUS

        if not items:
            return
        cmds = []
        for task_id, extra in items:
            fields = {FIELD_STATUS: str(status), **(extra or {})}
            cmds.append(
                ("HSET", task_id, *(p for kv in fields.items() for p in kv))
            )
        errors = [
            r for r in self.pipeline(cmds) if isinstance(r, resp.RespError)
        ]
        if errors:
            raise errors[0]

    def finish_task_many(self, items, inline_max: int = 0) -> None:
        """Batch finish_task in a bounded number of round trips: one
        pipelined status pre-read for the first_wins slice (the frozen
        probe ``_result_frozen`` pays per task on the loop default), then
        every surviving write+index-drop+announce in ONE pipelined round —
        each task's announce still follows its own record write (RESP
        pipelines execute in order). Intra-batch first_wins is preserved
        by tracking ids already written earlier in the batch.

        Like the single finish_task, a connection loss retries the whole
        round once on a fresh connection: HSET replays to the same end
        state and duplicate RESULTS_CHANNEL publishes are tolerated
        spurious wakes.

        On a negotiated binary-batch connection the whole batch — pre-read
        included — is ONE MFINISH command: the server evaluates the
        first_wins freeze set against its own state (identical semantics,
        pinned by tests/test_store_resp.py), saving both the pre-read
        round trip and the 3N-command pipeline build. MFINISH replays to
        the same end state (re-applied fw items are frozen by their own
        first write), so _command's idempotent reconnect-retry applies."""
        from tpu_faas_torch.core.task import FIELD_STATUS, TaskStatus

        if not items:
            return
        # digest-form items (result-blob plane, 6-tuples with a digest)
        # carry fields the MFINISH wire has no slots for: the batch then
        # takes the pipelined slow path below, which shares _finish_cmds
        # with the single write. Legacy 4-tuple batches keep the one-command
        # fast path untouched.
        any_digest = any(len(it) > 4 and it[4] for it in items)
        if self._binbatch_on() and not any_digest:
            flat: list[str] = []
            for task_id, status, result, fw in (it[:4] for it in items):
                flat += [task_id, str(status), result, "1" if fw else "0"]
            try:
                self._command(
                    "MFINISH", repr(time.time()), int(inline_max),
                    len(items), *flat,
                )
                return
            except resp.RespError:
                pass  # peer changed under us: slow path below
        fw_ids = list(
            dict.fromkeys(it[0] for it in items if it[3])
        )
        frozen: set[str] = set()
        if fw_ids:
            for t_id, status in zip(fw_ids, self.hget_many(fw_ids, FIELD_STATUS)):
                if isinstance(status, resp.RespError):
                    status = None  # unparseable: freeze (never overwrite)
                if status == str(TaskStatus.CANCELLED):
                    continue  # a late real result lawfully overwrites
                if TaskStatus.terminal_str(status, unknown=True):
                    frozen.add(t_id)
        now = repr(time.time())
        cmds: list[tuple] = []
        written: set[str] = set()
        for item in items:
            task_id, status, result, first_wins = item[:4]
            if first_wins and (task_id in written or task_id in frozen):
                continue
            cmds.extend(
                self._finish_cmds(
                    task_id, status, result, now, inline_max,
                    result_digest=item[4] if len(item) > 4 else None,
                    result_size=int(item[5]) if len(item) > 5 else 0,
                )
            )
            written.add(task_id)
        if not cmds:
            return
        try:
            replies = self.pipeline(cmds)
        except (ConnectionError, TimeoutError):
            replies = self.pipeline(cmds)  # same rationale as finish_task
        errors = [r for r in replies if isinstance(r, resp.RespError)]
        if errors:
            raise errors[0]

    def put_blob(self, digest: str, data: str) -> bool:
        """Base semantics (setnx'd data + TTL-stamp refresh) in ONE
        pipelined round trip — the gateway pays this on every function
        registration, not per task."""
        key = blob_key(digest)
        replies = self.pipeline(
            [
                ("HSETNX", key, BLOB_DATA_FIELD, data),
                ("HSET", key, BLOB_AT_FIELD, repr(time.time())),
            ]
        )
        errors = [r for r in replies if isinstance(r, resp.RespError)]
        if errors:
            raise errors[0]
        return replies[0] == 1

    def create_tasks(
        self, tasks, channel: str = TASKS_CHANNEL, status=None
    ) -> None:
        from tpu_faas_torch.core.task import (
            FIELD_FN,
            FIELD_PARAMS,
            FIELD_RESULT,
            FIELD_STATUS,
            TaskStatus,
        )

        if status is None:
            status = TaskStatus.QUEUED
        commands: list[tuple] = []
        if tasks:
            # live-index entries first (same ordering rationale as
            # base.create_task), all ids in one variadic HSET
            commands.append(
                (
                    "HSET", LIVE_INDEX_KEY,
                    *(p for task in tasks for p in (task[0], "1")),
                )
            )
        for task in tasks:
            task_id, fn_payload, param_payload = task[:3]
            extra = task[3] if len(task) > 3 else None
            extra_args: list[str] = []
            for k, v in (extra or {}).items():
                extra_args += [k, v]
            commands.append(
                (
                    "HSET", task_id,
                    *extra_args,
                    FIELD_STATUS, str(status),
                    FIELD_FN, fn_payload,
                    FIELD_PARAMS, param_payload,
                    FIELD_RESULT, "None",
                )
            )
        # announces AFTER every hash write: a dispatcher must never receive
        # an announce for a task whose payloads aren't readable yet
        for task in tasks:
            commands.append(("PUBLISH", channel, task[0]))
        replies = self.pipeline(commands)
        # pipeline() returns error replies in place; swallowing one here
        # would hand the caller task_ids for tasks that were never written
        # (announced ghosts) or never announced (stranded until a rescan)
        errors = [r for r in replies if isinstance(r, resp.RespError)]
        if errors:
            raise errors[0]

    def keys(self) -> list[str]:
        return self._command("KEYS", "*")

    # -- announce bus ------------------------------------------------------
    def publish(self, channel: str, payload: str) -> None:
        self._command("PUBLISH", channel, payload)

    def publish_many(self, channel: str, payloads: list[str]) -> None:
        """One pipelined round of PUBLISHes (the batched keyed-create's
        announce fan-out)."""
        if not payloads:
            return
        replies = self.pipeline(
            [("PUBLISH", channel, p) for p in payloads]
        )
        errors = [r for r in replies if isinstance(r, resp.RespError)]
        if errors:
            raise errors[0]

    def subscribe(self, channel: str) -> Subscription:
        # store=self: a multi-endpoint subscription follows the command
        # path's settled endpoint across failovers (single-endpoint
        # handles behave exactly as before — the provider returns the one
        # endpoint forever)
        return _RespSubscription(self.host, self.port, channel, store=self)

    # -- high availability (store/replication.py) --------------------------
    def replay_announces(
        self, after: int
    ) -> tuple[int, list[tuple[str, str]]]:
        """Drain the server's bounded announce ring: entries published
        with replication offset > ``after``, plus the current tail
        offset. ``after=-1`` fetches the tail alone (offset priming).
        The dispatcher's post-failover re-arm calls this on the promoted
        replica to re-discover announces the dead primary published that
        nobody drained. Raises RespError on servers without REPLAY (a
        plain Redis) — callers degrade to rescan-only re-arm."""
        reply = self._command("REPLAY", int(after))
        if not isinstance(reply, list) or not reply or not isinstance(reply[0], int):
            raise resp.RespError(f"unexpected REPLAY reply: {reply!r}")
        tail = reply[0]
        entries = list(zip(reply[1::2], reply[2::2]))
        return tail, entries

    def promote(self) -> int:
        """Promote the ACTIVE endpoint (operator action / failover
        controller): a replica takes the primary role and bumps the
        fencing epoch, which this client adopts immediately. Idempotent
        against an already-primary endpoint."""
        epoch = self._command("PROMOTE")
        if isinstance(epoch, int):
            self.known_epoch = max(self.known_epoch, epoch)
        return epoch

    def role(self) -> dict:
        """The active endpoint's replication role: ``{"role", "epoch",
        "offset"}`` (role is ``primary`` | ``replica`` | ``fenced``)."""
        reply = self._command("ROLE")
        if not (isinstance(reply, list) and len(reply) == 3):
            raise resp.RespError(f"unexpected ROLE reply: {reply!r}")
        return {"role": reply[0], "epoch": reply[1], "offset": reply[2]}

    # -- admin -------------------------------------------------------------
    def save(self, path: str | None = None) -> None:
        """Ask the server to checkpoint (to `path`, or its configured
        --snapshot file when omitted). Raises RespError if neither exists."""
        if path is None:
            self._command("SAVE")
        else:
            self._command("SAVE", path)

    def flush(self) -> None:
        self._command("FLUSHDB")

    def ping(self) -> bool:
        return self._command("PING") == "PONG"

    def info(self) -> dict[str, str]:
        """Server introspection: parse INFO's "key:value" lines (both the
        Python and native servers emit the same format)."""
        raw = self._command("INFO") or ""
        out: dict[str, str] = {}
        for line in raw.split("\n"):
            key, sep, value = line.partition(":")
            if sep:
                out[key] = value
        return out

    def close(self) -> None:
        self._closed = True  # before taking the lock: fail fast either way
        with self._lock:
            if self._conn is not None:
                self._conn.close()
                self._conn = None
