"""A redis-py-surface shim over the tpu_faas RESP store servers.

Purpose: run the REFERENCE dispatcher (`/root/reference/task_dispatcher.py`,
which does ``import redis`` and uses exactly ``Redis(host, port, db)``,
``.hget``, ``.hset(mapping=...)``, ``.pubsub()``/``.subscribe``/
``.get_message()`` — task_dispatcher.py:31-36, 50-51, 85, 170) UNMODIFIED
against our store server, certifying the drop-in-Redis claim from the other
side: their client code, our server.

This is NOT a general redis client — it implements precisely the redis-py
call surface the reference uses, with redis-py's observable semantics:

- ``hget`` returns **bytes** (redis-py default ``decode_responses=False``;
  the reference calls ``.decode('utf-8')`` on it — task_dispatcher.py:50-52)
- ``pubsub().get_message()`` is non-blocking and returns either ``None`` or
  a dict ``{"type": "message", "channel": bytes, "data": bytes}``; the
  reference checks ``msg['type'] == 'message'`` then decodes ``msg['data']``
- ``Redis(host, port, db)`` issues SELECT (our servers accept and ignore it)

Because the reference hardcodes ``localhost:6379`` (task_dispatcher.py:32),
the shim honours ``REDIS_SHIM_HOST`` / ``REDIS_SHIM_PORT`` environment
overrides so the harness can point the unmodified binary at a store bound to
an ephemeral port. Self-contained on purpose (stdlib sockets + a minimal
RESP2 codec): the subprocess certifying interop should not be running the
very client library under test.
"""

from __future__ import annotations

import os
import select
import socket
import time


class RedisError(Exception):
    pass


class _Resp2Connection:
    """One blocking RESP2 connection: command encoder + reply decoder.

    Replies keep redis-py's types: bulk strings come back as ``bytes``,
    integers as ``int``, simple strings as ``str``, nil as ``None``.
    """

    def __init__(self, host: str, port: int, timeout: float = 10.0) -> None:
        self.sock = socket.create_connection((host, port), timeout=timeout)
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._buf = b""

    # -- encoding ----------------------------------------------------------
    @staticmethod
    def _encode(*parts) -> bytes:
        out = [b"*%d\r\n" % len(parts)]
        for p in parts:
            if isinstance(p, str):
                p = p.encode("utf-8")
            elif isinstance(p, (int, float)):
                p = str(p).encode("ascii")
            out.append(b"$%d\r\n%s\r\n" % (len(p), p))
        return b"".join(out)

    def send_command(self, *parts) -> None:
        self.sock.sendall(self._encode(*parts))

    # -- decoding ----------------------------------------------------------
    def _read_until_crlf(self) -> bytes:
        while b"\r\n" not in self._buf:
            self._fill()
        line, _, self._buf = self._buf.partition(b"\r\n")
        return line

    def _read_exact(self, n: int) -> bytes:
        while len(self._buf) < n + 2:
            self._fill()
        body, self._buf = self._buf[:n], self._buf[n + 2 :]
        return body

    def _fill(self) -> None:
        data = self.sock.recv(65536)
        if not data:
            raise ConnectionError("store connection closed")
        self._buf += data

    def read_reply(self):
        line = self._read_until_crlf()
        kind, rest = line[:1], line[1:]
        if kind == b"+":
            return rest.decode("utf-8")
        if kind == b"-":
            raise RedisError(rest.decode("utf-8"))
        if kind == b":":
            return int(rest)
        if kind == b"$":
            n = int(rest)
            return None if n == -1 else self._read_exact(n)
        if kind == b"*":
            n = int(rest)
            return None if n == -1 else [self.read_reply() for _ in range(n)]
        raise RedisError(f"malformed reply line: {line!r}")

    def command(self, *parts):
        self.send_command(*parts)
        return self.read_reply()

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass


def _reply_span(buf: bytes, start: int = 0) -> int | None:
    """Byte length of ONE complete RESP2 reply at ``start``, or None when
    the buffer holds only a partial reply. Pure lookahead — consumes
    nothing — so PubSub.get_message can prove a reply is whole BEFORE
    read_reply's fills touch the socket (the non-blocking contract: a
    partial reply must wait in the buffer, never block a recv)."""
    end = buf.find(b"\r\n", start)
    if end < 0:
        return None
    kind, line = buf[start:start + 1], buf[start + 1:end]
    if kind in (b"+", b"-", b":"):
        return end + 2 - start
    if kind == b"$":
        n = int(line)
        if n == -1:
            return end + 2 - start
        total = end + 2 + n + 2
        return total - start if len(buf) >= total else None
    if kind == b"*":
        n = int(line)
        if n == -1:
            return end + 2 - start
        pos = end + 2
        for _ in range(n):
            span = _reply_span(buf, pos)
            if span is None:
                return None
            pos += span
        return pos - start
    raise RedisError(f"malformed reply line: {buf[start:end]!r}")


def _resolve(host: str, port: int) -> tuple[str, int]:
    return (
        os.environ.get("REDIS_SHIM_HOST", host),
        int(os.environ.get("REDIS_SHIM_PORT", port)),
    )


class PubSub:
    """Dedicated subscription connection with redis-py message dicts."""

    def __init__(self, host: str, port: int) -> None:
        self._host = host
        self._port = port
        self._conn: _Resp2Connection | None = None
        self._channels: list[str] = []

    def subscribe(self, *channels: str) -> None:
        if self._conn is None:
            self._conn = _Resp2Connection(self._host, self._port)
        for ch in channels:
            reply = self._conn.command("SUBSCRIBE", ch)
            if not (isinstance(reply, list) and reply[0] == b"subscribe"):
                raise RedisError(f"unexpected SUBSCRIBE reply: {reply!r}")
            self._channels.append(ch)

    def get_message(self, timeout: float = 0.0):
        """Non-blocking poll for one published message (redis-py shape).

        Subscribe confirmations are consumed in ``subscribe`` itself, so
        every dict returned here has ``type == 'message'`` — a superset of
        what the reference's ``msg['type'] == 'message'`` guard accepts.

        ``read_reply`` is entered only once ``_reply_span`` proves a
        COMPLETE reply is buffered, every socket fill before that point is
        select-guarded, and a reply still partial when ``timeout`` lapses
        stays buffered for the next call — so the non-blocking contract
        holds even when a large published payload arrives split across
        TCP segments (the old fast-path check blocked inside read_reply's
        fills on exactly that shape).
        """
        if self._conn is None:
            return None
        deadline = time.monotonic() + max(timeout, 0.0)
        while _reply_span(self._conn._buf) is None:
            remaining = max(0.0, deadline - time.monotonic())
            ready, _, _ = select.select([self._conn.sock], [], [], remaining)
            if not ready:
                return None  # partial (or nothing) buffered: try later
            self._conn._fill()
        item = self._conn.read_reply()
        if (
            isinstance(item, list)
            and len(item) == 3
            and item[0] == b"message"
        ):
            return {"type": "message", "channel": item[1], "data": item[2]}
        return None

    def close(self) -> None:
        if self._conn is not None:
            self._conn.close()
            self._conn = None


class Redis:
    def __init__(
        self,
        host: str = "localhost",
        port: int = 6379,
        db: int = 0,
        **_ignored,
    ) -> None:
        self._host, self._port = _resolve(host, port)
        self._conn = _Resp2Connection(self._host, self._port)
        if db:
            self._conn.command("SELECT", db)

    def ping(self) -> bool:
        return self._conn.command("PING") == "PONG"

    def hget(self, key, field):
        return self._conn.command("HGET", key, field)

    def hset(self, key, field=None, value=None, mapping=None) -> int:
        flat = []
        if field is not None:
            flat += [field, value]
        for f, v in (mapping or {}).items():
            flat += [f, v]
        return self._conn.command("HSET", key, *flat)

    def hgetall(self, key) -> dict:
        flat = self._conn.command("HGETALL", key) or []
        return dict(zip(flat[0::2], flat[1::2]))

    def publish(self, channel, payload) -> int:
        return self._conn.command("PUBLISH", channel, payload)

    def pubsub(self, **_ignored) -> PubSub:
        return PubSub(self._host, self._port)

    def close(self) -> None:
        self._conn.close()


#: redis-py exposes the client under both names
StrictRedis = Redis
