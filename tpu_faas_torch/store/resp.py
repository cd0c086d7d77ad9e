"""RESP2 wire protocol: encoder + incremental decoder.

The store servers (Python asyncio fallback and the native C++ server) and the
:class:`tpu_faas.store.client.RespStore` client speak the Redis Serialization
Protocol v2 — the same wire format the reference's redis-py dependency uses —
so the framework's store is drop-in swappable with a real Redis and vice
versa. Only the types the store needs are implemented: simple strings,
errors, integers, bulk strings (incl. nil), and arrays.

This module is pure (no IO): `encode_command` builds client->server request
arrays; `RespParser` is a push parser fed raw bytes and yielding decoded
replies, usable from both asyncio and blocking-socket code.
"""

from __future__ import annotations

CRLF = b"\r\n"


class RespError(Exception):
    """Server-reported error reply (`-ERR ...`)."""


class ProtocolError(Exception):
    """Malformed RESP bytes on the wire; the connection should be dropped."""


def encode_command(*parts: str | bytes | int) -> bytes:
    """Encode a command as a RESP array of bulk strings."""
    out = [b"*%d\r\n" % len(parts)]
    for p in parts:
        if isinstance(p, int):
            p = str(p).encode()
        elif isinstance(p, str):
            p = p.encode("utf-8")
        out.append(b"$%d\r\n" % len(p))
        out.append(p)
        out.append(CRLF)
    return b"".join(out)


def encode_simple(s: str) -> bytes:
    return b"+" + s.encode() + CRLF


def encode_error(msg: str) -> bytes:
    return b"-ERR " + msg.encode() + CRLF


def encode_integer(n: int) -> bytes:
    return b":%d\r\n" % n


def encode_bulk(s: str | bytes | None) -> bytes:
    if s is None:
        return b"$-1\r\n"
    if isinstance(s, str):
        s = s.encode("utf-8")
    return b"$%d\r\n" % len(s) + s + CRLF


def encode_array(items: list[bytes]) -> bytes:
    """Encode an array whose elements are already RESP-encoded."""
    return b"*%d\r\n" % len(items) + b"".join(items)


class RespParser:
    """Incremental RESP parser: feed() bytes, pop complete replies.

    Decoded values: simple string -> str, integer -> int, bulk -> str | None,
    array -> list (recursively decoded), error -> RespError instance (returned,
    not raised, so callers decide).

    ``pop(raw=True)`` returns bulk strings as ``bytes`` instead of decoding
    them to ``str`` — the binary-batch fast path (MHGETALL/MFINISH, see
    store/client.py) reads whole record payloads without a per-field utf-8
    round trip; simple strings, errors, and integers decode identically in
    both modes, so control replies are mode-agnostic.
    """

    def __init__(self) -> None:
        self._buf = bytearray()

    def feed(self, data: bytes) -> None:
        self._buf.extend(data)

    def pop(self, raw: bool = False):
        """Return the next complete decoded reply, or the NEED_MORE sentinel
        when the buffer holds only a partial reply.

        Raises :class:`ProtocolError` on malformed bytes; the buffer is
        cleared first so a poisoned connection fails once, not forever."""
        try:
            result, consumed = _parse(self._buf, 0, raw=raw)
        except (ValueError, ProtocolError) as exc:
            self._buf.clear()
            raise ProtocolError(f"malformed RESP input: {exc}") from exc
        if result is NEED_MORE:
            return NEED_MORE
        del self._buf[:consumed]
        return result

    def pending(self) -> int:
        """Bytes buffered but not yet parsed into a complete reply."""
        return len(self._buf)

    def pop_all(self, raw: bool = False) -> list:
        out = []
        while True:
            item = self.pop(raw=raw)
            if item is NEED_MORE:
                return out
            out.append(item)


class _NeedMore:
    __slots__ = ()

    def __repr__(self) -> str:
        return "<NEED_MORE>"


NEED_MORE = _NeedMore()


def _find_crlf(buf: bytearray, start: int) -> int:
    return buf.find(CRLF, start)


def _parse(buf: bytearray, pos: int, raw: bool = False):
    """Parse one value at pos. Return (value | NEED_MORE, end_pos).

    ``raw=True`` leaves bulk strings as bytes (no utf-8 decode) — the
    binary-batch reply path; every other reply type is unaffected."""
    if pos >= len(buf):
        return NEED_MORE, pos
    kind = buf[pos : pos + 1]
    line_end = _find_crlf(buf, pos + 1)
    if line_end < 0:
        return NEED_MORE, pos
    line = bytes(buf[pos + 1 : line_end])
    body_start = line_end + 2
    if kind == b"+":
        return line.decode("utf-8"), body_start
    if kind == b"-":
        return RespError(line.decode("utf-8")), body_start
    if kind == b":":
        return int(line), body_start
    if kind == b"$":
        n = int(line)
        if n == -1:
            return None, body_start
        end = body_start + n + 2
        if len(buf) < end:
            return NEED_MORE, pos
        body = bytes(buf[body_start : body_start + n])
        return (body if raw else body.decode("utf-8")), end
    if kind == b"*":
        n = int(line)
        if n == -1:
            return None, body_start
        items = []
        cur = body_start
        for _ in range(n):
            item, cur = _parse(buf, cur, raw=raw)
            if item is NEED_MORE:
                return NEED_MORE, pos
            items.append(item)
        return items, cur
    raise ProtocolError(f"bad RESP type byte {kind!r}")
