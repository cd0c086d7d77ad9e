"""In-process task store: dict-of-hashes + per-channel fan-out queues.

Thread-safe so a gateway thread, dispatcher thread, and test driver can share
one instance. Pub/sub preserves the reference's fire-and-forget semantics:
messages published while nobody is subscribed are dropped, and each subscriber
gets its own copy (Redis pub/sub behavior the dispatcher relies on — see
SURVEY §5.4 on stranded announcements).
"""

from __future__ import annotations

import queue
import socket
import threading
from typing import Mapping

from tpu_faas_torch.store.base import Subscription, TaskStore


class _MemorySubscription(Subscription):
    def __init__(self, store: "MemoryStore", channel: str) -> None:
        self._store = store
        self._channel = channel
        self._queue: queue.Queue[str] = queue.Queue()
        self._closed = False
        #: lazy self-pipe (socketpair) backing fileno(): created only when
        #: an event-driven consumer asks for it, so the hundreds of
        #: subscriptions a test run creates don't each burn two fds
        self._pipe: tuple[socket.socket, socket.socket] | None = None

    def fileno(self) -> int | None:
        """Readability signal for event-driven serve loops (see
        Subscription.fileno): a self-pipe the publish path pokes. Created
        on first ask; publishes before that never signal (the consumer
        registered the fd before any message it cares about)."""
        if self._closed:
            return None
        if self._pipe is None:
            r, w = socket.socketpair()
            r.setblocking(False)
            w.setblocking(False)
            self._pipe = (r, w)
        return self._pipe[0].fileno()

    def _signal(self) -> None:
        if self._pipe is not None:
            try:
                self._pipe[1].send(b"\x01")
            except (BlockingIOError, OSError):
                pass  # pipe full (consumer behind) or closed: both fine

    def _drain_signal(self) -> None:
        if self._pipe is not None:
            try:
                while self._pipe[0].recv(4096):
                    pass
            except (BlockingIOError, OSError):
                pass

    def get_message(self, timeout: float = 0.0) -> str | None:
        try:
            if timeout > 0:
                return self._queue.get(timeout=timeout)
            return self._queue.get_nowait()
        except queue.Empty:
            # empty queue: drain the wake pipe, then re-check once — a
            # publish landing between the get and the drain leaves its
            # byte for the next poll, so a wake can be spurious but never
            # lost
            self._drain_signal()
            try:
                return self._queue.get_nowait()
            except queue.Empty:
                return None

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self._store._unsubscribe(self._channel, self)
            if self._pipe is not None:
                for s in self._pipe:
                    try:
                        s.close()
                    except OSError:
                        pass
                self._pipe = None


class MemoryStore(TaskStore):
    def __init__(self, snapshot_path: str | None = None) -> None:
        self._lock = threading.RLock()
        self._hashes: dict[str, dict[str, str]] = {}
        self._subs: dict[str, list[_MemorySubscription]] = {}
        # bounded announce-replay ring, same semantics as the RESP
        # servers' (store/replication.py AnnounceRing): lets dispatcher
        # failover re-arm logic be unit-tested without sockets
        from tpu_faas_torch.store.replication import AnnounceRing

        self._ring = AnnounceRing()
        self._ring_offset = 0
        self.snapshot_path = snapshot_path
        if snapshot_path is not None:
            self.load(snapshot_path)

    # -- raw hash ops ------------------------------------------------------
    def hset(self, key: str, fields: Mapping[str, str]) -> None:
        with self._lock:
            self._hashes.setdefault(key, {}).update(fields)

    def setnx_field(
        self, key: str, field: str, value: str
    ) -> tuple[bool, str]:
        # atomic under the store lock (the base default's check-then-set
        # would race between gateway executor threads)
        with self._lock:
            h = self._hashes.setdefault(key, {})
            if field in h:
                return False, h[field]
            h[field] = value
            return True, value

    def hincrby(self, key: str, field: str, delta: int) -> int:
        # atomic under the store lock (the base default's read-modify-write
        # would lose decrements between gateway/dispatcher threads)
        with self._lock:
            h = self._hashes.setdefault(key, {})
            try:
                value = int(h.get(field, "0"))
            except ValueError:
                value = 0
            value += int(delta)
            h[field] = str(value)
            return value

    def hget(self, key: str, field: str) -> str | None:
        with self._lock:
            return self._hashes.get(key, {}).get(field)

    def hgetall(self, key: str) -> dict[str, str]:
        with self._lock:
            return dict(self._hashes.get(key, {}))

    def hdel(self, key: str, *fields: str) -> None:
        with self._lock:
            h = self._hashes.get(key)
            if h is None:
                return
            for f in fields:
                h.pop(f, None)
            if not h:  # Redis semantics: empty hash = absent key
                self._hashes.pop(key, None)

    def delete(self, key: str) -> None:
        with self._lock:
            self._hashes.pop(key, None)

    def keys(self) -> list[str]:
        with self._lock:
            return list(self._hashes)

    # -- announce bus ------------------------------------------------------
    def publish(self, channel: str, payload: str) -> None:
        with self._lock:
            subs = list(self._subs.get(channel, ()))
            self._ring_offset += 1
            self._ring.append(self._ring_offset, channel, payload)
        for sub in subs:
            sub._queue.put(payload)
            sub._signal()

    def replay_announces(
        self, after: int
    ) -> tuple[int, list[tuple[str, str]]]:
        with self._lock:
            tail = self._ring.tail
            if after < 0:
                return tail, []
            return tail, [
                (ch, payload) for _off, ch, payload in self._ring.since(after)
            ]

    def subscribe(self, channel: str) -> Subscription:
        sub = _MemorySubscription(self, channel)
        with self._lock:
            self._subs.setdefault(channel, []).append(sub)
        return sub

    def _unsubscribe(self, channel: str, sub: _MemorySubscription) -> None:
        with self._lock:
            subs = self._subs.get(channel)
            if subs and sub in subs:
                subs.remove(sub)

    # -- checkpoint/resume -------------------------------------------------
    def save(self, path: str | None = None) -> None:
        """Checkpoint all hashes (snapshot.py RESP-log format) to `path`, or
        to the configured ``snapshot_path`` when omitted — same contract as
        RespStore.save() so backends stay URL-swappable."""
        from tpu_faas_torch.store import snapshot

        target = path if path is not None else self.snapshot_path
        if target is None:
            raise ValueError("save() needs a path (no snapshot_path configured)")
        with self._lock:
            hashes = {k: dict(v) for k, v in self._hashes.items()}
        snapshot.save_file(target, hashes)

    def load(self, path: str) -> None:
        """Replace contents with a snapshot file (missing file = empty)."""
        from tpu_faas_torch.store import snapshot

        hashes = snapshot.load_file(path)
        with self._lock:
            self._hashes = hashes

    # -- admin -------------------------------------------------------------
    def flush(self) -> None:
        with self._lock:
            self._hashes.clear()

    def close(self) -> None:
        pass
