"""Streaming replication for the RESP store servers: primary -> replica
command streaming, replica promotion, and epoch fencing.

The store is the last single point of failure on the control path: the
circuit breaker (tpu_faas/admission) makes a store outage *fast*, but
every admitted task is stranded until the primary comes back. This module
makes a store outage *survivable* — a replica tails the primary's write
stream and can be promoted to accept writes, clients fail over to it, and
the dispatcher re-arms via adopt-by-rescan plus an announce-replay round.

Design, riding machinery that already exists:

- **Full sync IS the snapshot format.** On connect a replica sends
  ``REPLSYNC`` and receives ``[epoch, offset, snapshot]`` where the
  snapshot is the replayable RESP command log of tpu_faas/store/snapshot.py
  (now DEL/HDEL-capable) — no second serialization scheme.
- **The stream IS the wire protocol.** After the sync the primary forwards
  every mutating command (HSET/HSETNX/HDEL/DEL/PUBLISH/FLUSHDB) verbatim,
  in execution order, down the same connection; the replica parses them
  with the ordinary RespParser and applies them. Each mutating command
  advances a monotonic **replication offset** shared by both ends; the
  replica acknowledges progress with reply-less ``REPLACK <offset>``
  messages, which is what the primary's lag introspection reports.
- **PUBLISH replication + announce ring.** Replicated PUBLISHes fan out
  to the replica's local subscribers AND land in a bounded in-memory
  announce ring on both ends. After a failover, dispatchers call
  ``REPLAY <offset>`` on the promoted replica to re-discover announces
  that were published on the dead primary but never drained — the
  re-arm half of zero-loss failover (the rescan covers the rest).
- **Promotion is explicit.** A replica refuses mutating commands
  (``-ERR READONLY``) until an operator (or a failover controller) sends
  ``PROMOTE``; promotion stops the replication link, takes the primary
  role, and bumps the **epoch**.
- **Epoch fencing.** Clients declare the highest epoch they have seen
  with ``FENCE <epoch>`` when (and only when) they connect with a
  multi-endpoint configuration. A primary that receives a declaration
  GREATER than its own epoch learns it has been superseded — a
  resurrected old primary — and permanently fences itself: every
  mutating command is refused (``-ERR FENCED``) for every client,
  including epoch-oblivious legacy ones, so stale traffic cannot land
  on a store the fleet has already failed away from.

Single-store deployments never touch any of this: replication is opt-in
(``--replica-of``), single-endpoint clients send no FENCE/ROLE handshake,
and the reference/redis-compat wire surface is unchanged.
"""

from __future__ import annotations

import asyncio
from collections import deque
from dataclasses import dataclass, field

from tpu_faas_torch.store import resp, snapshot
from tpu_faas_torch.utils.backoff import Backoff, BackoffPolicy

#: Commands that mutate store state — the set a replica refuses from
#: ordinary clients, a fenced primary refuses from everyone, and a live
#: primary forwards down its replication streams.
MUTATING_COMMANDS = frozenset(
    {"HSET", "HSETNX", "HINCRBY", "HDEL", "DEL", "PUBLISH", "FLUSHDB"}
)

#: Error prefixes clients can match on (encode_error prepends "-ERR ").
READONLY_ERR = "READONLY replica; send PROMOTE before writing"
FENCED_ERR = "FENCED stale primary (superseded by a higher epoch)"

#: Default bound on the announce ring: enough for any realistic
#: failover window (announces are ~40-byte task ids), small enough that
#: a worst-case REPLAY reply stays far under a megabyte.
ANNOUNCE_RING_SIZE = 10_000

#: How often the replica link acks its applied offset back to the
#: primary (seconds); also the reconnect backoff floor after a lost link.
ACK_PERIOD = 0.5

#: Reconnect schedule after a lost link: starts at the ack cadence and
#: grows to a short cap — a replica hammering a dead primary every
#: 0.5 s forever is wasted log noise, but the cap stays small so
#: promotion-window resyncs (tests wait ~5 s) are never starved. The
#: counter resets after any successful full sync, so a fresh outage on
#: a previously-healthy link retries fast.
RECONNECT_BACKOFF = BackoffPolicy(
    floor_s=ACK_PERIOD, factor=2.0, cap_s=2.0, jitter_lo=0.9, jitter_hi=1.2
)


class AnnounceRing:
    """Bounded ring of ``(offset, channel, payload)`` PUBLISH records.

    The replay backstop for the fire-and-forget announce bus: after a
    failover, announces published on the dead primary but never drained
    by a dispatcher are re-discoverable from the promoted replica's copy
    of the ring (PUBLISH is replicated like any other mutating command).
    """

    def __init__(self, maxlen: int = ANNOUNCE_RING_SIZE) -> None:
        self._ring: deque[tuple[int, str, str]] = deque(maxlen=maxlen)
        self.tail = 0  # offset of the newest entry (0 = nothing yet)

    def append(self, offset: int, channel: str, payload: str) -> None:
        self._ring.append((offset, channel, payload))
        self.tail = offset

    def since(self, after: int) -> list[tuple[int, str, str]]:
        """Entries with offset strictly greater than ``after``, oldest
        first. ``after`` below the ring's head silently returns the whole
        ring — the truncation is the documented bound, and duplicate
        announces are deduped at dispatcher intake anyway."""
        return [e for e in self._ring if e[0] > after]

    def clear(self) -> None:
        self._ring.clear()

    def __len__(self) -> int:
        return len(self._ring)


@dataclass
class ReplicationState:
    """One server's replication-facing state (primary and replica alike)."""

    #: "primary" | "replica"; promotion flips replica -> primary
    role: str = "primary"
    #: monotonic failover generation; a promotion bumps it by one. The
    #: fencing comparator: a server seeing a FENCE declaration above its
    #: own epoch knows it has been superseded.
    epoch: int = 0
    #: count of mutating commands applied (primary: executed; replica:
    #: replayed) — the replication offset both ends track in lockstep
    offset: int = 0
    #: True once a FENCE declaration proved this server superseded;
    #: permanent for the process lifetime (restart to clear — by then the
    #: operator has re-pointed it or wiped it)
    fenced: bool = False
    #: live replica stream targets: writer -> last REPLACK'd offset
    replicas: dict[asyncio.StreamWriter, int] = field(default_factory=dict)
    ring: AnnounceRing = field(default_factory=AnnounceRing)

    def min_acked(self) -> int:
        """The slowest attached replica's acknowledged offset (our own
        offset when no replica is attached — lag 0 by definition)."""
        if not self.replicas:
            return self.offset
        return min(self.replicas.values())

    def lag(self) -> int:
        return max(0, self.offset - self.min_acked())


class ReplicaLink:
    """The replica side of the stream: an asyncio task that connects to
    the primary, full-syncs, then applies the live command stream.

    Reconnects with a short backoff on any link loss (each reconnect is a
    fresh full sync — offsets make partial resync *observable*, not
    implemented; snapshots are cheap at this store's scale). Stops for
    good on promotion or server shutdown.
    """

    def __init__(self, server, host: str, port: int) -> None:
        self.server = server
        self.host = host
        self.port = port
        self._task: asyncio.Task | None = None
        self._stopped = False
        #: True after the first successful full sync (INFO introspection)
        self.synced = False

    def start(self) -> None:
        self._task = asyncio.create_task(self.run())

    def stop(self) -> None:
        self._stopped = True
        if self._task is not None:
            self._task.cancel()

    async def run(self) -> None:
        bo = Backoff(RECONNECT_BACKOFF)
        while not self._stopped:
            try:
                await self._sync_and_tail()
            except asyncio.CancelledError:
                return
            except (
                OSError,
                ConnectionError,
                resp.ProtocolError,
                resp.RespError,  # an -ERR REPLSYNC reply (plain Redis /
                # pre-HA server as the target) must retry-and-log, not
                # silently kill the link task forever
            ) as exc:
                if self.synced:
                    # the link WAS up: this is a fresh outage, not one
                    # more failure in a streak — retry fast again
                    bo.reset()
                self.synced = False
                self.server.note_link_down(exc)
            if self._stopped:
                return
            await asyncio.sleep(bo.next())

    async def _sync_and_tail(self) -> None:
        reader, writer = await asyncio.open_connection(self.host, self.port)
        try:
            writer.write(resp.encode_command("REPLSYNC"))
            await writer.drain()
            parser = resp.RespParser()
            header = await self._read_reply(reader, parser)
            if (
                not isinstance(header, list)
                or len(header) != 3
                or not isinstance(header[0], int)
                or not isinstance(header[1], int)
                or not isinstance(header[2], str)
            ):
                raise resp.ProtocolError(f"bad REPLSYNC reply: {header!r}")
            epoch, offset, snap = header
            self.server.load_replicated_snapshot(
                snapshot.load_hashes(snap.encode("utf-8")), epoch, offset
            )
            self.synced = True
            writer.write(resp.encode_command("REPLACK", offset))
            await writer.drain()
            # -- tail the live stream -----------------------------------
            last_ack = asyncio.get_running_loop().time()
            while not self._stopped:
                item = parser.pop()
                while item is not resp.NEED_MORE:
                    if isinstance(item, list) and item:
                        self.server.apply_replicated(item)
                    item = parser.pop()
                now = asyncio.get_running_loop().time()
                if now - last_ack >= ACK_PERIOD:
                    writer.write(
                        resp.encode_command(
                            "REPLACK", self.server.repl.offset
                        )
                    )
                    await writer.drain()
                    last_ack = now
                try:
                    data = await asyncio.wait_for(
                        reader.read(65536), timeout=ACK_PERIOD
                    )
                except asyncio.TimeoutError:
                    continue  # idle primary: ack timer still ticks above
                if not data:
                    raise ConnectionError("replication stream closed")
                parser.feed(data)
        finally:
            writer.close()

    @staticmethod
    async def _read_reply(reader: asyncio.StreamReader, parser):
        while True:
            item = parser.pop()
            if item is not resp.NEED_MORE:
                if isinstance(item, resp.RespError):
                    raise item
                return item
            data = await reader.read(65536)
            if not data:
                raise ConnectionError("connection closed during REPLSYNC")
            parser.feed(data)


def parse_endpoint(spec: str, default_port: int = 6380) -> tuple[str, int]:
    """``host[:port]`` -> (host, port); shared by --replica-of and the
    multi-endpoint store URL parser."""
    host, sep, port_s = spec.rpartition(":")
    if not sep:
        return spec, default_port
    return host, int(port_s)
