"""Federated control plane, store side: consistent-hash sharding.

Two pieces compose the single-store stack into a fleet (ROADMAP item 1):

- :class:`HashRing` — a deterministic consistent-hash ring mapping any
  store key to a shard index. Virtual nodes keep the key mass balanced,
  and adding/removing a shard moves only ~1/N of the keyspace (pinned by
  property tests) — a resize re-homes a bounded slice instead of
  reshuffling the world.
- :class:`ShardedStore` — a :class:`~tpu_faas.store.base.TaskStore` over
  N backend stores. Single-key ops route by the ring; the pipelined
  batch forms (``hgetall_many``, ``finish_task_many``,
  ``create_tasks_if_absent``, ...) partition their items by shard and fan
  the per-shard sub-batches out CONCURRENTLY, merging replies back into
  input order — a 4-shard batch pays roughly one shard's latency, not
  four. Every task-level convenience inherited from the base class keeps
  working because it is built from the routed primitives, including the
  graph promotion plane: ``complete_dep_many`` walks cross-shard
  dependency edges through the sharded batch ops, so a parent on shard A
  promotes (or poisons) its children on shard B with no extra machinery.

Routing rules (all deterministic, shared by every client of the fleet):

- task hashes (and any other plain key: ``trace:`` span hashes,
  ``function_digest:`` index entries, estimator state) route by
  ``ring(key)`` — the content-addressed ``blob:<sha256>`` and
  ``function_digest:<sha256>`` namespaces therefore shard by digest for
  free, since the digest IS the key;
- the live-task index (``tasks:index``) routes by FIELD (the task id):
  each shard carries the index slice for its own tasks, which is what
  scopes a dispatcher's stranded-task rescan to its owned shards;
- the fleet coordination hashes (``fleet:health``, ``dispatchers:alive``,
  ``fleet:lease_conf``) are BROADCAST on write and MERGED on read: a
  dispatcher's ~1 Hz capacity snapshot lands on every shard, and a
  gateway's admission refresh reads all shards and keeps the freshest
  copy per field — any single surviving shard can answer the aggregation;
- announce/result publishes route by the task id embedded in the payload
  (control prefixes like ``!cancel:`` stripped first), so a shard's
  announce bus carries exactly its own tasks' traffic.

Ownership: ``owned_shards`` scopes the *consumption* surface — announce
subscriptions, ``keys()``, the live-index scan, and announce replay — to
a dispatcher's slice while every shard stays reachable for writes (graph
edges, reclaims, fleet hashes). ``None`` (the gateway default) means all
shards: gateways are fully stateless over the ring and any of them can
route any task's ``/result`` or ``/trace``.

Per-shard failover composes with store HA (store/replication.py): each
"shard" may itself be a multi-endpoint failover ring
(``resp://p1:6380,r1:6480;p2:6381,r2:6481`` = two shards, each a
primary+replica pair), and ``failover_generation`` sums the shards' so a
dispatcher's re-arm triggers when ANY of its shards promotes.
"""

from __future__ import annotations

import hashlib
import threading
import time
import weakref
from bisect import bisect_right
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Mapping

from tpu_faas_torch.obs import REGISTRY
from tpu_faas_torch.store.base import (
    BLOBREQ_ANNOUNCE_PREFIX,
    CANCEL_ANNOUNCE_PREFIX,
    DISPATCHERS_KEY,
    KILL_ANNOUNCE_PREFIX,
    LEASE_CONF_KEY,
    LIVE_INDEX_KEY,
    RESULT_DIGEST_PREFIX,
    RESULT_INLINE_PREFIX,
    TASKS_CHANNEL,
    TENANT_CONF_KEY,
    Subscription,
    TaskStore,
    decode_result_announce,
)

#: Fleet coordination hashes: broadcast writes, merged reads (see module
#: docstring). "fleet:health" is admission/signal.FLEET_HEALTH_KEY —
#: spelled literally here so the store layer does not import the
#: admission package. The tenant-conf hash rides the stamp-tail
#: freshest-wins merge (its values are "<spec>:<epoch>").
FLEET_KEYS = frozenset(
    {"fleet:health", DISPATCHERS_KEY, LEASE_CONF_KEY, TENANT_CONF_KEY}
)

#: Per-shard round trips, summed over this process's sharded clients.
#: A separate family from tpu_faas_store_round_trips_total{backend=}
#: (one exposition family cannot carry two label vocabularies): the
#: un-labeled total keeps counting every trip, this one attributes them.
_SHARD_ROUND_TRIPS = REGISTRY.counter(
    "tpu_faas_store_shard_round_trips_total",
    "Store wire round trips by shard (pipelined batch = 1), summed over "
    "this process's sharded store clients",
    ("shard",),
)
_SHARD_FAILOVERS = REGISTRY.counter(
    "tpu_faas_store_shard_failovers_total",
    "Store endpoint failovers by shard (reconnects that settled on a "
    "different endpoint of that shard's failover ring)",
    ("shard",),
)


def _hash64(data: str) -> int:
    """Stable 64-bit key hash — blake2b, NOT Python's randomized hash():
    every process in the fleet must place every key identically."""
    return int.from_bytes(
        hashlib.blake2b(data.encode("utf-8"), digest_size=8).digest(), "big"
    )


class HashRing:
    """Consistent-hash ring over ``n_shards`` with ``vnodes`` virtual
    nodes per shard. Deterministic across processes and runs; adding or
    removing one shard re-homes ~1/N of keys (property-tested)."""

    def __init__(self, n_shards: int, vnodes: int = 64) -> None:
        if n_shards < 1:
            raise ValueError("a ring needs at least one shard")
        self.n_shards = n_shards
        self.vnodes = vnodes
        points: list[tuple[int, int]] = []
        for shard in range(n_shards):
            for v in range(vnodes):
                points.append((_hash64(f"shard-{shard}#{v}"), shard))
        points.sort()
        self._hashes = [h for h, _ in points]
        self._shards = [s for _, s in points]

    def shard_of(self, key: str) -> int:
        """The shard owning ``key``: first ring point at or after the
        key's hash, wrapping at the top."""
        if self.n_shards == 1:
            return 0
        idx = bisect_right(self._hashes, _hash64(key))
        if idx == len(self._hashes):
            idx = 0
        return self._shards[idx]


class _FanSubscription(Subscription):
    """One logical subscription over several shards' buses: drains each
    shard's subscription round-robin. Non-blocking drains (timeout 0, the
    dispatcher tick pattern) cost one empty poll per shard; a blocking
    drain sleeps in small slices between sweeps (bounded added latency,
    default 5 ms — well under the transport floor)."""

    _SWEEP_SLEEP = 0.005

    def __init__(self, subs: list[Subscription]) -> None:
        self._subs = subs
        self._next = 0

    def get_message(self, timeout: float = 0.0) -> str | None:
        deadline = (
            time.monotonic() + timeout if timeout > 0 else None
        )
        while True:
            for _ in range(len(self._subs)):
                sub = self._subs[self._next]
                self._next = (self._next + 1) % len(self._subs)
                msg = sub.get_message(0.0)
                if msg is not None:
                    return msg
            if deadline is None:
                return None
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return None
            time.sleep(min(self._SWEEP_SLEEP, remaining))

    def pollable_fds(self) -> list[int]:
        """Every shard subscription's readability fd (event-driven serve
        loops register them all; any shard's publish wakes the poll)."""
        fds: list[int] = []
        for sub in self._subs:
            fds.extend(sub.pollable_fds())
        return fds

    def close(self) -> None:
        for sub in self._subs:
            sub.close()


def _trailing_float(raw: str) -> float | None:
    """The float encoded at the tail of a fleet-hash value (capacity
    snapshots end ``:<published_at>``, liveness stamps ARE a float)."""
    try:
        return float(raw.rsplit(":", 1)[-1])
    except (ValueError, IndexError):
        return None


class ShardedStore(TaskStore):
    """TaskStore over N backend shards (see module docstring)."""

    def __init__(
        self,
        stores: list[TaskStore],
        owned_shards: list[int] | None = None,
        ring: HashRing | None = None,
    ) -> None:
        if not stores:
            raise ValueError("ShardedStore needs at least one backend")
        self._stores = list(stores)
        self.ring = ring if ring is not None else HashRing(len(stores))
        if self.ring.n_shards != len(stores):
            raise ValueError(
                f"ring has {self.ring.n_shards} shards, got "
                f"{len(stores)} stores"
            )
        self.owned_shards: list[int] | None = None
        if owned_shards is not None:
            owned = sorted(set(int(i) for i in owned_shards))
            bad = [i for i in owned if not 0 <= i < len(stores)]
            if bad or not owned:
                raise ValueError(
                    f"owned_shards {owned_shards!r} out of range for "
                    f"{len(stores)} shards"
                )
            self.owned_shards = owned
        self._closed = False
        # one fan-out lane per shard: concurrent sub-batches are the
        # whole point (a 4-shard batch pays ~one shard's latency); extra
        # callers queue, which only serializes across caller threads
        self._pool = ThreadPoolExecutor(
            max_workers=min(32, 2 * len(stores)),
            thread_name_prefix="shard-fan",
        )
        # replay cursor table: the dispatcher's single announce-offset int
        # becomes an opaque handle mapping to per-shard ring offsets
        self._cursor_lock = threading.Lock()
        self._cursor_seq = 0
        self._replay_cursors: OrderedDict[int, list[int]] = OrderedDict()
        # per-shard scrape series (process-global registry): deltas of
        # each shard handle's counters folded in at collect time
        self._metrics_lock = threading.Lock()
        self._rt_seen = [0] * len(stores)
        self._fo_seen = [
            getattr(s, "failover_generation", 0) for s in stores
        ]
        self._rt_series = [
            _SHARD_ROUND_TRIPS.labels(shard=str(i))
            for i in range(len(stores))
        ]
        self._fo_series = [
            _SHARD_FAILOVERS.labels(shard=str(i))
            for i in range(len(stores))
        ]
        ref = weakref.ref(self)

        def _collect() -> None:
            live = ref()
            if live is not None and not live._closed:
                live._collect_shard_metrics()

        self._collector = _collect
        REGISTRY.register_collector(_collect)

    # -- topology ----------------------------------------------------------
    @property
    def shard_count(self) -> int:
        return len(self._stores)

    def shard_of(self, task_id: str) -> int:
        """The shard owning a task id (or any plain key)."""
        return self.ring.shard_of(task_id)

    def shard_store(self, index: int) -> TaskStore:
        """The backend handle of one shard (operator/bench surface —
        e.g. promoting one shard's replica)."""
        return self._stores[index]

    def _scope(self) -> list[int]:
        """Shard indices this handle CONSUMES from (subscription, keys,
        live-index scans, replay): the owned slice, or every shard."""
        if self.owned_shards is not None:
            return self.owned_shards
        return list(range(len(self._stores)))

    def shard_failover_generations(self) -> list[int]:
        """Per-shard failover generations (operator/stats surface)."""
        return [
            getattr(s, "failover_generation", 0) for s in self._stores
        ]

    def _collect_shard_metrics(self) -> None:
        with self._metrics_lock:
            for i, s in enumerate(self._stores):
                rt = s.n_round_trips
                if rt > self._rt_seen[i]:
                    self._rt_series[i].inc(rt - self._rt_seen[i])
                    self._rt_seen[i] = rt
                gen = getattr(s, "failover_generation", 0)
                if gen > self._fo_seen[i]:
                    self._fo_series[i].inc(gen - self._fo_seen[i])
                    self._fo_seen[i] = gen

    # -- fan-out machinery -------------------------------------------------
    def _fan(self, calls: dict[int, Callable]) -> dict[int, object]:
        """Run one thunk per shard, concurrently when more than one shard
        is involved. Raises the first failure (by shard order) AFTER every
        thunk finished — a partial fan-out is the same ambiguity as a
        mid-pipeline connection loss, and every caller of the batch forms
        already treats it as an outage (park + replay, idempotent)."""
        if len(calls) == 1:
            (idx, fn), = calls.items()
            return {idx: fn()}
        futures = {
            idx: self._pool.submit(fn) for idx, fn in calls.items()
        }
        out: dict[int, object] = {}
        first_exc: BaseException | None = None
        for idx in sorted(futures):
            try:
                out[idx] = futures[idx].result()
            except BaseException as exc:  # noqa: BLE001 — re-raised below
                if first_exc is None:
                    first_exc = exc
        if first_exc is not None:
            raise first_exc
        return out

    def _partition(self, indexed_items) -> dict[int, list]:
        """(shard, payload) pairs -> shard -> payload list, input order
        preserved within each shard."""
        by_shard: dict[int, list] = {}
        for shard, payload in indexed_items:
            by_shard.setdefault(shard, []).append(payload)
        return by_shard

    # -- payload routing ---------------------------------------------------
    @staticmethod
    def _payload_task_id(payload: str) -> str:
        """The task id embedded in an announce payload (control prefixes
        stripped, express inline result frames decoded) — what publishes
        route by."""
        for prefix in (
            CANCEL_ANNOUNCE_PREFIX,
            KILL_ANNOUNCE_PREFIX,
            BLOBREQ_ANNOUNCE_PREFIX,  # routes by digest, like the blob
        ):
            if payload.startswith(prefix):
                return payload[len(prefix):]
        if payload.startswith(RESULT_INLINE_PREFIX) or payload.startswith(
            RESULT_DIGEST_PREFIX
        ):
            return decode_result_announce(payload)[0]
        return payload

    def _merge_fleet_values(self, key: str, a: str, b: str) -> str:
        """Pick between two shards' copies of one fleet-hash field.
        Liveness/capacity stamps keep the FRESHEST copy (max trailing
        float); the lease-config hash keeps the EARLIEST (its setnx pins
        first-publication time, which gates the adoption grace window)."""
        fa, fb = _trailing_float(a), _trailing_float(b)
        if fa is None:
            return b
        if fb is None:
            return a
        if key == LEASE_CONF_KEY:
            return a if fa <= fb else b
        return a if fa >= fb else b

    # -- raw hash ops ------------------------------------------------------
    def hset(self, key: str, fields: Mapping[str, str]) -> None:
        if key in FLEET_KEYS:
            self._fan(
                {
                    i: (lambda s=s: s.hset(key, fields))
                    for i, s in enumerate(self._stores)
                }
            )
            return
        if key == LIVE_INDEX_KEY:
            by_shard = self._partition(
                (self.ring.shard_of(f), (f, v)) for f, v in fields.items()
            )
            self._fan(
                {
                    i: (
                        lambda i=i, kv=kv: self._stores[i].hset(
                            key, dict(kv)
                        )
                    )
                    for i, kv in by_shard.items()
                }
            )
            return
        self._stores[self.ring.shard_of(key)].hset(key, fields)

    def hget(self, key: str, field: str) -> str | None:
        if key in FLEET_KEYS:
            best: str | None = None
            for got in self._fan(
                {
                    i: (lambda s=s: s.hget(key, field))
                    for i, s in enumerate(self._stores)
                }
            ).values():
                if got is None:
                    continue
                best = (
                    got
                    if best is None
                    else self._merge_fleet_values(key, best, got)
                )
            return best
        if key == LIVE_INDEX_KEY:
            return self._stores[self.ring.shard_of(field)].hget(key, field)
        return self._stores[self.ring.shard_of(key)].hget(key, field)

    def hgetall(self, key: str) -> dict[str, str]:
        if key in FLEET_KEYS:
            merged: dict[str, str] = {}
            for got in self._fan(
                {
                    i: (lambda s=s: s.hgetall(key))
                    for i, s in enumerate(self._stores)
                }
            ).values():
                for f, v in got.items():
                    if f in merged:
                        merged[f] = self._merge_fleet_values(
                            key, merged[f], v
                        )
                    else:
                        merged[f] = v
            return merged
        if key == LIVE_INDEX_KEY:
            # the consumption scope: a dispatcher's rescan walks only its
            # owned shards' index slices; a gateway (owned=None) counts
            # the whole fleet's live tasks
            merged = {}
            for got in self._fan(
                {
                    i: (lambda i=i: self._stores[i].hgetall(key))
                    for i in self._scope()
                }
            ).values():
                merged.update(got)
            return merged
        return self._stores[self.ring.shard_of(key)].hgetall(key)

    def hmget(self, key: str, fields: list[str]) -> list[str | None]:
        return self._stores[self.ring.shard_of(key)].hmget(key, fields)

    def hexists(self, key: str, field: str) -> bool:
        if key in FLEET_KEYS:
            return self.hget(key, field) is not None
        if key == LIVE_INDEX_KEY:
            return self._stores[self.ring.shard_of(field)].hexists(
                key, field
            )
        return self._stores[self.ring.shard_of(key)].hexists(key, field)

    def hdel(self, key: str, *fields: str) -> None:
        if not fields:
            return
        if key in FLEET_KEYS:
            # broadcast: GC of an ancient snapshot must reach every
            # shard's copy, including shards the deleting reader's
            # publisher never wrote
            self._fan(
                {
                    i: (lambda s=s: s.hdel(key, *fields))
                    for i, s in enumerate(self._stores)
                }
            )
            return
        if key == LIVE_INDEX_KEY:
            by_shard = self._partition(
                (self.ring.shard_of(f), f) for f in fields
            )
            self._fan(
                {
                    i: (
                        lambda i=i, fs=fs: self._stores[i].hdel(key, *fs)
                    )
                    for i, fs in by_shard.items()
                }
            )
            return
        self._stores[self.ring.shard_of(key)].hdel(key, *fields)

    def delete(self, key: str) -> None:
        if key in FLEET_KEYS or key == LIVE_INDEX_KEY:
            self._fan(
                {
                    i: (lambda s=s: s.delete(key))
                    for i, s in enumerate(self._stores)
                }
            )
            return
        self._stores[self.ring.shard_of(key)].delete(key)

    def hincrby(self, key: str, field: str, delta: int) -> int:
        return self._stores[self.ring.shard_of(key)].hincrby(
            key, field, delta
        )

    def setnx_field(
        self, key: str, field: str, value: str
    ) -> tuple[bool, str]:
        if key in FLEET_KEYS:
            created_any = False
            best: str | None = None
            for created, current in self._fan(
                {
                    i: (lambda s=s: s.setnx_field(key, field, value))
                    for i, s in enumerate(self._stores)
                }
            ).values():
                created_any = created_any or created
                best = (
                    current
                    if best is None
                    else self._merge_fleet_values(key, best, current)
                )
            return created_any, best if best is not None else value
        return self._stores[self.ring.shard_of(key)].setnx_field(
            key, field, value
        )

    def keys(self) -> list[str]:
        out: list[str] = []
        for got in self._fan(
            {
                i: (lambda i=i: self._stores[i].keys())
                for i in self._scope()
            }
        ).values():
            out.extend(got)
        return out

    # -- pipelined batch forms (partition + concurrent fan-out) ------------
    def _fan_indexed(self, items, shard_of_item, call):
        """Generic ordered batch fan-out: partition ``items`` by
        ``shard_of_item``, run ``call(shard_store, sub_items)`` per shard
        concurrently, and scatter per-shard reply lists back to the
        original item order."""
        items = list(items)
        if not items:
            return []
        by_shard: dict[int, list[tuple[int, object]]] = {}
        for pos, item in enumerate(items):
            by_shard.setdefault(shard_of_item(item), []).append(
                (pos, item)
            )
        replies = self._fan(
            {
                i: (
                    lambda i=i, sub=sub: call(
                        self._stores[i], [it for _pos, it in sub]
                    )
                )
                for i, sub in by_shard.items()
            }
        )
        out = [None] * len(items)
        for i, sub in by_shard.items():
            got = replies[i]
            if got is None:
                continue
            for (pos, _item), value in zip(sub, got):
                out[pos] = value
        return out

    def hget_many(self, keys: list[str], field: str):
        return self._fan_indexed(
            keys,
            self.ring.shard_of,
            lambda s, sub: s.hget_many(sub, field),
        )

    def hgetall_many(self, keys: list[str]):
        return self._fan_indexed(
            keys, self.ring.shard_of, lambda s, sub: s.hgetall_many(sub)
        )

    def hset_many(self, items) -> None:
        plain: list[tuple[str, Mapping[str, str]]] = []
        for key, fields in items:
            if key in FLEET_KEYS:
                # e.g. the shared-mode liveness heartbeat riding the lease
                # renewal round: broadcast like the single-key form
                self.hset(key, fields)
            elif key == LIVE_INDEX_KEY:
                self.hset(key, fields)
            else:
                plain.append((key, fields))
        if not plain:
            return
        self._fan_indexed(
            plain,
            lambda item: self.ring.shard_of(item[0]),
            lambda s, sub: s.hset_many(sub) or [None] * len(sub),
        )

    def setnx_fields(self, items, field: str):
        return self._fan_indexed(
            items,
            lambda item: self.ring.shard_of(item[0]),
            lambda s, sub: s.setnx_fields(sub, field),
        )

    def hsetnx_many(self, items) -> list[bool]:
        return self._fan_indexed(
            items,
            lambda item: self.ring.shard_of(item[0]),
            lambda s, sub: s.hsetnx_many(sub),
        )

    def hincrby_many(self, items) -> list[int]:
        return self._fan_indexed(
            items,
            lambda item: self.ring.shard_of(item[0]),
            lambda s, sub: s.hincrby_many(sub),
        )

    def delete_many(self, keys: list[str]) -> None:
        self._fan_indexed(
            keys,
            self.ring.shard_of,
            lambda s, sub: s.delete_many(sub) or [None] * len(sub),
        )

    def set_status_many(self, status, items) -> None:
        self._fan_indexed(
            items,
            lambda item: self.ring.shard_of(item[0]),
            lambda s, sub: s.set_status_many(status, sub)
            or [None] * len(sub),
        )

    def finish_task(
        self, task_id, status, result, first_wins=False, inline_max=0,
        result_digest=None, result_size=0,
    ):
        # wholesale delegation: the shard client's pipelined form (write +
        # index drop + announce in one round) — index and announce both
        # live on the task's own shard by construction. The digest form
        # rides along untouched: the task record (and its digest FIELDS)
        # route by task id, while the blob BODY the digest names routes by
        # digest (put_blob/get_blob below) — by design on different shards
        # for unrelated keys.
        self._stores[self.ring.shard_of(task_id)].finish_task(
            task_id, status, result,
            first_wins=first_wins, inline_max=inline_max,
            result_digest=result_digest, result_size=result_size,
        )

    def finish_task_many(self, items, inline_max: int = 0) -> None:
        # same-id items stay in one shard's sub-batch in input order, so
        # intra-batch first_wins semantics survive the partition
        self._fan_indexed(
            items,
            lambda item: self.ring.shard_of(item[0]),
            lambda s, sub: s.finish_task_many(sub, inline_max=inline_max)
            or [None] * len(sub),
        )

    def create_tasks(self, tasks, channel=TASKS_CHANNEL, **kw) -> None:
        self._fan_indexed(
            tasks,
            lambda t: self.ring.shard_of(t[0]),
            lambda s, sub: s.create_tasks(sub, channel, **kw)
            or [None] * len(sub),
        )

    def create_tasks_if_absent(self, tasks, channel=TASKS_CHANNEL):
        return self._fan_indexed(
            tasks,
            lambda t: self.ring.shard_of(t[0]),
            lambda s, sub: s.create_tasks_if_absent(sub, channel),
        )

    # -- content-addressed blobs (shard by digest: it IS the key) ----------
    def put_blob(self, digest: str, data: str) -> bool:
        from tpu_faas_torch.store.base import blob_key

        return self._stores[self.ring.shard_of(blob_key(digest))].put_blob(
            digest, data
        )

    def get_blob(self, digest: str) -> str | None:
        from tpu_faas_torch.store.base import blob_key

        return self._stores[self.ring.shard_of(blob_key(digest))].get_blob(
            digest
        )

    def get_blobs(self, digests: list[str]):
        from tpu_faas_torch.store.base import blob_key

        return self._fan_indexed(
            digests,
            lambda d: self.ring.shard_of(blob_key(d)),
            lambda s, sub: s.get_blobs(sub),
        )

    # -- announce bus ------------------------------------------------------
    def publish(self, channel: str, payload: str) -> None:
        shard = self.ring.shard_of(self._payload_task_id(payload))
        self._stores[shard].publish(channel, payload)

    def publish_many(self, channel: str, payloads: list[str]) -> None:
        self._fan_indexed(
            payloads,
            lambda p: self.ring.shard_of(self._payload_task_id(p)),
            lambda s, sub: s.publish_many(channel, sub)
            or [None] * len(sub),
        )

    def subscribe(self, channel: str) -> Subscription:
        scope = self._scope()
        subs: list[Subscription] = []
        try:
            for i in scope:
                subs.append(self._stores[i].subscribe(channel))
        except BaseException:
            for sub in subs:
                sub.close()
            raise
        if len(subs) == 1:
            return subs[0]
        return _FanSubscription(subs)

    # -- failover / announce replay ---------------------------------------
    @property
    def failover_generation(self) -> int:
        """Sum of the shards' generations: any shard promoting bumps it,
        which is exactly the dispatcher re-arm trigger."""
        return sum(
            getattr(s, "failover_generation", 0) for s in self._stores
        )

    def replay_announces(self, after: int):
        """Sharded announce replay. The returned "tail offset" is an
        opaque cursor HANDLE mapping to per-shard ring offsets (the
        dispatcher stores one int and hands it back — the contract is
        monotone-int-shaped, not arithmetic). ``after=-1`` primes every
        consumed shard's tail; an unknown handle (e.g. the 0 the
        dispatcher falls back to after a priming outage) replays each
        shard's whole bounded ring — exactly the single-store fallback
        semantics, deduped at intake."""
        scope = self._scope()
        with self._cursor_lock:
            base = self._replay_cursors.get(after)
            per_shard = (
                list(base)
                if base is not None
                else [0] * len(self._stores)
            )
        tails = list(per_shard)
        entries: list[tuple[str, str]] = []
        if after == -1:
            got = self._fan(
                {
                    i: (lambda i=i: self._stores[i].replay_announces(-1))
                    for i in scope
                }
            )
            for i in scope:
                tails[i] = got[i][0]
        else:
            got = self._fan(
                {
                    i: (
                        lambda i=i: self._stores[i].replay_announces(
                            per_shard[i]
                        )
                    )
                    for i in scope
                }
            )
            for i in scope:
                tail_i, entries_i = got[i]
                tails[i] = tail_i
                entries.extend(entries_i)
        with self._cursor_lock:
            self._cursor_seq += 1
            handle = self._cursor_seq
            self._replay_cursors[handle] = tails
            while len(self._replay_cursors) > 8:
                self._replay_cursors.popitem(last=False)
        return handle, entries

    def rotate_endpoint(self) -> bool:
        """Advance every multi-endpoint shard's failover ring (the
        breaker's half-open hook). True when any shard could rotate."""
        rotated = False
        for s in self._stores:
            fn = getattr(s, "rotate_endpoint", None)
            if fn is not None and fn():
                rotated = True
        return rotated

    @property
    def endpoints(self):
        """The deepest shard's failover ring — what sizes the breaker's
        rotation budget (rotations before a fresh open window must cover
        one full walk of the worst shard's ring)."""
        best: list | None = None
        for s in self._stores:
            eps = getattr(s, "endpoints", None)
            if eps and (best is None or len(eps) > len(best)):
                best = eps
        return best

    def info(self) -> dict:
        """Aggregated HA introspection: worst-case ``role`` (every shard
        must be a writable primary for the fleet to be primary), max
        ``repl_lag``, plus per-shard roles for operators."""
        roles: list[str] = []
        lag = 0.0
        have_lag = False
        for i, s in enumerate(self._stores):
            fn = getattr(s, "info", None)
            info = fn() if fn is not None else {}
            roles.append(str(info.get("role", "primary")))
            try:
                lag = max(lag, float(info["repl_lag"]))
                have_lag = True
            except (KeyError, ValueError, TypeError):
                pass
        role = "primary"
        for r in roles:
            if r != "primary":
                role = r
                break
        out = {
            "role": role,
            "shards": str(len(self._stores)),
            "shard_roles": ",".join(roles),
        }
        if have_lag:
            out["repl_lag"] = repr(lag)
        return out

    # -- instrumentation ---------------------------------------------------
    @property
    def n_round_trips(self) -> int:
        return sum(s.n_round_trips for s in self._stores)

    @property
    def n_bytes_sent(self) -> int:
        return sum(
            getattr(s, "n_bytes_sent", 0) for s in self._stores
        )

    # -- admin -------------------------------------------------------------
    def flush(self) -> None:
        self._fan(
            {i: s.flush for i, s in enumerate(self._stores)}
        )

    def ping(self) -> bool:
        return all(
            self._fan(
                {i: s.ping for i, s in enumerate(self._stores)}
            ).values()
        )

    def save(self, path: str | None = None) -> None:
        """``path=None`` checkpoints every shard to its own configured
        target; an explicit path fans out to ``<path>.shard<i>`` files
        (one file cannot hold N shards' logs)."""
        self._fan(
            {
                i: (
                    lambda i=i: self._stores[i].save(
                        None if path is None else f"{path}.shard{i}"
                    )
                )
                for i in range(len(self._stores))
            }
        )

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        # drop the registry hook (the weakref guard alone would leave one
        # dead closure per closed instance iterating on every render)
        REGISTRY.unregister_collector(self._collector)
        for s in self._stores:
            try:
                s.close()
            except Exception:
                pass
        self._pool.shutdown(wait=False)
