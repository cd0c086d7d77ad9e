"""Content addressing for serialized payloads: digests + a bounded LRU.

The payload plane (OPERATIONS.md "Payload plane") ships *references* to hot
payload bytes instead of the bytes themselves: a serialized function is
written once under a ``blob:<sha256>`` store key, task records and dispatch
messages carry the digest, and every hop keeps a bounded cache keyed by it.
This module holds the two primitives every layer shares — the digest
function (sha256 over the ASCII payload, hex; collision-safe content
addressing, stable across producers/hosts/restarts) and a byte-bounded LRU
used by the dispatcher's blob cache and the workers' payload cache.

Distinct from :func:`tpu_faas.sched.estimator.fn_digest` (a short blake2b
IDENTITY key for runtime learning): blob digests address CONTENT the system
will re-materialize from, so they use the full sha256 — a collision there
would execute the wrong function.
"""

from __future__ import annotations

from collections import OrderedDict

import hashlib


def payload_digest(payload: str) -> str:
    """sha256 hex digest of a serialized (ASCII) payload — the blob key
    suffix and the ``fn_digest`` task/wire field."""
    return hashlib.sha256(payload.encode("ascii", "replace")).hexdigest()


#: Result-blob plane (``--result-blobs``): the default minimum result size
#: that ships as a digest instead of a body. Below this the digest (64 hex
#: chars) plus the bookkeeping costs more than the bytes it replaces; the
#: default tracks the express lane's inline bound (store/base.py
#: RESULT_INLINE_MAX_BYTES) so "small enough to inline" and "too small to
#: blob" agree out of the box.
RESULT_BLOB_MIN_BYTES = 4096


class PayloadLRU:
    """Bounded digest -> payload cache, evicting least-recently-used.

    Bounded by TOTAL PAYLOAD BYTES, not entry count: one cache must serve
    both a thousand tiny lambdas and a handful of multi-MB model closures
    without the operator retuning it. A single payload larger than the
    whole budget is still admitted alone (refusing it would disable the
    cache exactly for the payloads that are most expensive to re-fetch).
    Not thread-safe; every owner drives it from one loop."""

    __slots__ = ("max_bytes", "_items", "_bytes", "hits", "misses")

    def __init__(self, max_bytes: int = 256 * 1024 * 1024) -> None:
        self.max_bytes = int(max_bytes)
        self._items: OrderedDict[str, str] = OrderedDict()
        self._bytes = 0
        self.hits = 0
        self.misses = 0

    def get(self, digest: str) -> str | None:
        payload = self._items.get(digest)
        if payload is None:
            self.misses += 1
            return None
        self._items.move_to_end(digest)
        self.hits += 1
        return payload

    def put(self, digest: str, payload: str) -> None:
        old = self._items.pop(digest, None)
        if old is not None:
            self._bytes -= len(old)
        self._items[digest] = payload
        self._bytes += len(payload)
        while self._bytes > self.max_bytes and len(self._items) > 1:
            _, evicted = self._items.popitem(last=False)
            self._bytes -= len(evicted)

    def __contains__(self, digest: str) -> bool:
        return digest in self._items

    def __len__(self) -> int:
        return len(self._items)

    @property
    def n_bytes(self) -> int:
        return self._bytes
