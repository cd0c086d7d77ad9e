"""Store snapshot format: checkpoint/resume for the task store.

The reference has no durability story at all — a restarted Redis (or a
restarted store) loses every task hash, and SURVEY §5.4 records
checkpoint/resume as absent. Here the store can checkpoint its entire
hash table to a file and reload it at startup, so task statuses and
results survive a store restart.

Format: the snapshot file is a plain sequence of RESP-encoded commands —
``HSET key field value [field value ...]`` for live state plus ``DEL
key [key ...]`` / ``HDEL key field [field ...]`` deletion records — i.e.
a replayable command log, like a one-shot Redis AOF, applied strictly in
order. Because it *is* the wire protocol, the identical format is written
and read by the Python asyncio server (tpu_faas/store/server.py), the
native C++ server (native/store_server.cpp), the in-proc MemoryStore,
AND the replication full-sync payload (tpu_faas/store/replication.py),
with no second serialization scheme to keep in sync. Writes are atomic
(tmp-file + rename), so a crash mid-save leaves the previous snapshot
intact.

Why deletion records: a pure HSET dump cannot *express* a deletion, so
any consumer that merges or replays logs (concatenated snapshots, a
snapshot followed by a replicated command stream) would resurrect
GC'd blobs and deleted live-index entries. The servers track keys
deleted since their last checkpoint and write them as ``DEL`` records,
making every snapshot explicit about what is known-gone, and making the
replication stream's DEL/HDEL traffic representable in the one shared
format.
"""

from __future__ import annotations

import os
from typing import Iterable, Mapping

from tpu_faas_torch.store import resp


def dump_hashes(
    hashes: Mapping[str, Mapping[str, str]],
    deleted: Iterable[str] = (),
) -> bytes:
    """Serialize a dict-of-hashes as replayable RESP HSET commands,
    followed by one ``DEL`` record for the ``deleted`` keys (keys removed
    since the last checkpoint — see module docstring)."""
    out: list[bytes] = []
    for key, fields in hashes.items():
        if not fields:
            continue  # HSET needs >=1 pair; empty hashes are unreachable anyway
        flat: list[str] = []
        for f, v in fields.items():
            flat.extend((f, v))
        out.append(resp.encode_command("HSET", key, *flat))
    # deletions AFTER the state dump: replay order must leave a key that
    # is both dumped and tombstoned (a caller bug) absent, never revived
    gone = [k for k in deleted if k not in hashes or not hashes[k]]
    if gone:
        out.append(resp.encode_command("DEL", *gone))
    return b"".join(out)


def load_hashes(data: bytes) -> dict[str, dict[str, str]]:
    """Replay a snapshot byte string into a dict-of-hashes, applying
    HSET / DEL / HDEL records strictly in order (so a log that is a state
    dump plus appended mutations — e.g. a replicated command stream —
    replays to the correct end state, deletions included).

    Raises :class:`resp.ProtocolError` on malformed bytes or any other
    command — a corrupt snapshot should fail loudly at startup, not load
    half a database silently.
    """
    parser = resp.RespParser()
    parser.feed(data)
    hashes: dict[str, dict[str, str]] = {}
    while True:
        item = parser.pop()
        if item is resp.NEED_MORE:
            if parser.pending():
                raise resp.ProtocolError(
                    f"snapshot ends with {parser.pending()} trailing bytes "
                    "(truncated entry)"
                )
            break
        if not isinstance(item, list) or not item:
            raise resp.ProtocolError(f"snapshot contains non-command entry: {item!r}")
        name = item[0].upper() if isinstance(item[0], str) else None
        if name == "HSET" and len(item) >= 4 and len(item) % 2 == 0:
            h = hashes.setdefault(item[1], {})
            for f, v in zip(item[2::2], item[3::2]):
                h[f] = v
        elif name == "DEL" and len(item) >= 2:
            for key in item[1:]:
                hashes.pop(key, None)
        elif name == "HDEL" and len(item) >= 3:
            h = hashes.get(item[1])
            if h is not None:
                for f in item[2:]:
                    h.pop(f, None)
                if not h:  # Redis semantics: empty hash = absent key
                    hashes.pop(item[1], None)
        else:
            raise resp.ProtocolError(
                f"snapshot contains unsupported entry: {item!r}"
            )
    return hashes


def save_file(
    path: str,
    hashes: Mapping[str, Mapping[str, str]],
    deleted: Iterable[str] = (),
) -> None:
    """Atomically write a snapshot: write tmp in the same dir, fsync, rename."""
    tmp = f"{path}.tmp.{os.getpid()}"
    data = dump_hashes(hashes, deleted)
    with open(tmp, "wb") as fh:
        fh.write(data)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)


def load_file(path: str) -> dict[str, dict[str, str]]:
    """Load a snapshot file; a missing file is an empty store (first boot)."""
    try:
        with open(path, "rb") as fh:
            data = fh.read()
    except FileNotFoundError:
        return {}
    return load_hashes(data)
