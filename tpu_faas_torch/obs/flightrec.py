"""Fleet flight recorder: a bounded per-process ring of structured events.

A p999 outlier's histogram bucket tells you *that* it happened; the
flight recorder tells you what the process was doing *around* it. Each
metrics-owning process (gateway, dispatcher) keeps one bounded,
lock-cheap ring of small structured events — tick records (pending /
inflight / dispatched counts, device dispatch count, solver backend),
hedge decisions with their scores, tenant deficit snapshots, express-gate
verdicts, admission/brownout sheds, columnar arena fallbacks — each
stamped with a wall-clock time and, where the emitting site has one, the
task/trace id, so an assembled ``/trace`` timeline joins back to its
tick-local context.

Design constraints, in order:

- **emit() must be hot-loop cheap.** One short lock, one deque append,
  no serialization, no clock syscalls beyond the one stamp. Sites emit
  from the dispatcher tick and the gateway result path; a recorder that
  costs anything measurable there would distort the thing it records.
- **Bounded, always.** ``deque(maxlen=capacity)`` — the ring can never
  grow past capacity regardless of emit rate; overwritten events are
  counted (``dropped``) not silent.
- **Readable while written.** ``snapshot()`` copies under the same lock
  (capacity is small, the copy is microseconds) so HTTP scrapes race
  cleanly against emitters; a ``since`` cursor makes polling
  incremental.

Served as ``GET /flightrec?since=N`` on the gateway and the dispatcher
stats server, and dumped to the log on SIGTERM (``install_sigterm``) so
a killed process leaves its last seconds behind.
"""

from __future__ import annotations

import json
import signal
import threading
import time
from collections import deque

__all__ = ["FlightRecorder", "install_sigterm"]

#: default ring capacity (events); ~200 bytes/event keeps the worst-case
#: resident cost around 1 MB per process
DEFAULT_CAPACITY = 4096


class FlightRecorder:
    """One process's bounded event ring. Thread-safe; emit is O(1)."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY, clock=time.time):
        if capacity < 1:
            raise ValueError("flight recorder capacity must be >= 1")
        self.capacity = int(capacity)
        self.clock = clock
        self._buf: deque[tuple[int, float, str, dict]] = deque(
            maxlen=self.capacity
        )
        self._seq = 0
        self._lock = threading.Lock()
        #: operator hint: a disabled recorder (capacity 1 via env, say)
        #: still answers /flightrec honestly
        self.enabled = True

    # -- write side --------------------------------------------------------
    def emit(self, kind: str, **fields) -> int:
        """Append one event; returns its sequence number. ``fields`` must
        already be JSON-representable scalars/short lists — emit does NOT
        serialize or validate (hot-loop budget), /flightrec does."""
        t = self.clock()
        with self._lock:
            self._seq += 1
            seq = self._seq
            self._buf.append((seq, t, kind, fields))
        return seq

    # -- read side ---------------------------------------------------------
    def snapshot(self, since: int = 0, limit: int = 0) -> dict:
        """Events with seq > ``since`` (oldest first), plus cursor state.

        ``cursor`` is the newest seq (pass it back as ``since`` to poll
        incrementally); ``dropped`` counts events overwritten before any
        reader saw the ring this deep. ``limit`` > 0 truncates to the
        NEWEST that many matching events (post-mortems want the end).
        """
        with self._lock:
            cursor = self._seq
            events = list(self._buf)
        oldest_held = events[0][0] if events else cursor + 1
        out = [e for e in events if e[0] > since]
        truncated = 0
        if limit and limit > 0 and len(out) > limit:
            truncated = len(out) - limit
            out = out[-limit:]
        return {
            "cursor": cursor,
            "capacity": self.capacity,
            # events emitted but no longer held (ring overwrote them)
            "dropped": max(0, oldest_held - 1),
            "truncated": truncated,
            "events": [
                {"seq": seq, "t": round(t, 6), "kind": kind, **fields}
                for (seq, t, kind, fields) in out
            ],
        }

    def dump_json(self, since: int = 0) -> str:
        """The snapshot as compact JSON (HTTP body / SIGTERM dump)."""
        return json.dumps(
            self.snapshot(since=since), separators=(",", ":"), default=str
        )


def install_sigterm(recorder: FlightRecorder, log) -> bool:
    """Dump the ring through ``log.warning`` on SIGTERM, then chain to the
    previous handler (or re-raise the default die). Returns False without
    touching handlers when not on the main thread (signal.signal raises
    there) or on platforms without SIGTERM — callers treat the dump as
    best-effort."""
    try:
        prev = signal.getsignal(signal.SIGTERM)
    except (ValueError, AttributeError, OSError):
        return False

    def _on_term(signum, frame):
        try:
            log.warning("flightrec SIGTERM dump: %s", recorder.dump_json())
        except Exception:
            pass  # dying anyway; the dump must never block the exit
        if callable(prev) and prev not in (signal.SIG_IGN, signal.SIG_DFL):
            prev(signum, frame)
        else:
            signal.signal(signal.SIGTERM, signal.SIG_DFL)
            signal.raise_signal(signal.SIGTERM)

    try:
        signal.signal(signal.SIGTERM, _on_term)
    except (ValueError, OSError):
        # not the main thread (tests, embedded use): skip quietly
        return False
    return True
