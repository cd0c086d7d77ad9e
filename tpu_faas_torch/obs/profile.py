"""Device-tick profiling hooks: shape-signature counting + torch.profiler
capture.

Counterpart of ``tpu_faas/obs/profile.py`` on ``torch.profiler``. The
scheduler tick runs against STATIC padded shapes
(``max_pending``/``max_workers``/``max_slots``/placement), so in steady
state every tick has one signature — a new signature mid-serve means a
shape or lane change leaked into the hot loop. :class:`TickProfiler`
detects that from the host side: each tick reports its shape signature, a
signature never seen before is counted (``tpu_faas_jit_recompiles_total``,
the JAX package's series name, so scrapers see the same series), and the
current padded dims are exported as ``tpu_faas_tick_shape{dim=...}``
gauges. The JAX module cross-checks the count against
``jit(...)._cache_size()``; the port has no compile cache to read (its
ticks are eager torch ops and prebuilt CUDA kernels), so the signature
count stands alone.

Opt-in deep capture: set ``TPU_FAAS_TORCH_PROFILE_DIR=/some/dir`` and the
first ``TPU_FAAS_TORCH_PROFILE_TICKS`` device ticks (default 20) run inside
one ``torch.profiler`` capture — host activity, and CUDA activity when a
card is present — each tick inside a ``record_function`` span named
:data:`TICK_SPAN`. The capture is written as a Chrome trace
(``tick_trace.<pid>.json``, viewable in Perfetto) at :attr:`trace_path`;
:func:`tick_spans` and :func:`device_ops_by_tick` read it back as each
tick's span on the host and its device operations.

Spans and counters inside the resident scheduler
(``sched/resident.py::ResidentScheduler``): while a ``torch.profiler``
capture runs in the process (this module's, or any other caller's), each
site the scheduler marks runs in a ``record_function`` span of its name
(:data:`SPAN_DIFF` ... :data:`SPAN_RESOLVE_MAP`; under this module's
capture the enqueue's three nest in :data:`TICK_SPAN`) and appends ``(name,
start, end)``, in ``time.perf_counter`` seconds, to :data:`SPAN_LOG`; its
counters (:data:`COUNT_AUCTION_ROUNDS`, :data:`COUNT_AUCTION_SPILLED`,
:data:`COUNT_PLACED`) append ``(name, stamp, value)`` there. With no
capture running a site costs one read of torch's own flag
(:func:`tracing`) and records nothing. The log is one per process, as the
profiler is; the benchmark's per-layer readers read it after the window.
"""

from __future__ import annotations

import bisect
import json
import os
import sys
import time
from collections import deque
from contextlib import contextmanager

PROFILE_DIR_ENV = "TPU_FAAS_TORCH_PROFILE_DIR"
PROFILE_TICKS_ENV = "TPU_FAAS_TORCH_PROFILE_TICKS"
#: the record_function span each captured tick runs in
TICK_SPAN = "tpu_faas.device_tick"
#: Chrome-trace categories of the operations that run on the card
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
#: seconds a capture on a card warms up before its first tick, a device
#: operation every WARMUP_STEP_S (the device records were seen to begin
#: 3.5 ms and 27.4 ms late)
WARMUP_S, WARMUP_STEP_S = 0.5, 0.01

#: the resident tick's spans: the host diff against the last upload, each
#: packet's packing, each packet's upload and B1's launch call, and in
#: resolve_next the wait for B1 (to its first readback's return) and the
#: rest (the mapping, the mirrors' decrements, the later readbacks)
SPAN_DIFF = "tpu_faas.tick.diff"
SPAN_PACK = "tpu_faas.tick.pack"
SPAN_LAUNCH = "tpu_faas.tick.launch"
SPAN_RESOLVE_WAIT = "tpu_faas.tick.resolve_wait"
SPAN_RESOLVE_MAP = "tpu_faas.tick.resolve_map"
#: the resolved tick's counters: an auction tick's bidding rounds and the
#: tasks its rank spill placed (B1's own counts), and every tick's
#: placements
COUNT_AUCTION_ROUNDS = "tpu_faas.tick.auction_rounds"
COUNT_AUCTION_SPILLED = "tpu_faas.tick.auction_spilled"
COUNT_PLACED = "tpu_faas.tick.placed"
#: entries the span log keeps, the newest
SPAN_LOG_CAPACITY = 1 << 18


class SpanLog:
    """The process's spans ``(name, start, end)`` and counters ``(name,
    stamp, value)``, in ``time.perf_counter`` seconds, in the order they
    closed: a ring of :data:`SPAN_LOG_CAPACITY` entries that keeps the
    newest and counts the rest in :attr:`dropped`."""

    def __init__(self, capacity: int = SPAN_LOG_CAPACITY) -> None:
        self.entries: deque[tuple[str, float, float]] = deque(
            maxlen=capacity)
        self.appended = 0

    def __len__(self) -> int:
        return len(self.entries)

    @property
    def dropped(self) -> int:
        return self.appended - len(self.entries)

    def append(self, entry: tuple[str, float, float]) -> None:
        self.entries.append(entry)
        self.appended += 1

    def clear(self) -> None:
        self.entries.clear()
        self.appended = 0

    def nbytes(self) -> int:
        """Bytes the log holds: the ring, each tuple and its two numbers
        (the names are the constants above, shared)."""
        return sys.getsizeof(self.entries) + sum(
            sys.getsizeof(e) + sys.getsizeof(e[1]) + sys.getsizeof(e[2])
            for e in self.entries)


SPAN_LOG = SpanLog()


def tracing() -> bool:
    """Whether a ``torch.profiler`` capture runs in this process: torch's
    own flag, which ``profile.start()`` sets and ``stop()`` clears. Loads
    no torch (no capture runs without it)."""
    prof = sys.modules.get("torch.autograd.profiler")
    return prof is not None and prof._is_profiler_enabled


def span_open(name: str) -> tuple:
    """Enter span ``name`` (call while :func:`tracing`); pass what it
    returns to :func:`span_close`."""
    import torch

    rf = torch.profiler.record_function(name)
    rf.__enter__()
    return name, rf, time.perf_counter()


def span_close(opened: tuple) -> None:
    name, rf, start = opened
    end = time.perf_counter()
    rf.__exit__(None, None, None)
    SPAN_LOG.append((name, start, end))


def count(name: str, value: int) -> None:
    """Record counter ``name`` (call while :func:`tracing`)."""
    SPAN_LOG.append((name, time.perf_counter(), value))


class TickProfiler:
    """Host-side tick instrumentation; one per dispatcher, registered into
    that dispatcher's private metrics registry."""

    def __init__(self, registry, log=None) -> None:
        self._log = log
        self._recompiles = registry.counter(
            "tpu_faas_jit_recompiles_total",
            "Device-tick shape signatures first seen after warmup — each "
            "is one new tick shape (steady state: stays flat)",
        )
        self._shape = registry.gauge(
            "tpu_faas_tick_shape",
            "Padded device-tick dimensions (tasks x workers x slots)",
            ("dim",),
        )
        self._ticks = registry.counter(
            "tpu_faas_device_ticks_total", "Device scheduler ticks run"
        )
        self._dispatches_last = registry.gauge(
            "tpu_faas_tick_device_dispatches_last",
            "Kernel launches issued by the last resident tick "
            "(fused steady state: exactly 1; each overflow flush adds 1)",
        )
        self._dispatches = registry.counter(
            "tpu_faas_tick_device_dispatches_total",
            "Kernel launches issued by resident ticks",
        )
        self._seen: set[tuple] = set()
        self._trace_dir = os.environ.get(PROFILE_DIR_ENV) or None
        try:
            self._trace_left = (
                int(os.environ.get(PROFILE_TICKS_ENV, "20"))
                if self._trace_dir
                else 0
            )
        except ValueError:
            self._trace_left = 0
        self._tracing = False
        self._prof = None
        #: the Chrome trace the last capture wrote (None before one ends)
        self.trace_path: str | None = None

    @property
    def n_signatures(self) -> int:
        return len(self._seen)

    def note_device_dispatches(self, n: int) -> None:
        """Record one resident tick's kernel-launch count
        (``ResidentScheduler.device_dispatches_last_tick``) — the
        observable form of the one-launch-per-tick contract."""
        self._dispatches_last.set(n)
        if n > 0:
            self._dispatches.inc(n)

    def observe_shape(
        self, *, tasks: int, workers: int, slots: int, signature: tuple
    ) -> bool:
        """Report one tick's padded dims + signature BEFORE the device
        call. Returns True when this signature is new. The signature must
        include everything that changes the tick's shape: padded dims,
        placement, and optional-lane presence."""
        self._shape.labels(dim="tasks").set(tasks)
        self._shape.labels(dim="workers").set(workers)
        self._shape.labels(dim="slots").set(slots)
        self._ticks.inc()
        if signature in self._seen:
            return False
        self._seen.add(signature)
        self._recompiles.inc()
        if self._log is not None and len(self._seen) > 1:
            # the first signature is warmup; later ones are the news
            self._log.info(
                "device tick signature changed (signature %r, %d total)",
                signature,
                len(self._seen),
            )
        return True

    @contextmanager
    def tick_capture(self):
        """Wrap one device tick; while the env-gated capture budget lasts,
        the tick runs inside a ``torch.profiler`` capture, in a
        :data:`TICK_SPAN` span. No-op (and zero-cost) when
        ``TPU_FAAS_TORCH_PROFILE_DIR`` is unset."""
        if self._trace_left <= 0:
            if self._tracing:
                self._stop_trace()
            yield
            return
        if not self._tracing:
            self._start_trace()
        self._trace_left -= 1
        try:
            if self._tracing:
                import torch

                with torch.profiler.record_function(TICK_SPAN):
                    yield
            else:
                yield
        finally:
            if self._trace_left <= 0 and self._tracing:
                self._stop_trace()

    def _start_trace(self) -> None:
        try:
            import torch
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=activities)
            self._prof.start()
            if torch.cuda.is_available():
                # device activity records begin some milliseconds after the
                # capture does: captures lost every device record of their
                # first 3.5 ms and 27.4 ms, the first tick's B1 included,
                # while the runtime calls were all there (ROADMAP C.6). So
                # the capture opens with a warm-up, as torch.profiler's
                # schedule opens with a warm-up step: a device operation
                # every WARMUP_STEP_S for WARMUP_S, all in no tick's span
                end = time.monotonic() + WARMUP_S
                while time.monotonic() < end:
                    torch.zeros(1, device="cuda")
                    torch.cuda.synchronize()
                    time.sleep(WARMUP_STEP_S)
            self._tracing = True
            if self._log is not None:
                self._log.info(
                    "torch.profiler capture started -> %s", self._trace_dir
                )
        except Exception as exc:  # capture is best-effort observability
            self._trace_left = 0
            self._prof = None
            if self._log is not None:
                self._log.warning("torch.profiler capture unavailable: %s",
                                  exc)

    def _stop_trace(self) -> None:
        self._tracing = False
        prof, self._prof = self._prof, None
        try:
            import torch

            if torch.cuda.is_available():
                # the last captured tick's launches are still queued
                torch.cuda.synchronize()
            prof.stop()
            os.makedirs(self._trace_dir, exist_ok=True)
            path = os.path.join(self._trace_dir,
                                f"tick_trace.{os.getpid()}.json")
            prof.export_chrome_trace(path)
            self.trace_path = path
            if self._log is not None:
                self._log.info("torch.profiler capture written to %s", path)
        except Exception as exc:
            if self._log is not None:
                self._log.warning("torch.profiler stop failed: %s", exc)

    def close(self) -> None:
        if self._tracing:
            self._stop_trace()


def _events(trace_path: str) -> list[dict]:
    with open(trace_path) as fh:
        trace = json.load(fh)
    return trace["traceEvents"] if isinstance(trace, dict) else trace


def _spans(events: list[dict]) -> list[tuple[float, float]]:
    return sorted(
        (e["ts"], e["ts"] + e["dur"])
        for e in events
        if e.get("cat") == "user_annotation" and e.get("name") == TICK_SPAN
    )


def tick_spans(trace_path: str) -> list[tuple[float, float]]:
    """(start, end) on the host clock, in microseconds, of each captured
    tick's :data:`TICK_SPAN` span, in tick order."""
    return _spans(_events(trace_path))


def device_ops_by_tick(trace_path: str) -> list[list[dict]]:
    """Each captured tick's device operations (Chrome-trace events of
    :data:`DEVICE_CATEGORIES`, in start order), in tick order. An
    operation belongs to the tick whose :data:`TICK_SPAN` span issued its
    launch or copy: the runtime call and the device event share the
    trace's ``correlation`` id. On a capture without a card every tick's
    list is empty."""
    events = _events(trace_path)
    ticks = _spans(events)
    starts = [t[0] for t in ticks]
    issued: dict[int, int] = {}  # correlation id -> tick index
    for e in events:
        if e.get("cat") not in ("cuda_runtime", "cuda_driver"):
            continue
        k = bisect.bisect_right(starts, e["ts"]) - 1
        if k >= 0 and e["ts"] <= ticks[k][1]:
            issued[e.get("args", {}).get("correlation")] = k
    out: list[list[dict]] = [[] for _ in ticks]
    for e in events:
        if e.get("cat") in DEVICE_CATEGORIES:
            k = issued.get(e.get("args", {}).get("correlation"))
            if k is not None:
                out[k].append(e)
    for ops in out:
        ops.sort(key=lambda e: e["ts"])
    return out
