"""The traced run: a ``torch.profiler`` capture of the window, read back
as device operations, the card's busy time and the host spans.

The capture opens with a warm-up (a device operation every 10 ms for
0.5 s, outside any tick): device records were seen to begin milliseconds
after a capture does (the pattern of ``obs/profile.py``'s
``TickProfiler``). It is written as a Chrome trace to a temporary file,
read, and deleted.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from dataclasses import dataclass, field

import numpy as np

from benchmark.loop import SPANS

#: Chrome-trace categories of the operations that run on the card
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
#: categories of the host calls that launch them, joined to them by the
#: ``correlation`` id both carry in their ``args``
HOST_CALL_CATEGORIES = ("cuda_runtime", "cuda_driver")
WARMUP_S, WARMUP_STEP_S = 0.5, 0.01


def start(device) -> object:
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    if device.type == "cuda":
        end = time.monotonic() + WARMUP_S
        while time.monotonic() < end:
            torch.zeros(1, device=device)
            torch.cuda.synchronize(device)
            time.sleep(WARMUP_STEP_S)
    return prof


def stop(prof, device) -> list[dict]:
    """Stop the capture and return its events."""
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)
    prof.stop()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            trace = json.load(fh)
    finally:
        os.unlink(path)
    return trace["traceEvents"] if isinstance(trace, dict) else trace


def short_name(name: str) -> str:
    """A C++ kernel's name without its parameter list (``void
    ns::kernel<false>(float const*, ...)`` -> ``void ns::kernel<false>``);
    other names (``Memcpy DtoH (Device -> Pinned)``) as they are."""
    if not name.endswith(")"):
        return name
    depth = 0
    for i in range(len(name) - 1, -1, -1):
        depth += {")": 1, "(": -1}.get(name[i], 0)
        if depth == 0:
            head = name[:i].rstrip()
            return head if ("::" in head or "<" in head) else name
    return name


@dataclass
class Capture:
    """The window as the trace saw it (seconds, on the trace's clock)."""

    window: tuple[float, float]
    #: per tick the (start, end) of each span in SPANS
    spans: list[list[tuple[float, float]]]
    #: device operations in the window: (start, end, name)
    ops: list[tuple[float, float, str]] = field(default_factory=list)
    #: per operation of ``ops``, the host-clock start of the call that
    #: launched it (its runtime event of the same correlation id), None
    #: where the capture holds no such call; empty where not read
    launched: list[float | None] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def busy_intervals(self) -> list[tuple[float, float]]:
        lo, hi = self.window
        out: list[list[float]] = []
        for s, e, _ in sorted(self.ops):
            s, e = max(s, lo), min(e, hi)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals())

    def device_ops(self, top: int = 10) -> list[list]:
        tot: dict[str, float] = {}
        for s, e, n in self.ops:
            n = short_name(n)
            tot[n] = tot.get(n, 0.0) + (e - s)
        return [[n, v] for n, v in
                sorted(tot.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> list[list]:
        """The card's idle time in the window by what the host was doing:
        each span of SPANS, or ``between`` (outside every tick's spans)."""
        lo, hi = self.window
        busy = self.busy_intervals()
        idle, t = [], lo
        for s, e in busy:
            if s > t:
                idle.append((t, s))
            t = max(t, e)
        if t < hi:
            idle.append((t, hi))
        marks = sorted((s, e, SPANS[i]) for tick in self.spans
                       for i, (s, e) in enumerate(tick))
        starts = np.asarray([m[0] for m in marks])
        tot = {name: 0.0 for name in (*SPANS, "between")}
        for a, b in idle:
            covered = 0.0
            j = max(0, int(np.searchsorted(starts, a, side="right")) - 1)
            while j < len(marks) and marks[j][0] < b:
                s, e, name = marks[j]
                ov = min(b, e) - max(a, s)
                if ov > 0:
                    tot[name] += ov
                    covered += ov
                j += 1
            tot["between"] += (b - a) - covered
        return [[n, v] for n, v in sorted(tot.items(), key=lambda kv: -kv[1])
                if v > 0][:top]


def capture(events: list[dict], n_ticks: int) -> Capture | None:
    """The last ``n_ticks`` ticks' spans and the device operations between
    the first of them and the last, each with the host time of the call
    that launched it; None without them."""
    by_name: dict[str, list[tuple[float, float]]] = {n: [] for n in SPANS}
    ops, corr, calls = [], [], {}
    for e in events:
        cat = e.get("cat")
        if cat == "user_annotation" and e.get("name") in by_name:
            s = e["ts"] * 1e-6
            by_name[e["name"]].append((s, s + e.get("dur", 0) * 1e-6))
        elif cat in DEVICE_CATEGORIES:
            s = e["ts"] * 1e-6
            ops.append((s, s + e.get("dur", 0) * 1e-6, e.get("name", "")))
            corr.append((e.get("args") or {}).get("correlation"))
        elif cat in HOST_CALL_CATEGORIES:
            c = (e.get("args") or {}).get("correlation")
            if c is not None:
                calls[c] = e["ts"] * 1e-6
    for v in by_name.values():
        v.sort()
    counts = {len(v) for v in by_name.values()}
    if len(counts) != 1 or counts.pop() < n_ticks or n_ticks == 0:
        return None
    spans = [list(t) for t in zip(*(by_name[n][-n_ticks:] for n in SPANS))]
    window = (spans[0][0][0], spans[-1][-1][1])
    keep = [i for i, o in enumerate(ops)
            if o[1] > window[0] and o[0] < window[1]]
    return Capture(window, spans, [ops[i] for i in keep],
                   [calls.get(corr[i]) for i in keep])
