"""What a per-layer metric's reader reads: ``read(ctx)`` in
``metrics/<name>.py`` returns the metric's value, or None where the run
holds nothing for it to read (the harness then leaves the metric out)."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class Context:
    config: dict
    #: the window's ticks: [n, 4] host-clock span edges in seconds (intake
    #: start, enqueue start, resolve start, resolve end)
    stamps: np.ndarray
    #: the window's tick numbers, in order
    ticks: list
    #: per tick number, the reference's work counts (judge.Verdict.work)
    work: dict
    #: the traced window (trace.Capture), None without a trace
    capture: object | None
    #: per window tick the launches the program issued
    #: (``device_dispatches_last_tick``), None where not known
    dispatches: list | None = None

    def span_ms(self, i: int) -> float | None:
        """Mean milliseconds a tick of span ``i`` (0 intake, 1 enqueue,
        2 resolve)."""
        if len(self.stamps) == 0:
            return None
        return float(np.mean(self.stamps[:, i + 1] - self.stamps[:, i])
                     * 1e3)

    def launches(self, name_part: str) -> dict | None:
        """Device seconds of the kernel in each window tick, ``{tick:
        seconds}`` in tick order: each launch whose name holds
        ``name_part`` belongs to the tick whose span (intake start to
        resolve end) holds the host call that launched it, or its device
        start where the capture holds no such call, and a tick's launches
        are summed (a tick that flushes issues several). The host call and
        the spans share the host's clock; a device start does not (the
        trace maps it onto that clock with an error of some tenths of a
        millisecond, either way). A tick the capture holds no such launch
        for is left out. None without a trace, where no tick has one, or
        where a tick holds more than it dispatched."""
        cap = self.capture
        if cap is None or not cap.spans:
            return None
        starts = np.asarray([t[0][0] for t in cap.spans])
        ends = np.asarray([t[-1][1] for t in cap.spans])
        launched = cap.launched or [None] * len(cap.ops)
        got: dict = {}
        n: dict = {}
        for (s, e, name), h in zip(cap.ops, launched):
            if name_part not in name:
                continue
            t = s if h is None else h
            i = int(np.searchsorted(starts, t, side="right")) - 1
            if i < 0 or t > ends[i]:
                continue  # outside every tick
            got[i] = got.get(i, 0.0) + (e - s)
            n[i] = n.get(i, 0) + 1
        if not got or (self.dispatches is not None and any(
                c > self.dispatches[i] for i, c in n.items())):
            return None
        return {self.ticks[i]: got[i] for i in sorted(got)}
