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

    def span_ms(self, i: int) -> float | None:
        """Mean milliseconds a tick of span ``i`` (0 intake, 1 enqueue,
        2 resolve)."""
        if len(self.stamps) == 0:
            return None
        return float(np.mean(self.stamps[:, i + 1] - self.stamps[:, i])
                     * 1e3)

    def launches(self, name_part: str) -> list[float] | None:
        """Seconds of each window launch of the kernel, one a tick; None
        without a trace or with another count."""
        if self.capture is None:
            return None
        d = self.capture.kernel_durations(name_part)
        return d if len(d) == len(self.ticks) and d else None
