"""The least time a tick's work needs on the card, from its counts.

A kernel's roofline share is that time over the kernel's own time. The
least time is the larger of the compute bound (for each pipe, the
operations it must run over its peak rate, the slowest pipe bounding) and
the byte bound (each input byte read once and each output byte written
once, over the card's memory bandwidth). The counts come from the plain
reference's run over the same inputs, so they read the same work whatever
implements it. The peaks are ``peaks.json``'s.
"""

from __future__ import annotations

import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).resolve().parent / "peaks.json")
                   .read_text())


def least_seconds(ops_by_pipe: dict[str, float], n_bytes: float,
                  peaks: dict = PEAKS) -> float:
    rate = peaks["sm_count"] * peaks["sm_clock_hz"]
    compute = max(n / (peaks["per_sm_per_clock"][pipe] * rate)
                  for pipe, n in ops_by_pipe.items())
    return max(compute, n_bytes / peaks["hbm_bytes_per_s"])


def share_pct(least: list[float], took: list[float]) -> float | None:
    """100 x the summed least times over the summed kernel times; None
    when there is nothing to read."""
    if not least or len(least) != len(took) or sum(took) <= 0:
        return None
    return 100.0 * sum(least) / sum(took)
