"""Time the tpu-push dispatcher's tick on the CPU at its default shape, with
torch's default intra-op thread count and with one thread.

    python3 tools/cpu_tick_threads.py [--placement P ...] [--pending N]
                                      [--workers N] [--ticks K] [--seed S]

``SchedulerArrays(device="cpu")`` at ``TpuPushDispatcher``'s defaults
(4,096 worker rows, 8,192 pending, 65,536 in-flight rows, 8 slots) with
``--workers`` registered workers of random speed and free slots. For each
placement (``rank`` and ``sinkhorn`` by default) it ticks ``--pending``
tasks ``--ticks`` times at each thread count, in turns (default, 1,
default, 1), unloaded, after one untimed tick. Prints one JSON line a
placement: the median and longest tick of each turn in ms. Every number is
a CPU measurement of the machine it runs on, not a device metric.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from tpu_faas_torch.sched.state import SchedulerArrays  # noqa: E402

MAX_WORKERS, MAX_PENDING, MAX_INFLIGHT, MAX_SLOTS = 4096, 8192, 65536, 8


def make_arrays(placement: str, workers: int, seed: int):
    rng = np.random.default_rng(seed)
    a = SchedulerArrays(max_workers=MAX_WORKERS, max_pending=MAX_PENDING,
                        max_inflight=MAX_INFLIGHT, max_slots=MAX_SLOTS,
                        placement=placement, device="cpu")
    for i in range(workers):
        a.register(f"w{i}".encode(), int(rng.integers(1, MAX_SLOTS + 1)),
                   speed=float(rng.uniform(0.5, 4.0)))
    return a


def timed(tick, n: int) -> list[float]:
    out = []
    for _ in range(n):
        t0 = time.perf_counter()
        tick()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def measure(placement: str, pending: int, workers: int, ticks: int,
            seed: int) -> dict:
    a = make_arrays(placement, workers, seed)
    sizes = np.random.default_rng(seed + 1).uniform(
        0.5, 2.0, pending).astype(np.float32)
    default = torch.get_num_threads()
    a.tick(sizes)  # the first call in this process pays any set-up
    turns = []
    try:
        for threads in (default, 1, default, 1):
            torch.set_num_threads(threads)
            ms = timed(lambda: a.tick(sizes), ticks)
            turns.append({"threads": threads,
                          "median_ms": statistics.median(ms),
                          "max_ms": max(ms)})
    finally:
        torch.set_num_threads(default)
    return {
        "placement": placement,
        "shape": {"max_workers": MAX_WORKERS, "max_pending": MAX_PENDING,
                  "max_inflight": MAX_INFLIGHT, "max_slots": MAX_SLOTS,
                  "pending": pending, "workers": workers},
        "ticks": ticks,
        "turns": turns,
        "device": "cpu",
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--placement", nargs="*", default=["rank", "sinkhorn"],
                    choices=("rank", "auction", "sinkhorn"))
    ap.add_argument("--pending", type=int, default=MAX_PENDING)
    ap.add_argument("--workers", type=int, default=1024)
    ap.add_argument("--ticks", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    for p in args.placement:
        print(json.dumps(measure(p, args.pending, args.workers, args.ticks,
                                 args.seed)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
