"""Count and time the host mesh tick, on the CPU, at the shape of the shared
mesh dispatchers' test (``tests/test_combined_modes_e2e.py``): 8 pending over
4 host positions, 32 workers, 256 in-flight rows.

    python3 tools/mesh_tick_calls.py [--placement P ...] [--spinners N]
                                     [--ticks K] [--seed S]

For each placement (``sinkhorn``, ``rank``, ``auction-gspmd``,
``auction-permute``; all four by default) one ``sharded_scheduler_tick``:

- ``torch_calls``: the torch calls it makes from Python, counted by a
  ``TorchFunctionMode`` (each one releases and retakes the interpreter lock
  around its op; a scripted body counts as none inside it);
- ``aten_ops``: the aten ops it runs, counted by a ``TorchDispatchMode``
  (inside a scripted body too);
- ``unloaded_ms``: the median of ``--ticks`` ticks;
- ``loaded_ms``: the ticks again with ``--spinners`` threads spinning in
  this process (pure Python loops, as the test's gateway, store and client
  threads contend for the lock), their median and longest.

Prints one JSON line a placement. Every number is a CPU measurement of
this machine, not a device metric.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import threading
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from tpu_faas_torch.parallel import mesh as tmesh  # noqa: E402
from tpu_faas_torch.sched.scripted import CallCount  # noqa: E402

PLACEMENTS = ("sinkhorn", "rank", "auction-gspmd", "auction-permute")
T, W, I, POSITIONS, SLOTS = 8, 32, 256, 4, 8


class OpCount(TorchDispatchMode):
    """Counts the aten ops run while it is active."""

    def __init__(self) -> None:
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def tick_inputs(seed: int) -> dict:
    """The test's state: every pending slot holding a sleep call, two live
    workers of two free slots each among 32 rows, nothing in flight."""
    rng = np.random.default_rng(seed)
    live = np.arange(W) < 2
    return {
        "sizes": rng.uniform(0.5, 2.0, T).astype(np.float32),
        "speed": np.ones(W, np.float32),
        "free": np.where(live, 2, 0).astype(np.int32),
        "active": live,
        "hb_age": np.where(live, 0.1, 9.0).astype(np.float32),
        "prev_live": live,
        "inflight": np.full(I, -1, np.int32),
    }


def make_tick(placement: str, seed: int):
    """A no-argument function running one tick of ``placement``."""
    mesh = tmesh.make_mesh(POSITIONS, device="cpu")
    x = tick_inputs(seed)
    (ts,) = tmesh.shard_task_arrays(mesh, x["sizes"])
    fleet = [torch.from_numpy(x[k]) for k in ("speed", "free", "active",
                                                "hb_age", "prev_live",
                                                "inflight")]
    kind, _, resolve = placement.partition("-")

    def tick():
        return tmesh.sharded_scheduler_tick(
            mesh, ts, None, *fleet, 2.0, max_slots=SLOTS, placement=kind,
            n_valid=T, winner_resolve=resolve or "gspmd")

    return tick


def timed(tick, n: int) -> list[float]:
    out = []
    for _ in range(n):
        t0 = time.perf_counter()
        tick()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def spinning(n: int):
    """Start ``n`` threads that spin in Python; returns their stop."""
    stop = threading.Event()

    def spin() -> None:
        x = 0
        while not stop.is_set():
            x += 1

    threads = [threading.Thread(target=spin, daemon=True) for _ in range(n)]
    for t in threads:
        t.start()

    def end() -> None:
        stop.set()
        for t in threads:
            t.join()

    return end


def measure(placement: str, spinners: int, ticks: int, seed: int) -> dict:
    tick = make_tick(placement, seed)
    tick()  # the first call in this process pays any one-time set-up
    with CallCount() as calls:
        tick()
    with OpCount() as ops:
        tick()
    unloaded = timed(tick, ticks)
    end = spinning(spinners)
    try:
        loaded = timed(tick, ticks)
    finally:
        end()
    return {
        "placement": placement,
        "shape": {"pending": T, "positions": POSITIONS, "workers": W},
        "torch_calls": calls.n,
        "aten_ops": ops.n,
        "unloaded_ms": {"median": statistics.median(unloaded),
                        "max": max(unloaded)},
        "loaded_ms": {"spinners": spinners, "ticks": ticks,
                      "median": statistics.median(loaded),
                      "max": max(loaded), "all": loaded},
        "torch_threads": torch.get_num_threads(),
        "device": "cpu",
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--placement", nargs="*", choices=PLACEMENTS,
                    default=list(PLACEMENTS))
    ap.add_argument("--spinners", type=int, default=4)
    ap.add_argument("--ticks", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    torch.set_num_threads(1)  # as the test suite's mesh tests run
    for p in args.placement:
        print(json.dumps(measure(p, args.spinners, args.ticks, args.seed)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
