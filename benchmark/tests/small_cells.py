"""Cells cut to a size the CPU runs in seconds, for the benchmark's own
tests (run from the repo root: ``python3 -m pytest benchmark/tests``; on
the CPU with the program's plain PyTorch path; the test marked ``cuda``
runs on the card)."""

from __future__ import annotations

import copy
import time

import torch

from benchmark import spec
from benchmark.run import run_cell

AUCTION = "fleet16k-auction.short"
SINKHORN = "fleet16k-sinkhorn.long"
#: the auction's plain bid sweeps every (task, slot) cell each round on the
#: CPU, so its cell is cut hard; the Sinkhorn cell keeps the bucketed route
#: (max_pending x max_workers > 2**24), and its 50 warm-up ticks hold the
#: first tick the check samples (one in each 48)
SIZES = {
    # 100 ms ticks: some tens of results and placements a tick
    AUCTION: dict(max_workers=64, max_pending=3000, max_inflight=1024,
                  pending_headroom=1024, tick_period_s=0.1, warmup_s=1.0),
    SINKHORN: dict(max_workers=1024, max_pending=16500, max_inflight=9000,
                   pending_headroom=1024, warmup_s=0.25),
}


def small_cell(name: str) -> spec.Cell:
    cell = spec.find_cell(name)
    cell = copy.deepcopy(cell)
    cell.config.update(SIZES[name])
    if name == SINKHORN:
        # the long mix's ~35 results a tick at 70,000 busy processes is
        # ~1 a tick at this fleet; short calls keep some placements a tick
        cell.traffic["work_mean_s"] = 2.25
    return cell


def run_small(name: str, seed: int = 2**31 + 11, seconds: float = 1.0,
              trace: bool = False, **kw) -> dict:
    return run_cell(small_cell(name), seed, seconds, trace,
                    torch.device("cpu"), t0=time.perf_counter(), **kw)
