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


#: a configuration that no cell of BENCHMARK.json has yet: the auction
#: fleet placed by rank matching, with workers failing and returning as in
#: the repo's BASELINE config 5 (5% of the live ones a second), cut as the
#: auction cell is; down 15 s against the 10 s expiry
RANK_CHURN = "fleet-rank-churn.short"
CHURN = {"fail_per_s": 0.05, "down_s": 15.0}


def small_cell(name: str) -> spec.Cell:
    if name == RANK_CHURN:
        cell = copy.deepcopy(spec.find_cell(AUCTION))
        cell.name = name
        cell.config.update(SIZES[AUCTION], name="fleet-rank-churn",
                           placement="rank", churn=dict(CHURN))
        return cell
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
