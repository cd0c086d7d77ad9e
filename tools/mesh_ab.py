"""Time the sharded auction's two winner routes of one checkout on the
card, so that two trees compare in one call.

    python3 tools/mesh_ab.py ROOT LABEL

``ROOT`` is a checkout of this repository (an unpacked ``git archive`` of
another tree, or ``.``): its ``tpu_faas_torch`` is the package timed, and
it builds its own B2 into its own ``csrc/build/``. ``chip_smoke.py``
beside this script makes the inputs: the mesh phase's (a) tick at the
headline shape over 4 positions named on the one card. Each route
(``gspmd``, ``permute``) runs once untimed, then 5 times in turns,
synchronized, on the host clock; each timed call's ``psum`` calls (each
one host read) are counted. Prints one JSON line with the card, every
time and the medians. Needs one CUDA device; compare two trees in turns
(parent, change, change, parent) within one call.
"""

from __future__ import annotations

import importlib.util
import json
import statistics
import sys
import time
from pathlib import Path

ROUTES = ("gspmd", "permute")
REPEATS = 5


def main() -> int:
    if len(sys.argv) != 3:
        print(f"usage: python3 {sys.argv[0]} ROOT LABEL", file=sys.stderr)
        return 2
    root = Path(sys.argv[1]).resolve()
    here = Path(__file__).resolve().parents[1]
    sys.path[:0] = [str(root), str(here)]
    import torch

    if not torch.cuda.is_available():
        print("mesh_ab: no CUDA device is available", file=sys.stderr)
        return 1
    # this tree's chip_smoke.py, whatever ROOT holds
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  here / "chip_smoke.py")
    cs = sys.modules["chip_smoke"] = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from tpu_faas_torch.parallel import mesh as tm
    from tpu_faas_torch.sched import bid

    if not Path(tm.__file__).resolve().is_relative_to(root):
        raise SystemExit(f"tpu_faas_torch came from {tm.__file__}, "
                         f"not from {root}")
    dev = torch.device("cuda")
    bid.KERNEL.load()
    mesh = tm.make_mesh(devices=[dev] * cs.MESH_POSITIONS)
    x = cs.mesh_tick_inputs(51)
    ts, tv = tm.shard_task_arrays(mesh, x["sizes"], x["valid"])
    fleet = [torch.from_numpy(x[k]).to(dev)
             for k in ("speed", "free", "active", "hb_age", "prev_live",
                       "inflight")]
    reads = [0]
    psum = tm.psum

    def counted(*a, **k):
        reads[0] += 1
        return psum(*a, **k)

    tm.psum = counted

    def tick(route):
        return tm.sharded_scheduler_tick(
            mesh, ts, tv, *fleet, 10.0, max_slots=cs.MAX_SLOTS,
            placement="auction", winner_resolve=route)

    first = {r: tick(r) for r in ROUTES}  # untimed: the first call pays more
    assert torch.equal(first["gspmd"].assignment, first["permute"].assignment)
    out = {"label": sys.argv[2], "root": str(root), "card": cs.card_line(),
           "rounds": int(first["permute"].auction_rounds)}
    ms = {r: [] for r in ROUTES}
    for _ in range(REPEATS):
        for r in ROUTES:
            torch.cuda.synchronize()
            reads[0] = 0
            t0 = time.perf_counter()
            tick(r)
            torch.cuda.synchronize()
            ms[r].append(1e3 * (time.perf_counter() - t0))
            out[f"{r}_psum_calls"] = reads[0]
    for r in ROUTES:
        out[f"{r}_ms"] = ms[r]
        out[f"{r}_median_ms"] = statistics.median(ms[r])
    print("MESHAB " + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
