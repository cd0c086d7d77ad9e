"""Time B1's rank, auction and Sinkhorn branches of one checkout on the
card, on the resident loops' own states, so that two trees compare in one
call.

    python3 tools/ab_time.py ROOT LABEL

``ROOT`` is a checkout of this repository (an unpacked ``git archive`` of
another commit, or ``.``): its ``tpu_faas_torch`` is the package timed, and
it builds its own kernels into its own ``csrc/build/``. ``chip_smoke.py``
beside this script drives the loops: the resident rank loop with
priorities (60 ticks), the resident auction loop (30 ticks) and the
resident Sinkhorn loop (40 ticks) at the headline shape, each launch held
against its plain version as ``chip_smoke.py`` holds it. Then each branch
is timed with CUDA events on the loop's last 10 states, every state once
per pass, 3 passes; the rank branch also on ``chip_smoke.edge_case``'s
cold tick (every slot free, priorities), 10 launches. Prints one JSON line
with the card, the means and each state's medians. Needs one CUDA device;
compare two trees in turns (parent, change, change, parent) within one
call.
"""

from __future__ import annotations

import importlib.util
import json
import statistics
import sys
from pathlib import Path


def main() -> int:
    if len(sys.argv) != 3:
        print(f"usage: python3 {sys.argv[0]} ROOT LABEL", file=sys.stderr)
        return 2
    root = Path(sys.argv[1]).resolve()
    here = Path(__file__).resolve().parents[1]
    sys.path[:0] = [str(root), str(here)]
    import torch

    if not torch.cuda.is_available():
        print("ab_time: no CUDA device is available", file=sys.stderr)
        return 1
    # this tree's chip_smoke.py, whatever ROOT holds
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  here / "chip_smoke.py")
    cs = sys.modules["chip_smoke"] = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from tpu_faas_torch.sched import fused_tick

    if not Path(fused_tick.__file__).resolve().is_relative_to(root):
        raise SystemExit(f"tpu_faas_torch came from {fused_tick.__file__}, "
                         f"not from {root}")
    dev = torch.device("cuda")
    kernel = fused_tick.KERNEL
    kernel.load()
    out = {"label": sys.argv[2], "root": str(root), "card": cs.card_line()}
    from tpu_faas_torch.sched.resident import state_from_numpy

    def rank(p, st, **k):
        return kernel(p, st, flush=False, **k)

    kw = dict(cs.SHAPE, max_slots=cs.MAX_SLOTS, use_priority=True)
    leaves, pkt = cs.edge_case("cold", True)
    cold = state_from_numpy(leaves, dev)
    packet = torch.from_numpy(pkt).to(dev)
    ms = cs.event_ms(lambda st: rank(packet, st, **kw), 10,
                     setup=lambda: cs.clone_state(cold))
    out["rank_cold_ms"] = statistics.median(ms)
    for placement, n_ticks, n_timed, launch in (
            ("rank", 60, 10, rank),
            ("auction", cs.N_AUCTION_TICKS, cs.N_AUCTION_TIMED,
             kernel.auction),
            ("sinkhorn", cs.N_SINKHORN_TICKS, cs.N_SINKHORN_TIMED,
             kernel.sinkhorn)):
        # the rank loop runs with priorities, the auction and Sinkhorn FCFS
        kw["use_priority"] = placement == "rank"
        run = cs.phase_resident(dev, n_ticks, n_timed, placement=placement)
        if run["mismatches"]:
            raise SystemExit(f"{placement}: {run['mismatches']} mismatches")
        samples = run["samples"]
        per_state = []
        for packet, pre, _ in samples:
            ms = cs.event_ms(lambda a: launch(a[0], a[1], **kw), 3,
                             setup=lambda: (packet, cs.clone_state(pre)))
            per_state.append(statistics.median(ms))
        out[placement] = {
            "mean_ms": statistics.mean(per_state),
            "state_ms": per_state,
            "cold": [bool(pre.refresh) for _, pre, _ in samples]
            if placement == "auction" else None,
        }
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
