"""Time B1's auction and Sinkhorn branches of one checkout on the card, on
the resident loops' own states, so that two trees compare in one call.

    python3 tools/ab_time.py ROOT LABEL

``ROOT`` is a checkout of this repository (an unpacked ``git archive`` of
another commit, or ``.``): its ``tpu_faas_torch`` is the package timed, and
it builds its own kernels into its own ``csrc/build/``. ``chip_smoke.py``
beside this script drives the loops: the resident auction loop (30 ticks)
and the resident Sinkhorn loop (40 ticks) at the headline shape, each
launch held against its plain version as ``chip_smoke.py`` holds it. Then
each branch is timed with CUDA events on the loop's last 10 states, every
state once per pass, 3 passes. Prints one JSON line with the card, the
means and each state's medians. Needs one CUDA device; compare two trees
in turns (parent, change, change, parent) within one call.
"""

from __future__ import annotations

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
    import chip_smoke as cs
    from tpu_faas_torch.sched import fused_tick

    if not Path(fused_tick.__file__).resolve().is_relative_to(root):
        raise SystemExit(f"tpu_faas_torch came from {fused_tick.__file__}, "
                         f"not from {root}")
    dev = torch.device("cuda")
    kernel = fused_tick.KERNEL
    kernel.load()
    out = {"label": sys.argv[2], "root": str(root), "card": cs.card_line()}
    kw = dict(cs.SHAPE, max_slots=cs.MAX_SLOTS, use_priority=False)
    for placement, n_ticks, n_timed, launch in (
            ("auction", cs.N_AUCTION_TICKS, cs.N_AUCTION_TIMED,
             kernel.auction),
            ("sinkhorn", cs.N_SINKHORN_TICKS, cs.N_SINKHORN_TIMED,
             kernel.sinkhorn)):
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
