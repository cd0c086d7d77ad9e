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
cold tick (every slot free, priorities), 10 launches. Then B1's two lanes:
each branch on ``chip_smoke.lane_cost_cases``' synthetic state with the
tenancy lane and with the speculation lane off and on (rank 20 launches,
auction 3, Sinkhorn 10, off and on in turns), with the probe build's split
of one launch each (the rank branch's phases, the auction's opening and
end, the Sinkhorn branch's phases, and where the tree has them the lanes'
parts), and the rank branch with each lane on that lane's resident rank
loop (40 ticks, the last 10 states timed as above). Prints one JSON line
with the card, the means and each state's medians. Needs one CUDA device; compare two trees in turns
(parent, change, change, parent) within one call.
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
    probe = fused_tick.FusedTickKernel(probe=True)
    kernel.load()
    probe.load()
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
    # B1's lanes: their cost on one synthetic state per branch, off and on
    # in turns, and the rank branch on each lane's own loop
    launches = {"rank": rank, "auction": kernel.auction,
                "sinkhorn": kernel.sinkhorn}
    T, W, S = cs.SHAPE["T"], cs.SHAPE["W"], cs.MAX_SLOTS

    def split(placement, packet, pre, k):
        """One probe launch's split (the tree's own reader)."""
        if placement == "rank":
            probe(packet, cs.clone_state(pre), flush=False, **k)
            return probe.rank_split(dev, T, W, S)
        if placement == "auction":
            probe.auction(packet, cs.clone_state(pre), **k)
            sp = probe.auction_split(dev, T, W, S)
            return {key: sp[key] for key in ("open", "end", "total", "lanes")
                    if key in sp}
        probe.sinkhorn(packet, cs.clone_state(pre), **k)
        sp = {"phases": probe.sinkhorn_phase_ms(dev, T, W, S)}
        lanes = probe.sinkhorn_split(dev, T, W, S).get("lanes")
        return dict(sp, lanes=lanes) if lanes else sp

    for lane in ("tenancy", "spec"):
        cases = cs.lane_cost_cases(dev, lane)
        for placement, (off, on) in cases.items():
            launch = launches[placement]
            n = {"rank": 20, "auction": 3, "sinkhorn": 10}[placement]
            t_off, t_on = [], []
            for _ in range(2):
                for times, (packet, pre, k) in ((t_off, off), (t_on, on)):
                    times += cs.event_ms(
                        lambda a, k=k: launch(a[0], a[1], **k), n,
                        setup=lambda p=packet, s0=pre: (p, cs.clone_state(s0)))
            out[f"{lane}_{placement}"] = {
                "off_ms": statistics.median(t_off),
                "on_ms": statistics.median(t_on),
                "split_off": split(placement, *off),
                "split_on": split(placement, *on)}
        run = cs.phase_resident(dev, 40, 10, placement="rank",
                                **{lane: True})
        if run["mismatches"]:
            raise SystemExit(f"{lane} rank loop: {run['mismatches']} "
                             f"mismatches")
        lkw = dict(cs.SHAPE, max_slots=cs.MAX_SLOTS, use_priority=True,
                   **(cs.TENANCY_KW if lane == "tenancy" else cs.SPEC_KW))
        per_state = []
        for packet, pre, _ in run["samples"]:
            ms = cs.event_ms(lambda a: rank(a[0], a[1], **lkw), 3,
                             setup=lambda: (packet, cs.clone_state(pre)))
            per_state.append(statistics.median(ms))
        out[f"{lane}_rank_loop"] = {"mean_ms": statistics.mean(per_state),
                                    "state_ms": per_state}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
