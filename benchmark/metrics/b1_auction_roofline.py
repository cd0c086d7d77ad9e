"""b1_auction_roofline: B1's auction launches' share of their roofline,
in percent, over the traced window.

The work a tick needs, from the plain reference's run over the same
inputs (its rounds, bidders and admitted tasks, ``judge.Verdict.work``):
with n tasks admitted and n slots kept, a bid's base value
``-size/speed + jitter`` is needed once a tick for each of the n x n
(task, slot) cells: the cell index and Wang's hash, 11 integer operations,
one conversion to float and 3 float operations; each round then needs,
for each bidder's n cells, the price subtracted and the running best and
runner-up kept, 4 float operations. Every operation is one issue slot.
A slot outside the kept n bids -inf and needs nothing. Bytes: the pending
flags once, the admitted sizes, each worker's speed, free count and
liveness, the prices read and the kept ones written, the placements
written. Peaks: ``peaks.json``; the integer pipe or the issue bounds it.
"""

from benchmark.roofline import least_seconds, share_pct

KERNEL = "fused_auction_kernel"


def tick_work(rounds: int, bid_rows: int, n: int, T: int, W: int, K: int
              ) -> tuple[dict, float]:
    base, bids = n * n, bid_rows * n
    ops = {"int32": 11 * base, "conversion": base,
           "fp32": 3 * base + 4 * bids, "issue": 15 * base + 4 * bids}
    n_bytes = T + 4 * n + 9 * W + 4 * W * K + 4 * n + 8 * n
    return ops, n_bytes


def read(ctx):
    d = ctx.launches(KERNEL)
    if d is None or any(k not in ctx.work for k in d):
        return None
    c = ctx.config
    T, W, K = c["max_pending"], c["max_workers"], c["max_slots"]
    least = [least_seconds(*tick_work(*ctx.work[k], T, W, K)) for k in d]
    return share_pct(least, list(d.values()))
