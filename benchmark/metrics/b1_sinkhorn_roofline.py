"""b1_sinkhorn_roofline: B1's Sinkhorn launches' share of their roofline,
in percent, over the ticks of the traced window that the check samples.

The work a tick needs, from the plain reference's problem over the same
inputs (``judge.Verdict.work``: its open rows, the size buckets holding a
task and the slack row, and open columns, the workers with capacity and
the slack column): 20 iterations of a row and a column logsumexp over the
open rows x open columns cells, one exp2 on the special function unit and
3 float operations a cell each time; the rounding's pass over the same
cells, 2 float operations; one log a pending task for its bucket. Closed
cells are -inf and need nothing. Bytes: the pending sizes and flags,
each worker's speed, free count and liveness, the potentials written
(the placements, some tens of bytes, left out). Peaks: ``peaks.json``;
the special function unit bounds it.
"""

from benchmark.roofline import least_seconds, share_pct

KERNEL = "fused_sinkhorn_kernel"
N_ITERS = 20


def tick_work(rows: int, cols: int, T: int, W: int, K: int
              ) -> tuple[dict, float]:
    cells = rows * cols
    lse = 2 * N_ITERS * cells
    ops = {"sfu": lse + T, "fp32": 3 * lse + 2 * cells,
           "issue": 4 * lse + 2 * cells + T}
    n_bytes = 5 * T + 9 * W + 4 * (1025 + W + 1)
    return ops, n_bytes


def read(ctx):
    d = ctx.launches(KERNEL)
    if d is None:
        return None
    c = ctx.config
    T, W, K = c["max_pending"], c["max_workers"], c["max_slots"]
    least, took = [], []
    for k, seconds in d.items():
        if k in ctx.work:
            least.append(least_seconds(*tick_work(*ctx.work[k], T, W, K)))
            took.append(seconds)
    return share_pct(least, took)
