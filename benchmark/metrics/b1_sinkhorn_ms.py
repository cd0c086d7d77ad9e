"""b1_sinkhorn_ms: device milliseconds a tick of B1's Sinkhorn
branch (``fused_sinkhorn_kernel``), the mean over the traced window."""

KERNEL = "fused_sinkhorn_kernel"


def read(ctx):
    d = ctx.launches(KERNEL)
    return None if d is None else 1e3 * sum(d.values()) / len(d)
