"""b1_auction_ms: device milliseconds a tick of B1's auction
branch (``fused_auction_kernel``), the mean over the traced window."""

KERNEL = "fused_auction_kernel"


def read(ctx):
    d = ctx.launches(KERNEL)
    return None if d is None else 1e3 * sum(d.values()) / len(d)
