"""device_idle_pct: the traced window's share in which no kernel, copy
or memset ran on the card."""


def read(ctx):
    c = ctx.capture
    if c is None or c.window_s <= 0 or not c.ops:
        return None
    return 100.0 * (1.0 - c.busy_s() / c.window_s)
