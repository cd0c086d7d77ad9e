"""tick_p95_ms.host: the 95th percentile of the window's tick times, first
membership call to the end of the last resolve_next, on the host's clock.
In a cell whose virtual tick is shorter than a tick takes on the card, the
offered load is above what the dispatcher serves in real time, so the tail
is a layer's reading there and the rate the end-to-end one."""

import numpy as np


def read(ctx):
    if len(ctx.stamps) == 0:
        return None
    return float(np.percentile((ctx.stamps[:, 3] - ctx.stamps[:, 0]) * 1e3,
                               95))
