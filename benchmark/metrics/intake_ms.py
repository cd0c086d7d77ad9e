"""intake_ms: the mean host time a tick spends in its membership calls
(inflight_done, release_slot, heartbeat, pending_add), from the
benchmark's own span around them."""


def read(ctx):
    return ctx.span_ms(0)
