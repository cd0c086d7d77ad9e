"""enqueue_ms: the mean host time of ``tick_resident()`` (the diff against
the last upload, the packet, its upload and B1's launch), from the
benchmark's own span around it."""


def read(ctx):
    return ctx.span_ms(1)
