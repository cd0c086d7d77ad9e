"""resolve_ms: the mean host time of the resolve loop (``resolve_next()``
until None, which waits for B1's outputs and maps slots to call ids, and
``inflight_add`` for each placement), from the benchmark's own span."""


def read(ctx):
    return ctx.span_ms(2)
