"""resolve_wait_ms: the mean host milliseconds a tick spends in the program's
span ``tpu_faas.tick.resolve_wait``: ``resolve_next`` from its entry to the
return of its first readback, which waits for B1.
Read from the program's span log (``benchmark/program_log.py``)."""

from benchmark.program_log import span_ms

SPAN = "tpu_faas.tick.resolve_wait"


def read(ctx):
    return span_ms(ctx, SPAN)
