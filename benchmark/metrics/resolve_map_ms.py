"""resolve_map_ms: the mean host milliseconds a tick spends in the program's
span ``tpu_faas.tick.resolve_map``: the rest of ``resolve_next``: slots mapped
to call ids, the host mirrors' decrements, the later readbacks.
Read from the program's span log (``benchmark/program_log.py``)."""

from benchmark.program_log import span_ms

SPAN = "tpu_faas.tick.resolve_map"


def read(ctx):
    return span_ms(ctx, SPAN)
