"""pack_ms: the mean host milliseconds a tick spends in the program's
span ``tpu_faas.tick.pack``: the packing of each delta packet, flush packets
included (``ResidentScheduler._pack``).
Read from the program's span log (``benchmark/program_log.py``)."""

from benchmark.program_log import span_ms

SPAN = "tpu_faas.tick.pack"


def read(ctx):
    return span_ms(ctx, SPAN)
