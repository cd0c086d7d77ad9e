"""launch_ms: the mean host milliseconds a tick spends in the program's
span ``tpu_faas.tick.launch``: each packet's upload and B1's launch call, to
its return (``ResidentScheduler._launch``).
Read from the program's span log (``benchmark/program_log.py``)."""

from benchmark.program_log import span_ms

SPAN = "tpu_faas.tick.launch"


def read(ctx):
    return span_ms(ctx, SPAN)
