"""diff_ms: the mean host milliseconds a tick spends in the program's
span ``tpu_faas.tick.diff``: the host's diff of the fleet's mirrors against
the last upload (``ResidentScheduler._diff_deltas``).
Read from the program's span log (``benchmark/program_log.py``)."""

from benchmark.program_log import span_ms

SPAN = "tpu_faas.tick.diff"


def read(ctx):
    return span_ms(ctx, SPAN)
