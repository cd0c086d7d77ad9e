"""b1_auction_full_length_pct: the share of the traced window's auction
ticks that took B1's full-length path (a -inf or NaN speed on a free slot
or size on an admitted task) instead of its compacted lists, in percent:
the program's counter ``tpu_faas.tick.auction_full_length``, 1 or 0 a
tick. A program without the counter reads None."""

from benchmark.program_log import counter_values

COUNTER = "tpu_faas.tick.auction_full_length"


def read(ctx):
    v = counter_values(ctx, COUNTER)
    return None if v is None else 100.0 * sum(v) / len(v)
