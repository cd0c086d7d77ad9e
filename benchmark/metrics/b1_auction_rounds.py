"""b1_auction_rounds: the mean bidding rounds B1's auction ran a tick in
the traced window, B1's own count (``ResidentTickOutput.auction_rounds``,
the program's counter ``tpu_faas.tick.auction_rounds``)."""

from benchmark.program_log import counter_values

COUNTER = "tpu_faas.tick.auction_rounds"


def read(ctx):
    v = counter_values(ctx, COUNTER)
    return None if v is None else sum(v) / len(v)
