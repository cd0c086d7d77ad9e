"""b1_auction_spilled_pct: the share of the traced window's placements
that B1's rank spill made (tasks left unmatched when the auction ran out
of rounds), in percent: the program's counters
``tpu_faas.tick.auction_spilled`` over ``tpu_faas.tick.placed``."""

from benchmark.program_log import counter_values

SPILLED = "tpu_faas.tick.auction_spilled"
PLACED = "tpu_faas.tick.placed"


def read(ctx):
    spilled = counter_values(ctx, SPILLED)
    placed = counter_values(ctx, PLACED)
    if spilled is None or placed is None or sum(placed) == 0:
        return None
    return 100.0 * sum(spilled) / sum(placed)
