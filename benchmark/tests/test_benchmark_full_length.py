"""The reader of ``b1_auction_full_length_pct`` on a synthetic span log:
the share of the window's auction ticks that took B1's full-length path,
from the program's counter ``tpu_faas.tick.auction_full_length`` (1 or 0
a tick); 0 where no tick did, None where the window holds no such
counter (a program without it, or a run without a trace)."""

import numpy as np
import pytest

from benchmark import spec
from benchmark.context import Context

NAME = "b1_auction_full_length_pct"
COUNTER = "tpu_faas.tick.auction_full_length"


@pytest.fixture
def log():
    from tpu_faas_torch.obs import profile

    profile.SPAN_LOG.clear()
    yield profile.SPAN_LOG
    profile.SPAN_LOG.clear()


def _ctx(n: int) -> Context:
    """A window of n ticks, tick k from k to k + 0.75 s."""
    stamps = np.array([[k, k + 0.25, k + 0.5, k + 0.75] for k in range(n)],
                      float)
    return Context({}, stamps, list(range(n)), {}, None)


@pytest.mark.parametrize("words, want", [([0, 0, 0, 0], 0.0),
                                         ([0, 1, 0, 1], 50.0), ([1], 100.0)])
def test_full_length_share_of_the_window(log, words, want):
    for k, w in enumerate(words):
        log.append((COUNTER, k + 0.6, w))
    log.append((COUNTER, len(words) + 5.0, 1))  # after the window
    assert spec.metric_reader(NAME).read(_ctx(len(words))) == want


def test_no_counter_no_reading(log):
    log.append(("tpu_faas.tick.auction_rounds", 0.6, 3))
    assert spec.metric_reader(NAME).read(_ctx(1)) is None
    # the window empty of ticks
    assert spec.metric_reader(NAME).read(_ctx(0)) is None
