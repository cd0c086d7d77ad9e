"""What the resident scheduler's span recorder (``obs/profile.py``) costs
a call, off and on.

    python3 tools/span_cost.py [--pairs N] [--reads N]

Off: a ``tracing()`` read, the whole cost of a span site with no capture
running. On, inside a ``torch.profiler`` capture (CPU activity, and CUDA
activity on a card): a span opened and closed (``span_open`` and
``span_close``: a ``record_function`` and one log entry), a counter
(``count``), and the auction counters' readback (two int32 scalars
stacked and read to the host, as ``resolve_next`` reads B1's round and
spill counts). Prints one JSON line of microseconds a call, and the log's
bytes an entry; the log is cleared after. On the CPU these are CPU
timings of the machine it runs on.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from tpu_faas_torch.device import to_host  # noqa: E402
from tpu_faas_torch.obs import profile as spans  # noqa: E402


def per_call_us(fn, n: int) -> float:
    t = time.perf_counter()
    for _ in range(n):
        fn()
    return (time.perf_counter() - t) / n * 1e6


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 tools/span_cost.py")
    ap.add_argument("--pairs", type=int, default=20000)
    ap.add_argument("--reads", type=int, default=2000)
    args = ap.parse_args(argv)
    cuda = torch.cuda.is_available()
    dev = torch.device("cuda" if cuda else "cpu")
    rounds = torch.zeros((), dtype=torch.int32, device=dev)
    spilled = torch.ones((), dtype=torch.int32, device=dev)

    def pair():
        spans.span_close(spans.span_open(spans.SPAN_DIFF))

    def readback():
        to_host(torch.stack([rounds, spilled])).tolist()

    spans.SPAN_LOG.clear()
    out = {"device": torch.cuda.get_device_name(dev) if cuda else "cpu",
           "tracing_off_us": per_call_us(spans.tracing, 10 * args.pairs)}
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities):
        assert spans.tracing()
        readback()
        out["span_on_us"] = per_call_us(pair, args.pairs)
        out["count_on_us"] = per_call_us(
            lambda: spans.count(spans.COUNT_PLACED, 1), args.pairs)
        out["readback_on_us"] = per_call_us(readback, args.reads)
    out["log_bytes_an_entry"] = (spans.SPAN_LOG.nbytes()
                                 / max(1, len(spans.SPAN_LOG)))
    spans.SPAN_LOG.clear()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
