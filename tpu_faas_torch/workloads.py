"""Canonical workload corpus for tests and benchmarks.

Reproduces the six task families the reference exercises (reference
client_performance.py:19-92 and test_client.py:18-91): immediate no-op,
sleeper, arithmetic (sum of squares), numeric sort, string sort, and string
reverse — each with a deterministic param generator (seeded, reference
test_client.py:33,45,58 uses random.seed(1)) so results can be verified by
local re-execution (the correctness oracle, reference test_client.py:121-126).

Each entry maps a name to (fn, make_params) where make_params(n_tasks, size)
returns a list of (args_tuple, kwargs_dict) pairs.
"""

from __future__ import annotations

import random
import time
from typing import Callable


def no_op() -> str:
    return "DONE"


def sleep_task(seconds: float) -> float:
    time.sleep(seconds)
    return seconds


def arithmetic(n: int = 10_000) -> int:
    return sum(i * i for i in range(n))


def sort_numbers(xs: list[float]) -> list[float]:
    return sorted(xs)


def sort_strings(xs: list[str]) -> list[str]:
    return sorted(xs)


def reverse_string(s: str) -> str:
    return s[::-1]


def failing_task(msg: str = "boom") -> None:
    raise ValueError(msg)


def straggler_sleep(seconds: float) -> float:
    """sleep_task whose runtime additionally depends on WHICH worker runs
    it: a worker process started with ``TPU_FAAS_EXEC_DELAY_S`` in its
    environment (the pool children inherit it) adds that many seconds to
    every execution. The deterministic sick-worker injector behind bench
    config 18 (tail-hedging) and the speculation-plane tests — the same
    function is fast on a healthy worker and a straggler on the slow one,
    exactly the hedged-request scenario of "The Tail at Scale"."""
    import os

    delay = float(os.environ.get("TPU_FAAS_EXEC_DELAY_S", "0") or 0.0)
    time.sleep(seconds + delay)
    return seconds


def big_result(n_kib: int = 8, seed: int = 0) -> str:
    """Deterministic ``n_kib``-KiB result body — the result-data-plane
    producer (bench map stage): the value itself is what rides the wire,
    so correctness is checkable by re-running with the same args."""
    rng = random.Random(seed)
    return "".join(rng.choices(_ALPHABET, k=n_kib * 1024))


def merge_deps(tag: str = "") -> str:
    """Fan-in consumer for graph tasks: digests its parents' delivered
    result bodies (``dep_values()`` — the result data plane's in-cache
    delivery, or store-read bodies on the control lane) into a short
    summary. Returns ``tag:<n_parents>:<total_chars>`` so tests and the
    bench oracle can assert every parent body actually arrived."""
    from tpu_faas_torch.core.executor import dep_values

    vals = dep_values()
    total = sum(len(v) for v in vals.values() if isinstance(v, str))
    return f"{tag}:{len(vals)}:{total}"


def _params_no_op(n_tasks: int, size: int, rng: random.Random):
    return [((), {}) for _ in range(n_tasks)]


def _params_sleep(n_tasks: int, size: int, rng: random.Random):
    return [((size / 1000.0,), {}) for _ in range(n_tasks)]


def _params_arithmetic(n_tasks: int, size: int, rng: random.Random):
    return [((size,), {}) for _ in range(n_tasks)]


def _params_sort_numbers(n_tasks: int, size: int, rng: random.Random):
    return [(([rng.random() for _ in range(size)],), {}) for _ in range(n_tasks)]


_ALPHABET = "abcdefghijklmnopqrstuvwxyz"


def _params_sort_strings(n_tasks: int, size: int, rng: random.Random):
    return [
        ((["".join(rng.choices(_ALPHABET, k=8)) for _ in range(size)],), {})
        for _ in range(n_tasks)
    ]


def _params_reverse_string(n_tasks: int, size: int, rng: random.Random):
    return [
        (("".join(rng.choices(_ALPHABET, k=size)),), {}) for _ in range(n_tasks)
    ]


WORKLOADS: dict[str, tuple[Callable, Callable]] = {
    "no_op": (no_op, _params_no_op),
    "sleep": (sleep_task, _params_sleep),
    "arithmetic": (arithmetic, _params_arithmetic),
    "sort_numbers": (sort_numbers, _params_sort_numbers),
    "sort_strings": (sort_strings, _params_sort_strings),
    "reverse_string": (reverse_string, _params_reverse_string),
}


def make_workload(
    name: str, n_tasks: int, size: int, seed: int = 1
) -> tuple[Callable, list[tuple[tuple, dict]]]:
    """Return (fn, params_list) for a named workload, deterministically."""
    fn, make_params = WORKLOADS[name]
    rng = random.Random(seed)
    return fn, make_params(n_tasks, size, rng)
