"""How fast a burst of task announces crosses the store bus to one
subscriber.

Writes 20,000 records with ``create_tasks`` on one channel, in batches
of ``--chunk``, through the port's store server (in this process,
or with ``--process`` in a child process of its own), and drains the
announces off one subscription: after each batch, or with ``--late`` only
once every batch is written. Prints how many arrived, when the count
passed each mark, and the total time; gives up after 40 seconds.

    python -m tpu_faas_torch.store.busprobe --late
    python -m tpu_faas_torch.store.busprobe --chunk 1000
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time

from tpu_faas_torch.store.launch import make_store, start_store_thread

MARKS = (1_000, 1_500, 1_600, 2_000, 5_000, 10_000)
TASKS, LIMIT_S = 20_000, 40.0


def probe(url: str, tasks: int, chunk: int, late: bool, limit: float) -> str:
    feeder, watcher = make_store(url), make_store(url)
    sub = watcher.subscribe("busprobe")
    got, marks = 0, []
    t0 = time.perf_counter()

    def drain(goal: int) -> None:
        nonlocal got
        while got < goal and time.perf_counter() - t0 < limit:
            if sub.get_message(timeout=0.005) is None:
                continue
            got += 1
            if got in MARKS or got == tasks:
                marks.append((got, round(time.perf_counter() - t0, 3)))

    try:
        for lo in range(0, tasks, chunk):
            hi = min(lo + chunk, tasks)
            feeder.create_tasks([(f"probe-{i}", "F", "P")
                                 for i in range(lo, hi)], "busprobe")
            if not late:
                drain(hi)
        drain(tasks)
    finally:
        sub.close()
        feeder.close()
        watcher.close()
    took = time.perf_counter() - t0
    return (f"{got} of {tasks} announces in {took:.3f} s, written in "
            f"batches of {chunk} and drained "
            f"{'after the last' if late else 'after each'}; count at "
            f"seconds {marks}")


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--chunk", type=int, default=2_000)
    ap.add_argument("--late", action="store_true")
    ap.add_argument("--process", action="store_true",
                    help="run the store server in a child process")
    ap.add_argument("--port", type=int, default=6411)
    args = ap.parse_args(argv)
    if not args.process:
        handle = start_store_thread()
        try:
            print(probe(handle.url, TASKS, args.chunk, args.late, LIMIT_S),
                  flush=True)
        finally:
            handle.stop()
        return
    url = f"resp://127.0.0.1:{args.port}"
    child = subprocess.Popen(
        [sys.executable, "-m", "tpu_faas_torch.store.server", "--port",
         str(args.port)], stdout=subprocess.DEVNULL)
    try:
        for _ in range(300):  # the child imports, then binds
            try:
                make_store(url).close()
                break
            except OSError:
                time.sleep(0.1)
        print(probe(url, TASKS, args.chunk, args.late, LIMIT_S), flush=True)
    finally:
        child.kill()
        child.wait()


if __name__ == "__main__":
    main()
