"""Run one cell of BENCHMARK.json once and print its result line.

    python3 -m benchmark.run --workload NAME --seed N --seconds S --trace 0|1

Set-up (counted in ``setup_s``, from the process's start): import, bring
up the card, draw the cell's traffic from the seed, build the program's
resident scheduler with its fleet, calls in flight and backlog, and run
one heartbeat period of virtual time, which builds B1 where no build is
cached (``tpu_faas_torch/csrc/build/`` in the checkout) and places the
first wave. Then the window: ticks back to back for ``--seconds`` of wall
time. After it, the program's state is read back and freed, and the
plain reference replays every tick to decide ``correct``.

With ``--trace 0`` the line's metrics are the cell's end-to-end metrics;
with ``--trace 1`` the window runs under ``torch.profiler`` and the
metrics are the cell's per-layer ones, read by ``metrics/<name>.py``.
The compared numbers and their limits close the line (``checks``) and
standard error. Without a CUDA device, or with fewer than the cell asks
for, the run prints no result and exits 3; with JAX loaded once the
window has closed, it names what it found and exits 4.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

import numpy as np  # noqa: E402

from benchmark import judge as judging  # noqa: E402
from benchmark import spec  # noqa: E402
from benchmark import trace as tracing  # noqa: E402
from benchmark.context import Context  # noqa: E402
from benchmark.guard import banned_modules  # noqa: E402
from benchmark.loop import (  # noqa: E402
    Loop, VirtualClock, build_scheduler, make_loop, snapshot)
from benchmark.traffic import Traffic  # noqa: E402

EXIT_NO_CARD, EXIT_JAX = 3, 4


class NoCard(RuntimeError):
    pass


def card(n_chips: int):
    """The first CUDA device, once ``n_chips`` are present and the backend
    answers; a backend that fails to come up is retried once."""
    import torch

    err = ""
    for attempt in range(2):
        try:
            if (torch.cuda.is_available()
                    and torch.cuda.device_count() >= n_chips):
                dev = torch.device("cuda", 0)
                torch.zeros(1, device=dev)
                torch.cuda.synchronize(dev)
                return dev
            err = (f"no CUDA device for this cell: "
                   f"torch.cuda.is_available() = "
                   f"{torch.cuda.is_available()}, device_count() = "
                   f"{torch.cuda.device_count()}, {n_chips} needed")
        except RuntimeError as exc:
            err = f"the CUDA backend failed to come up: {exc}"
        if attempt == 0:
            time.sleep(2.0)
    raise NoCard(err)


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool,
             device, t0: float = _T0) -> dict:
    """One run of ``cell``; returns the result's parts (see main)."""
    import torch

    config = cell.config
    tr = Traffic(config, cell.traffic, seed)
    clock = VirtualClock()
    rs = build_scheduler(config, tr, device, clock)
    loop = make_loop(rs, tr, clock, trace=trace)
    sampled = tr.check_ticks if config["placement"] == "sinkhorn" else ()
    t_built = time.perf_counter()
    for _ in range(max(1, round(config["warmup_s"] / tr.dt))):
        loop.tick(keep_output=loop.k in sampled)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
    t_warm = time.perf_counter()
    # the window starts from a collected heap; the program's state and the
    # harness's traffic stay tracked, as a dispatcher's would
    gc.collect()
    prof = tracing.start(device) if trace else None

    start = time.perf_counter()
    k0 = loop.k
    deadline = start + seconds
    while True:
        loop.tick(keep_output=loop.k in sampled)
        if loop.stamps[-1][3] >= deadline:
            break
    end = loop.stamps[-1][3]

    events = tracing.stop(prof, device) if trace else None
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    window = loop.record[k0:]
    stamps = np.asarray(loop.stamps[k0:])
    final = snapshot(rs)
    dispatches = [e[4] for e in window]
    loop.rs = rs = None
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    verdict = judging.judge(config, tr, loop.record, final, loop.outputs,
                            device=device)
    tick_ms = (stamps[:, 3] - stamps[:, 0]) * 1e3
    return {
        "setup_s": start - t0,
        "setup_split": {"built": t_built - t0, "warm": t_warm - t0},
        "window_s": end - start,
        "placed": Loop.placed_count(window),
        "tick_ms": tick_ms,
        "stamps": stamps,
        "ticks": list(range(k0, loop.k)),
        "dispatches": dispatches,
        "memory_peak_bytes": int(peak),
        "verdict": verdict,
        "events": events,
        "traffic": tr,
        "record": loop.record,
        "final": final,
        "outputs": loop.outputs,
    }


def end_to_end(cell: spec.Cell, r: dict) -> dict:
    values = {
        "placed_per_s": lambda: r["placed"] / r["window_s"],
        "tick_p95_ms": lambda: float(np.percentile(r["tick_ms"], 95)),
        "setup_s": lambda: r["setup_s"],
    }
    return {m["name"]: {"value": values[m["name"]](), "unit": m["unit"]}
            for m in cell.end_to_end}


def per_layer(cell: spec.Cell, r: dict, capture) -> dict:
    ctx = Context(cell.config, r["stamps"], r["ticks"], r["verdict"].work,
                  capture, r["dispatches"])
    out = {}
    for m in cell.per_layer:
        v = spec.metric_reader(m["name"]).read(ctx)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = spec.find_cell(args.workload)
    try:
        dev = card(cell.chips)
    except NoCard as exc:
        print(f"benchmark: {exc}; no result", file=sys.stderr)
        return EXIT_NO_CARD
    import torch

    r = run_cell(cell, args.seed, args.seconds, bool(args.trace), dev)
    v = r["verdict"]
    capture = None
    if args.trace:
        capture = tracing.capture(r["events"], len(r["ticks"]))
        metrics = per_layer(cell, r, capture)
    else:
        metrics = end_to_end(cell, r)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
              "count": cell.chips,
              "memory_peak_bytes": r["memory_peak_bytes"]}
    result = {"correct": v.correct, "attempted": v.ticks,
              "failed": v.failed_ticks, "metrics": metrics,
              "device": device}
    if capture is not None:
        device["busy_s"] = capture.busy_s()
        device["window_s"] = capture.window_s
        result["breakdown"] = {"device_ops": capture.device_ops(),
                               "idle_gaps": capture.idle_gaps()}
    result["checks"] = {name: {"value": v.numbers[name],
                               "limit": v.limits[name]}
                        for name in v.numbers}
    found = banned_modules()
    if found:
        print(f"benchmark: JAX is loaded once the window has closed: "
              f"{', '.join(found)}; no result", file=sys.stderr)
        return EXIT_JAX
    info = {"ticks": len(r["ticks"]), "placed": r["placed"],
            "window_s": r["window_s"], "setup": r["setup_split"],
            "dispatches_max": max(r["dispatches"])}
    print(f"benchmark: {cell.name} seed {args.seed}: {json.dumps(info)}",
          file=sys.stderr)
    for note in v.notes:
        print(f"benchmark: {note}", file=sys.stderr)
    for name in v.numbers:
        print(f"check {name}: {v.numbers[name]} (limit {v.limits[name]})",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
