"""Where the harness finds a cell's parts: by the names in BENCHMARK.json.

A configuration is ``configs/<config>.json``, a traffic mix
``traffic/<traffic>.json`` and a per-layer metric ``metrics/<name>.py``
(a metric's name may hold dots: the file is loaded by its path). A later
cell, mix or metric is new files and a new entry in BENCHMARK.json; no
file here needs an edit for it.

A configuration states its fleet, tables and clock (``max_workers``,
``max_pending``, ``max_inflight``, ``max_slots``, ``time_to_expire_s``,
``heartbeat_period_s``, ``tick_period_s``, ``worker_speed_range``,
``worker_procs_range``, ``inactive_share``, ``pending_headroom``,
``warmup_s``) and the scheduler's ``placement``: ``"rank"`` (rank
matching, the dispatcher's default), ``"auction"`` or ``"sinkhorn"``. It
may add a ``churn`` block, where workers fail and return:

- ``fail_per_s``: the share of the live workers that fail in each virtual
  second (each fails in a tick with the probability that gives it);
- ``down_s``: the virtual seconds a failed worker stays away before it
  registers again under its own id, with its processes and speed. It has
  to be above ``time_to_expire_s``, or the dispatcher would never see the
  failure (a file below it is refused).

With ``churn`` the loop drives the scheduler as the dispatcher does under
failures (``loop.ChurnLoop``) and the judge holds its liveness, purges,
redispatches and registrations to the reference; without it a cell runs
as it always did.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as fh:
        return json.load(fh)


def _read_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def applies(metric: dict, workload: str) -> bool:
    """A metric with a ``workloads`` list is the listed cells' alone."""
    return "workloads" not in metric or workload in metric["workloads"]


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    end_to_end: list[dict]
    per_layer: list[dict]
    chips: int


def find_cell(name: str, bench: dict | None = None,
              here: Path = HERE) -> Cell:
    """The cell ``name`` with its configuration and traffic loaded from
    their files, and the metrics that apply to it."""
    bench = load_benchmark() if bench is None else bench
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(there are {sorted(cells)})")
    w = cells[name]
    return Cell(
        name=name,
        config=_read_json(here / "configs" / f"{w['config']}.json"),
        traffic=_read_json(here / "traffic" / f"{w['traffic']}.json"),
        end_to_end=[m for m in bench["end_to_end"] if applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if applies(m, name)],
        chips=int(w["chips"]),
    )


def metric_reader(name: str, here: Path = HERE):
    """The module ``metrics/<name>.py``; its ``read(ctx)`` returns the
    metric's value or None where it finds nothing to read."""
    path = here / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark.metrics." + name.replace(".", "_"), path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
