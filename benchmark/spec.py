"""Where the harness finds a cell's parts: by the names in BENCHMARK.json.

A configuration is ``configs/<config>.json``, a traffic mix
``traffic/<traffic>.json`` and a per-layer metric ``metrics/<name>.py``
(a metric's name may hold dots: the file is loaded by its path). A later
cell, mix or metric is new files and a new entry in BENCHMARK.json; no
file here needs an edit for it.
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
